"""The port's TinyRAM relation, protoboard, routing gadgets and RAM -> R1CS
reduction against the JAX package's, on the host; the RAM ppzkSNARK's
generator on a curve whose Fr is not the circuit's field.

  * ``simulate`` gives the JAX package's answer and trace on the JAX test
    programs (tests/test_tinyram.py), and instructions encode alike;
  * the Benes and AS-Waksman gadgets give the JAX package's constraints,
    term for term, and its witness for seeded permutations, at sizes that
    are powers of two and sizes that are not;
  * ``ram_to_r1cs`` gives the JAX package's constraint system, constraint
    for constraint and term for term, and ``ram_witness_map`` its primary
    and auxiliary inputs, for the JAX ``_sum_program`` at w = 8, k = 4,
    T = 8 and at w = 16, k = 16, T = 16; tampering and a rejecting tape fail
    as there.  The terms of each combination are compared as a sorted list:
    the JAX reduction sums two of them over sets of opcode names (BITWISE,
    FLAG_SETTERS), whose order follows the interpreter's string hashes and
    so changes from process to process; the port sums them in a fixed order;
  * ``ram_ppzksnark.generator`` raises on MNT6753.

A round trip of ``ram_ppzksnark`` on the CPU does not fit this file's
minute: the smallest circuit here has 1191 constraints, a QAP domain of
2048, and a PGHR13 key generation and prove in plain PyTorch at d + 1 = 8
already take about a minute.  ``chip_smoke.py``'s ``ram`` phase is its round
trip, on the card, at a QAP domain of 2^16."""

import itertools
import random

import pytest

from snark_challenge_prover_tpu.gadgets import protoboard as jax_pb
from snark_challenge_prover_tpu.gadgets import routing as jax_routing
from snark_challenge_prover_tpu.reductions import ram_to_r1cs as jax_ram
from snark_challenge_prover_tpu.relations import tinyram as jax_tinyram
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.gadgets import protoboard as port_pb
from snark_challenge_prover_tpu_torch.gadgets import routing as port_routing
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import ram_ppzksnark
from snark_challenge_prover_tpu_torch.reductions import ram_to_r1cs as port_ram
from snark_challenge_prover_tpu_torch.relations import tinyram as port_tinyram
from test_tinyram import _sum_program

P = mnt4753.get("cpu").Fr.p


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def jax_programs():
    """name -> (JAX program, tape): the programs of tests/test_tinyram.py."""
    ap = jax_tinyram.TinyRAMArchParams(w=8, k=4)
    arith = jax_tinyram.TinyRAMProgram(ap, [])
    arith.add("mov", des=0, arg2=200).add("mov", des=1, arg2=100)
    arith.add("add", des=2, arg1=0, arg2=1, imm=False).add("answer", arg2=0)
    carry = jax_tinyram.TinyRAMProgram(ap, list(arith.instructions[:3]))
    carry.add("cjmp", arg2=5).add("answer", arg2=0)
    isa = jax_tinyram.TinyRAMProgram(ap, [])
    isa.add("mov", des=0, arg2=0b1100).add("mov", des=1, arg2=0b1010)
    for op in ("and", "or", "xor"):
        isa.add(op, des=2, arg1=0, arg2=1, imm=False)
    isa.add("not", des=2, arg2=1, imm=False)
    for op in ("sub", "mull", "umulh", "smulh", "udiv", "umod"):
        isa.add(op, des=2, arg1=0, arg2=1, imm=False)
    isa.add("shl", des=2, arg1=0, arg2=2).add("shr", des=2, arg1=0, arg2=1)
    for op in ("cmpe", "cmpg", "cmpge"):
        isa.add(op, arg1=0, arg2=1, imm=False)
    isa.add("storew", arg1=0, arg2=7).add("loadw", des=3, arg2=7)
    isa.add("storeb", arg1=0, arg2=9).add("loadb", des=3, arg2=9).add("answer", arg2=0)
    read = jax_tinyram.TinyRAMProgram(ap, [])
    read.add("read", des=0, arg2=0).add("read", des=1, arg2=0)
    read.add("add", des=2, arg1=0, arg2=1, imm=False).add("answer", arg2=0)
    return {"arith": (arith, []), "carry jump off the program": (carry, []),
            "full ISA": (isa, []), "read tape": (read, [7, 8]), "read past the tape": (read, [7]),
            "sum via memory": (_sum_program(), [7, 8]),
            "sum via memory, wrong tape": (_sum_program(), [7, 9])}


@pytest.mark.parametrize("name", list(jax_programs()))
def test_simulate_equals_jax(name):
    jprog, tape = jax_programs()[name]
    prog = convert.tinyram_program_from_reference(jprog)
    boot = {i: v for i, v in enumerate(tape)}
    for kwargs in ({}, {"init_mem": boot, "max_steps": 8}):
        jok, jans, jtrace = jax_tinyram.simulate(jprog, tape, **kwargs)
        ok, ans, trace = port_tinyram.simulate(prog, tape, **kwargs)
        assert (ok, ans) == (jok, jans)
        assert [vars(s) for s in trace] == [vars(s) for s in jtrace]
        if name == "full ISA" and not kwargs:  # loadb got the stored byte
            assert ok and trace[-1].regs[3] == 0b1100


def test_instruction_encoding_equals_jax():
    rng = random.Random(3)
    for w, k in ((8, 4), (16, 16), (32, 8)):
        jap, ap = jax_tinyram.TinyRAMArchParams(w, k), port_tinyram.TinyRAMArchParams(w, k)
        for op in port_tinyram.OPCODES:
            args = (rng.randrange(k), rng.randrange(k), rng.randrange(1 << w), rng.randrange(2) == 1)
            assert port_tinyram.Instruction(op, *args).encode(ap) == \
                jax_tinyram.Instruction(op, *args).encode(jap)
    assert port_tinyram.OPCODES == jax_tinyram.OPCODES


# ---------------------------------------------------------------------------
# the routing gadgets
# ---------------------------------------------------------------------------

def _terms(constraints, order=list):
    return [(order(c.a.terms), order(c.b.terms), order(c.c.terms), c.is_square)
            for c in constraints]


def routed(pb_mod, routing_mod, cls: str, values, sigma):
    """A protoboard with the packets ``values`` as variables, routed by
    ``sigma`` through the gadget ``cls``: (protoboard, gadget)."""
    pb = pb_mod.Protoboard(P)
    ins = []
    for packet in values:
        vs = [pb.allocate_var() for _ in packet]
        for v, x in zip(vs, packet):
            pb.set_val(v, x)
        ins.append(vs)
    g = getattr(routing_mod, cls)(pb, ins)
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness(sigma)
    return pb, g


@pytest.mark.parametrize("cls,n", [("BenesRoutingGadget", n) for n in (2, 4, 8, 16)]
                         + [("ASWaksmanRoutingGadget", n) for n in (2, 3, 5, 6, 7, 8, 13, 16, 21)])
def test_routing_gadget_equals_jax(cls, n):
    """Constraints term for term and the whole assignment, for seeded
    permutations (every one at n <= 3) of two-line packets."""
    perms = itertools.permutations(range(n)) if n <= 3 else \
        (random.Random(s).sample(range(n), n) for s in range(4))
    rng = random.Random(n)
    for sigma in perms:
        values = [[rng.randrange(P) for _ in range(2)] for _ in range(n)]
        jpb, jg = routed(jax_pb, jax_routing, cls, values, list(sigma))
        pb, g = routed(port_pb, port_routing, cls, values, list(sigma))
        assert _terms(pb.constraints) == _terms(jpb.constraints)
        assert pb._values == jpb._values and pb.is_satisfied()
        assert [[pb.val(v) for v in out] for out in g.outputs] == [values[j] for j in sigma]


def test_benes_refuses_other_sizes_as_jax():
    for mod, rmod in ((jax_pb, jax_routing), (port_pb, port_routing)):
        pb = mod.Protoboard(P)
        with pytest.raises(ValueError):
            rmod.BenesRoutingGadget(pb, [[pb.allocate_var()] for _ in range(3)])


# ---------------------------------------------------------------------------
# the RAM -> R1CS reduction
# ---------------------------------------------------------------------------

def sum_programs(w: int, k: int):
    """The JAX ``_sum_program`` on a (w, k) machine, in both packages."""
    jprog = _sum_program()
    jprog = jax_tinyram.TinyRAMProgram(jax_tinyram.TinyRAMArchParams(w, k),
                                       list(jprog.instructions))
    return jprog, convert.tinyram_program_from_reference(jprog)


@pytest.mark.parametrize("w,k,T", [(8, 4, 8), (16, 16, 16)])
def test_ram_to_r1cs_equals_jax(w, k, T):
    jprog, prog = sum_programs(w, k)
    jpb, jh = jax_ram.ram_to_r1cs(jprog, 2, T)
    pb, h = port_ram.ram_to_r1cs(prog, 2, T)
    cs, jcs = pb.get_constraint_system(), jpb.get_constraint_system()
    assert cs.p == jcs.p == P
    assert _terms(cs.constraints, sorted) == _terms(jcs.constraints, sorted)
    assert (cs.primary_input_size, cs.auxiliary_input_size) == (jcs.primary_input_size,
                                                                jcs.auxiliary_input_size)
    got = port_ram.ram_witness_map(pb, h, prog, [7, 8])
    assert got == jax_ram.ram_witness_map(jpb, jh, jprog, [7, 8])
    assert got[0] and got[1] == [7, 8] and pb.is_satisfied()
    with pytest.raises(ValueError):  # the sum is not 15: the program rejects
        port_ram.ram_witness_map(pb, h, prog, [7, 9])
    # a mid-trace register nudged breaks the circuit, as in the JAX tests
    port_ram.ram_witness_map(pb, h, prog, [7, 8])
    var = h["regs"][3][2]
    pb.set_val(var, pb.val(var) + 1)
    assert not pb.is_satisfied()


def test_unsupported_opcode_raises_as_jax():
    for mod, tm in ((jax_ram, jax_tinyram), (port_ram, port_tinyram)):
        prog = tm.TinyRAMProgram(tm.TinyRAMArchParams(w=8, k=4), [])
        prog.add("mull", des=0, arg1=0, arg2=1).add("answer", arg2=0)
        with pytest.raises(NotImplementedError):
            mod.ram_to_r1cs(prog, tape_len=0, T=2)
    assert port_ram.CIRCUIT_OPS == jax_ram.CIRCUIT_OPS


def test_generator_raises_on_mnt6753():
    """The circuit is over MNT4753's Fr; MNT6753's Fr is MNT4753's Fq."""
    _, prog = sum_programs(8, 4)
    assert port_ram._field_p() == P != mnt6753.get("cpu").Fr.p
    with pytest.raises(ValueError, match="MNT4753's Fr"):
        ram_ppzksnark.generator(mnt6753.get("cpu"), prog, 2, 8, random.Random(1))
