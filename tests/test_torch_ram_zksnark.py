"""The port's RAM zkSNARK (``proof_systems/ram_zksnark.py``) against the JAX
package's, on the host (fill only: a key pair and the step proofs are the
smoke's ``ram_zksnark`` phase on the card).

  * the one-step compliance predicate, built by both packages, is equal
    constraint for constraint on the JAX package's test machine (w = 8,
    k = 3, memory depth 2) and on the smoke's machine (w = 16, k = 16,
    depth 5, ``chip_smoke.ram_program`` with 2 tape words): each
    constraint's terms compared as sorted lists (the JAX package sums two
    combinations over sets of opcode names, whose order follows the
    interpreter's string hashes), every annotation, the predicate's fields;
  * ``merkle_mem_root``, ``merkle_mem_path`` and ``base_case_state`` equal;
  * the witness map, chained state for state up to acceptance, gives the
    JAX package's states and wire values;
  * a tampered incoming root raises in both packages;
  * the reference's prover hands each step's PCD prove an empty witness:
    the JAX ``PCDStepCircuit`` raises on it, while the witness the port's
    ``prover`` hands over fills the port's step circuit, satisfied at every
    step;
  * ``generator`` raises ValueError at arity 1."""

import random

import pytest
import torch

import chip_smoke
from snark_challenge_prover_tpu.proof_systems import pcd as jax_pcd
from snark_challenge_prover_tpu.proof_systems import ram_zksnark as jax_rz
from snark_challenge_prover_tpu.relations import tinyram as jax_tinyram
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.proof_systems import pcd
from snark_challenge_prover_tpu_torch.proof_systems import ram_zksnark as rz
from snark_challenge_prover_tpu_torch.relations import tinyram

torch.set_num_threads(1)

P = host_curve("MNT6753").fq_spec.p  # the field of MNT4753 step circuits


def memory_program(mod):
    """The JAX package's tests/test_ram_zksnark.py program: mem[2] = 5;
    r1 = mem[2]; answer r1 - 5."""
    p = mod.TinyRAMProgram(mod.TinyRAMArchParams(w=8, k=3), [])
    p.add("mov", des=0, arg2=5)
    p.add("storew", arg1=0, arg2=2)
    p.add("loadw", des=1, arg2=2)
    p.add("sub", des=2, arg1=1, arg2=5)
    p.add("answer", arg1=0, arg2=2, imm=False)
    return p


def machines():
    """name -> (JAX program, port program, tape, memory depth)."""
    prog, tape = chip_smoke.ram_program(1, tape_words=2)
    jax_prog = jax_tinyram.TinyRAMProgram(
        jax_tinyram.TinyRAMArchParams(prog.ap.w, prog.ap.k),
        [jax_tinyram.Instruction(i.op, i.des, i.arg1, i.arg2, i.arg2_is_imm)
         for i in prog.instructions])
    return {"jax test (w 8, k 3, depth 2)": (memory_program(jax_tinyram),
                                             memory_program(tinyram), [], 2),
            "smoke (w 16, k 16, depth 5)": (jax_prog, prog, tape, 5)}


@pytest.fixture(scope="module", params=list(machines()))
def handlers(request):
    jax_prog, prog, tape, depth = machines()[request.param]
    assert convert.tinyram_program_from_reference(jax_prog) == prog
    return (jax_rz.RamCompliancePredicateHandler(jax_prog, depth, P),
            rz.RamCompliancePredicateHandler(prog, depth, P), tape)


def sorted_terms(constraints):
    return [tuple(sorted(lc.terms) for lc in (c.a, c.b, c.c)) for c in constraints]


def test_predicate_equals_jax(handlers):
    jh, h, _ = handlers
    want, got = jh.get_compliance_predicate(), h.get_compliance_predicate()
    assert {**vars(got), "constraint_system": None} == {**vars(want), "constraint_system": None}
    cs, want_cs = got.constraint_system, want.constraint_system
    assert (cs.p, cs.primary_input_size, cs.auxiliary_input_size) == (
        want_cs.p, want_cs.primary_input_size, want_cs.auxiliary_input_size)
    assert sorted_terms(cs.constraints) == sorted_terms(want_cs.constraints)
    assert h.pb.annotations == jh.pb.annotations
    assert got.witness_length == h.pb.num_variables - h.prefix_length > 0


def test_memory_tree_and_base_case_equal_jax(handlers):
    jh, h, tape = handlers
    rng = random.Random(4)
    mem = {a: rng.randrange(1 << h.w) for a in rng.sample(range(1 << h.addr_depth), 3)}
    assert rz.merkle_mem_root(P, mem, h.addr_depth) == jax_rz.merkle_mem_root(P, mem, h.addr_depth)
    for addr in range(1 << h.addr_depth):
        assert (rz.merkle_mem_path(P, mem, h.addr_depth, addr)
                == jax_rz.merkle_mem_path(P, mem, h.addr_depth, addr))
    assert vars(rz.base_case_state(h, tape)) == vars(jax_rz.base_case_state(jh, tape))


def test_witness_map_chain_equals_jax(handlers):
    """Step by step to acceptance: equal states and wire values; the roots
    chain, the timestamps count."""
    jh, h, tape = handlers
    jmem, mem = dict(enumerate(tape)), dict(enumerate(tape))
    jstate, state = jax_rz.base_case_state(jh, tape), rz.base_case_state(h, tape)
    steps = 0
    while not state.has_accepted:
        prev = state
        jstate, state = jh.witness_map(jstate, jmem, 0), h.witness_map(state, mem, 0)
        steps += 1
        assert vars(state) == vars(jstate) and mem == jmem
        assert h.pb._values == jh.pb._values
        assert state.timestamp == prev.timestamp + 1
        assert state.root == rz.merkle_mem_root(P, mem, h.addr_depth)
        assert steps < 64
    assert steps == len(tinyram.simulate(h.program, tape, init_mem=dict(enumerate(tape)))[2])


def test_tampered_root_raises_in_both(handlers):
    """A step whose incoming root is not memory's: the JAX witness map
    asserts, the port's raises ValueError (the memory-authentication
    constraint is unsatisfied for a memory operation, the root update for
    any other step)."""
    jh, h, tape = handlers
    for handler, mod, err in ((jh, jax_rz, AssertionError), (h, rz, ValueError)):
        mem = dict(enumerate(tape))
        state = mod.base_case_state(handler, tape)
        bad = mod.RamState(timestamp=state.timestamp, pc=state.pc, flag=state.flag,
                           regs=state.regs, root=(state.root + 1) % P,
                           has_accepted=state.has_accepted)
        with pytest.raises(err):
            handler.witness_map(bad, mem, want_halt=0)


class FillOnly:
    """Stands for ``SPPCDProver`` in ``ram_zksnark.prover``: each step's
    ``prove`` only fills the step circuit with what it is handed."""

    def prove(self, kp, outgoing, incoming, local_data, witness, rng, profiler=None):
        return kp.circuit.fill(outgoing, incoming, local_data, witness)


def test_prover_witness_fills_every_step_where_the_reference_raises(handlers):
    jh, h, tape = handlers
    # the reference: its prover's empty witness at step 0
    jpred = jh.get_compliance_predicate()
    jcirc = jax_pcd.PCDStepCircuit("MNT4753", jpred, None, 0)
    start = jax_rz.base_case_state(jh, tape)
    out = jh.witness_map(start, dict(enumerate(tape)), want_halt=0)
    with pytest.raises(AssertionError):
        jcirc.fill(jax_pcd.R1CSPCDMessage(1, out.payload()),
                   [jax_pcd.R1CSPCDMessage(1, start.payload())], jax_pcd.R1CSPCDLocalData([0]), [])
    # the port's prover
    pred = h.get_compliance_predicate()
    kp = rz.RamZKKeypair(pcd_kp=pcd.SPPCDKeypair(pk=None, vk=None, predicate=pred,
                                                 circuit=pcd.PCDStepCircuit("MNT4753", pred)),
                         handler=h, program=h.program, addr_depth=h.addr_depth, pcd=FillOnly())
    T = len(tinyram.simulate(h.program, tape, init_mem=dict(enumerate(tape)))[2])
    seen = []
    final, last = rz.prover(kp, tape, T, random.Random(0),
                            on_step=lambda k, s_in, s_out, ok: seen.append((k, s_out.timestamp, ok)))
    assert seen == [(k, k + 1, True) for k in range(T)]
    assert last is True and final.has_accepted == 1 and final.timestamp == T


def test_generator_refuses_arity_one():
    with pytest.raises(ValueError, match="arity"):
        rz.generator(memory_program(tinyram), 2, random.Random(0), arity=1, device="cpu")
