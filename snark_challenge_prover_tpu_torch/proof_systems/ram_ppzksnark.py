"""The RAM ppzkSNARK: prove that a TinyRAM program accepts a public tape
within T steps.

Counterpart of the JAX package's ``proof_systems/ram_ppzksnark.py``
(libsnark ram_ppzksnark.{hpp,tcc}): the RAM -> R1CS reduction
(``reductions.ram_to_r1cs``) composed with PGHR13 (``proof_systems.pghr13``,
libsnark's r1cs_ppzksnark), whose key generation and prove run on the
model's device.  The key pair binds the machine, the program and the time
bound; the primary input is the tape.

The circuit is over MNT4753's Fr (``ram_to_r1cs._field_p``), so the
generator refuses a model whose scalar field is another prime.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..reductions.ram_to_r1cs import _field_p, ram_to_r1cs, ram_witness_map
from ..relations.tinyram import TinyRAMProgram
from ..utils.profiling import Profiler
from . import pghr13


@dataclass
class RamKeypair:
    pk: pghr13.ProvingKey
    vk: pghr13.VerificationKey
    program: TinyRAMProgram
    tape_len: int
    T: int
    # the circuit (protoboard, handles), which the prover fills again
    _handles: tuple = field(default=None, repr=False, compare=False)


def generator(model, program: TinyRAMProgram, tape_len: int, T: int, rng,
              profiler: Profiler | None = None) -> RamKeypair:
    """ram_ppzksnark_generator (tcc:60-90): the circuit once ("ram to
    r1cs"), then ``pghr13.generator`` on its constraint system, drawing
    from ``rng`` as the JAX package does.  Raises ValueError unless the
    model's Fr is the circuit's field."""
    if model.Fr.p != _field_p():
        raise ValueError(f"the RAM circuit is over MNT4753's Fr; {model.name}'s Fr is another "
                         "prime")
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    prof.enter_block("ram to r1cs")
    pb, handles = ram_to_r1cs(program, tape_len, T)
    cs = pb.get_constraint_system()
    prof.leave_block("ram to r1cs")
    kp = pghr13.generator(model, cs, rng, prof)
    return RamKeypair(pk=kp.pk, vk=kp.vk, program=program, tape_len=tape_len, T=T,
                      _handles=(pb, handles))


def prover(model, kp: RamKeypair, tape, rng, profiler: Profiler | None = None) -> pghr13.Proof:
    """ram_ppzksnark_prover (tcc:92-120): the witness from the simulated
    execution ("ram witness map"; a tape the program does not accept within
    T steps raises ValueError), then ``pghr13.prover``."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    pb, handles = kp._handles
    prof.enter_block("ram witness map")
    _, primary, aux = ram_witness_map(pb, handles, kp.program, tape)
    prof.leave_block("ram witness map")
    return pghr13.prover(model, kp.pk, primary, aux, rng, prof)


def verifier(model, kp: RamKeypair, tape, proof: pghr13.Proof) -> bool:
    """ram_ppzksnark_verifier (tcc:122-140): the tape is the primary input."""
    return pghr13.verifier_strong_IC(kp.vk, list(tape), proof)
