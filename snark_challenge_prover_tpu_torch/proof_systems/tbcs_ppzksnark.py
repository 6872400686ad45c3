"""TBCS ppzkSNARK: the proof system for two-input boolean circuits.

Counterpart of the JAX package's ``proof_systems/tbcs_ppzksnark.py``
(libsnark tbcs_ppzksnark.{hpp,tcc}): the circuit is lowered by
``reductions.tbcs_to_uscs`` and the USCS ppzkSNARK does the rest; the
proving key keeps the circuit, from which the prover computes the wires.
Primary inputs are bits; they enter the USCS verifier as 0 or 1.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..reductions import tbcs_to_uscs
from ..relations.tbcs import TBCSCircuit
from ..utils.profiling import Profiler
from . import uscs_ppzksnark as uscs

Proof = uscs.Proof
VerificationKey = uscs.VerificationKey


@dataclass
class ProvingKey:
    """tbcs_ppzksnark_proving_key: the circuit and the USCS key."""

    circuit: TBCSCircuit
    uscs_pk: uscs.ProvingKey


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def generator(model, circuit: TBCSCircuit, rng, profiler: Profiler | None = None) -> Keypair:
    """tbcs_ppzksnark_generator: the USCS generator on the lowered circuit."""
    kp = uscs.generator(model, tbcs_to_uscs.instance_map(circuit, model.Fr.p), rng, profiler)
    return Keypair(ProvingKey(circuit=circuit, uscs_pk=kp.pk), kp.vk)


def prover(model, pk: ProvingKey, primary, auxiliary, rng,
           profiler: Profiler | None = None) -> Proof:
    """tbcs_ppzksnark_prover: the wires as 0/1, the primary bits first, to
    the USCS prover."""
    wires = tbcs_to_uscs.witness_map(pk.circuit, primary, auxiliary)
    return uscs.prover(model, pk.uscs_pk, wires[: len(primary)], wires[len(primary):], rng,
                       profiler)


def _field_primary(primary) -> list:
    return [1 if b else 0 for b in primary]


verifier_process_vk = uscs.verifier_process_vk


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return uscs.online_verifier_weak_IC(vk, _field_primary(primary), proof)


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return uscs.online_verifier_strong_IC(vk, _field_primary(primary), proof)


def verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return uscs.verifier_weak_IC(vk, _field_primary(primary), proof)


def verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return uscs.verifier_strong_IC(vk, _field_primary(primary), proof)
