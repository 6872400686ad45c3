"""BACS ppzkSNARK: the proof system for bilinear arithmetic circuits.

Counterpart of the JAX package's ``proof_systems/bacs_ppzksnark.py``
(libsnark bacs_ppzksnark.{hpp,tcc}): the circuit is lowered by
``reductions.bacs_to_r1cs`` and the PGHR13 R1CS ppzkSNARK does the rest
(tcc:56-57, 72-74); the proving key keeps the circuit, from which the prover
computes the wires.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..reductions import bacs_to_r1cs
from ..relations.bacs import BACSCircuit
from . import pghr13

Proof = pghr13.Proof
VerificationKey = pghr13.VerificationKey


@dataclass
class ProvingKey:
    """bacs_ppzksnark_proving_key (hpp:68-118): the circuit and the R1CS key."""

    circuit: BACSCircuit
    r1cs_pk: pghr13.ProvingKey


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def generator(model, circuit: BACSCircuit, rng) -> Keypair:
    """bacs_ppzksnark_generator (tcc:52-64)."""
    kp = pghr13.generator(model, bacs_to_r1cs.instance_map(circuit), rng)
    return Keypair(ProvingKey(circuit=circuit, r1cs_pk=kp.pk), kp.vk)


def prover(model, pk: ProvingKey, primary, auxiliary, rng) -> Proof:
    """bacs_ppzksnark_prover (tcc:67-79): the wires after the primary input
    are the R1CS's auxiliary input."""
    wires = bacs_to_r1cs.witness_map(pk.circuit, primary, auxiliary)
    return pghr13.prover(model, pk.r1cs_pk, primary, wires[len(primary):], rng)


verifier_process_vk = pghr13.verifier_process_vk
online_verifier_weak_IC = pghr13.online_verifier_weak_IC
online_verifier_strong_IC = pghr13.online_verifier_strong_IC
verifier_weak_IC = pghr13.verifier_weak_IC
verifier_strong_IC = pghr13.verifier_strong_IC
