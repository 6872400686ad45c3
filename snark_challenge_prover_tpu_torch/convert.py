"""State carried across the two packages.

The JAX package's readers return 16-bit limb planes (``uint32[48, N]``,
``(deg, 48, N)`` for G2 coordinates); the port works on 32-bit words
(``int32[24, N]``).  Both are the same little-endian bytes, so the
conversion is a regrouping and is exact in both directions.  Constraint
systems, keys and proofs carry over with the same terms and points.
"""

from __future__ import annotations

import numpy as np
import torch

from .io.serialization import Groth16Input, Groth16Params
from .ops.limbs import planes16_to_words, to_planes16
from .proof_systems import adsnark, bacs_ppzksnark, gm17, pghr13, tbcs_ppzksnark, uscs_ppzksnark
from .proof_systems.groth16_full import Proof, ProvingKey, VerificationKey
from .proof_systems.pcd import CompliancePredicate, R1CSPCDLocalData, R1CSPCDMessage
from .relations.bacs import BACSCircuit, BACSGate
from .relations.r1cs import LinearCombination, R1CSConstraint, R1CSConstraintSystem
from .relations.tbcs import TBCSCircuit, TBCSGate
from .relations.tinyram import Instruction, TinyRAMArchParams, TinyRAMProgram
from .relations.uscs import USCSConstraintSystem


def _words(planes) -> np.ndarray:
    """Limb planes ((48, N) under any component axes) -> word arrays."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        return planes16_to_words(planes)
    return np.stack([_words(c) for c in planes])


def params_from_reference(ref) -> Groth16Params:
    """The JAX package's ``Groth16Params`` (limb planes) -> the port's (host
    word arrays; ``prove_arrays`` uploads them to the model's device)."""
    pair = lambda xy: (_words(xy[0]), _words(xy[1]))
    return Groth16Params(int(ref.d), int(ref.m), pair(ref.A), pair(ref.B1), pair(ref.B2),
                         pair(ref.L), pair(ref.H))


def input_from_reference(ref) -> Groth16Input:
    """The JAX package's ``Groth16Input`` (limb planes) -> the port's."""
    return Groth16Input(*(_words(getattr(ref, k)) for k in ("w", "ca", "cb", "cc", "r")))


def tensor_from_planes(planes, device) -> torch.Tensor:
    """Limb planes ((48, N), (deg, 48, N), or (2, deg, 48, N) for the JAX
    package's Fq4 / Fq6) -> the port's tensor on ``device``."""
    return torch.from_numpy(_words(planes)).to(device)


def planes_from_port(x: torch.Tensor) -> np.ndarray:
    """The port's tensor ((24, ...) under any component axes, an Fq4 / Fq6
    element's two) -> 16-bit limb planes."""
    if x.shape[0] == 24:
        return to_planes16(x)
    return np.stack([planes_from_port(c) for c in x])


def r1cs_from_reference(ref) -> R1CSConstraintSystem:
    """The JAX package's constraint system -> the port's (the same terms)."""
    cs = R1CSConstraintSystem(ref.p, ref.primary_input_size, ref.auxiliary_input_size)
    for c in ref.constraints:
        cs.add_constraint(R1CSConstraint(LinearCombination(c.a.terms), LinearCombination(c.b.terms),
                                         LinearCombination(c.c.terms), c.is_square))
    return cs


def _pair(xy, device):
    """An affine (x, y) pair of limb planes -> the port's word tensors."""
    return tensor_from_planes(xy[0], device), tensor_from_planes(xy[1], device)


def proving_key_from_jax(ref, device) -> ProvingKey:
    """The JAX package's ``ProvingKey`` (queries as affine 16-bit limb
    planes, the identity stored as (0, 0)) -> the port's, its queries as
    word tensors on ``device``; the single points are host integers in both."""
    pair = lambda xy: _pair(xy, device)
    return ProvingKey(
        curve=ref.curve, alpha_g1=ref.alpha_g1, beta_g1=ref.beta_g1, beta_g2=ref.beta_g2,
        delta_g1=ref.delta_g1, delta_g2=ref.delta_g2, A_query=pair(ref.A_query),
        B_query_g2=pair(ref.B_query_g2), B_query_g1=pair(ref.B_query_g1),
        H_query=pair(ref.H_query), L_query=pair(ref.L_query),
        constraint_system=r1cs_from_reference(ref.constraint_system))


def verification_key_from_jax(ref) -> VerificationKey:
    """The JAX package's ``VerificationKey`` -> the port's: both hold host
    integers (the GT element as a pair of component tuples), so this copies."""
    return VerificationKey(curve=ref.curve, alpha_g1_beta_g2=ref.alpha_g1_beta_g2,
                           delta_g2=ref.delta_g2, ABC_g1=list(ref.ABC_g1))


def proof_from_jax(ref) -> Proof:
    """The JAX package's ``Proof`` -> the port's (host affine integers in both)."""
    return Proof(g_A=ref.g_A, g_B=ref.g_B, g_C=ref.g_C)


def gm17_proving_key_from_jax(ref, device) -> gm17.ProvingKey:
    """The JAX package's GM17 ``ProvingKey`` -> the port's, its queries as
    word tensors on ``device``; the single points are host integers in both."""
    queries = {k: _pair(getattr(ref, k), device)
               for k in ("A_query", "B_query", "C_query_1", "C_query_2", "G_gamma2_Z_t")}
    singles = {k: getattr(ref, k) for k in ("G_gamma_Z", "H_gamma_Z", "G_ab_gamma_Z",
                                             "G_gamma2_Z2")}
    return gm17.ProvingKey(curve=ref.curve, **queries, **singles,
                           constraint_system=r1cs_from_reference(ref.constraint_system))


def gm17_verification_key_from_jax(ref) -> gm17.VerificationKey:
    """Host integers in both packages: a copy."""
    return gm17.VerificationKey(curve=ref.curve, H=ref.H, G_alpha=ref.G_alpha, H_beta=ref.H_beta,
                                G_gamma=ref.G_gamma, H_gamma=ref.H_gamma, query=list(ref.query))


def gm17_proof_from_jax(ref) -> gm17.Proof:
    return gm17.Proof(A=ref.A, B=ref.B, C=ref.C)


def pghr13_proving_key_from_jax(ref, device) -> pghr13.ProvingKey:
    """The JAX package's PGHR13 ``ProvingKey`` -> the port's, its queries as
    word tensors on ``device``."""
    queries = {k: _pair(getattr(ref, k), device)
               for k in ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g",
                         "C_query_h", "H_query", "K_query")}
    return pghr13.ProvingKey(curve=ref.curve, **queries,
                             constraint_system=r1cs_from_reference(ref.constraint_system))


def pghr13_verification_key_from_jax(ref) -> pghr13.VerificationKey:
    """Host integers in both packages: a copy."""
    return pghr13.VerificationKey(
        curve=ref.curve, alphaA_g2=ref.alphaA_g2, alphaB_g1=ref.alphaB_g1,
        alphaC_g2=ref.alphaC_g2, gamma_g2=ref.gamma_g2, gamma_beta_g1=ref.gamma_beta_g1,
        gamma_beta_g2=ref.gamma_beta_g2, rC_Z_g2=ref.rC_Z_g2,
        encoded_IC_base=ref.encoded_IC_base, encoded_IC_values=list(ref.encoded_IC_values))


def pghr13_proof_from_jax(ref) -> pghr13.Proof:
    return pghr13.Proof(g_A=ref.g_A, g_B=ref.g_B, g_C=ref.g_C, g_H=ref.g_H, g_K=ref.g_K)


def bacs_circuit_from_reference(ref) -> BACSCircuit:
    """The JAX package's BACS circuit -> the port's (the same gates and terms)."""
    circuit = BACSCircuit(ref.p, ref.primary_input_size, ref.auxiliary_input_size)
    for g in ref.gates:
        circuit.add_gate(BACSGate(LinearCombination(g.lhs.terms), LinearCombination(g.rhs.terms),
                                  g.output, g.is_circuit_output))
    return circuit


def bacs_proving_key_from_jax(ref, device) -> bacs_ppzksnark.ProvingKey:
    """The JAX package's BACS ``ProvingKey`` (the circuit and a PGHR13 key)
    -> the port's."""
    return bacs_ppzksnark.ProvingKey(circuit=bacs_circuit_from_reference(ref.circuit),
                                     r1cs_pk=pghr13_proving_key_from_jax(ref.r1cs_pk, device))


def uscs_from_reference(ref) -> USCSConstraintSystem:
    """The JAX package's USCS -> the port's (the same terms)."""
    cs = USCSConstraintSystem(ref.p, ref.primary_input_size, ref.auxiliary_input_size)
    for lc in ref.constraints:
        cs.add_constraint(LinearCombination(lc.terms))
    return cs


def tbcs_circuit_from_reference(ref) -> TBCSCircuit:
    """The JAX package's TBCS circuit -> the port's (the same gates)."""
    circuit = TBCSCircuit(ref.primary_input_size, ref.auxiliary_input_size)
    for g in ref.gates:
        circuit.add_gate(TBCSGate(g.left_wire, g.right_wire, g.type, g.output,
                                  g.is_circuit_output))
    return circuit


def uscs_proving_key_from_jax(ref, device) -> uscs_ppzksnark.ProvingKey:
    """The JAX package's USCS ``ProvingKey`` -> the port's, its queries as
    word tensors on ``device``."""
    queries = {k: _pair(getattr(ref, k), device)
               for k in ("V_g1_query", "alpha_V_g1_query", "H_g1_query", "V_g2_query")}
    return uscs_ppzksnark.ProvingKey(curve=ref.curve, **queries,
                                     constraint_system=uscs_from_reference(ref.constraint_system))


def uscs_verification_key_from_jax(ref) -> uscs_ppzksnark.VerificationKey:
    """Host integers in both packages: a copy."""
    return uscs_ppzksnark.VerificationKey(
        curve=ref.curve, tilde_g2=ref.tilde_g2, alpha_tilde_g2=ref.alpha_tilde_g2, Z_g2=ref.Z_g2,
        encoded_IC_base=ref.encoded_IC_base, encoded_IC_values=list(ref.encoded_IC_values))


def uscs_proof_from_jax(ref) -> uscs_ppzksnark.Proof:
    return uscs_ppzksnark.Proof(V_g1=ref.V_g1, alpha_V_g1=ref.alpha_V_g1, H_g1=ref.H_g1,
                                V_g2=ref.V_g2)


def tbcs_proving_key_from_jax(ref, device) -> tbcs_ppzksnark.ProvingKey:
    """The JAX package's TBCS ``ProvingKey`` (the circuit and a USCS key)
    -> the port's."""
    return tbcs_ppzksnark.ProvingKey(circuit=tbcs_circuit_from_reference(ref.circuit),
                                     uscs_pk=uscs_proving_key_from_jax(ref.uscs_pk, device))


def adsnark_proving_key_from_jax(ref, device) -> adsnark.ProvingKey:
    """The JAX package's ADSNARK ``ProvingKey`` -> the port's, its queries as
    word tensors on ``device``; rA_i_Z_g1 is host integers in both."""
    queries = {k: _pair(getattr(ref, k), device)
               for k in ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g",
                         "C_query_h", "H_query", "K_query")}
    return adsnark.ProvingKey(curve=ref.curve, **queries, rA_i_Z_g1=ref.rA_i_Z_g1,
                              constraint_system=r1cs_from_reference(ref.constraint_system))


def adsnark_verification_key_from_jax(ref) -> adsnark.VerificationKey:
    """Host integers in both packages: a copy."""
    return adsnark.VerificationKey(
        curve=ref.curve, alphaA_g2=ref.alphaA_g2, alphaB_g1=ref.alphaB_g1,
        alphaC_g2=ref.alphaC_g2, gamma_g2=ref.gamma_g2, gamma_beta_g1=ref.gamma_beta_g1,
        gamma_beta_g2=ref.gamma_beta_g2, rC_Z_g2=ref.rC_Z_g2, A0=ref.A0, Ain=list(ref.Ain))


def adsnark_proof_from_jax(ref) -> adsnark.Proof:
    return adsnark.Proof(g_A=ref.g_A, g_B=ref.g_B, g_C=ref.g_C, g_H=ref.g_H, g_K=ref.g_K,
                         g_Aau=ref.g_Aau, muA=ref.muA)


def auth_keys_from_jax(ref) -> adsnark.AuthKeys:
    """The JAX package's ADSNARK ``AuthKeys`` (host integers and the PRF
    seed's bytes) -> the port's."""
    return adsnark.AuthKeys(
        pap=adsnark.PubAuthPrms(I1=ref.pap.I1),
        pak=adsnark.PubAuthKey(minus_i2=ref.pak.minus_i2, sig_vk=ref.pak.sig_vk),
        sak=adsnark.SecAuthKey(i=ref.sak.i, sig_sk=ref.sak.sig_sk, prf_seed=ref.sak.prf_seed))


def auth_data_from_jax(ref) -> list:
    """The JAX package's list of ``AuthData`` -> the port's."""
    return [adsnark.AuthData(mu=ad.mu, Lambda=ad.Lambda, sigma=ad.sigma) for ad in ref]


def tinyram_program_from_reference(ref) -> TinyRAMProgram:
    """The JAX package's TinyRAM program -> the port's (the same machine and
    instructions)."""
    return TinyRAMProgram(TinyRAMArchParams(ref.ap.w, ref.ap.k),
                          [Instruction(i.op, i.des, i.arg1, i.arg2, i.arg2_is_imm)
                           for i in ref.instructions])


def compliance_predicate_from_jax(ref) -> CompliancePredicate:
    """The JAX package's PCD ``CompliancePredicate`` -> the port's (the same
    fields, its R1CS with the same terms)."""
    return CompliancePredicate(
        name=ref.name, type=ref.type, constraint_system=r1cs_from_reference(ref.constraint_system),
        outgoing_message_payload_length=ref.outgoing_message_payload_length,
        max_arity=ref.max_arity,
        incoming_message_payload_lengths=list(ref.incoming_message_payload_lengths),
        local_data_length=ref.local_data_length, witness_length=ref.witness_length,
        relies_on_same_type_inputs=ref.relies_on_same_type_inputs)


def pcd_message_from_jax(ref) -> R1CSPCDMessage:
    return R1CSPCDMessage(type=ref.type, payload=list(ref.payload))


def pcd_local_data_from_jax(ref) -> R1CSPCDLocalData:
    return R1CSPCDLocalData(payload=list(ref.payload))
