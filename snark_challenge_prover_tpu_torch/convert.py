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
from .proof_systems.groth16_full import Proof, ProvingKey, VerificationKey
from .relations.r1cs import LinearCombination, R1CSConstraint, R1CSConstraintSystem


def _words(planes) -> np.ndarray:
    """Limb planes with the limb axis second-to-last -> word arrays."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        return planes16_to_words(planes)
    return np.stack([planes16_to_words(c) for c in planes])


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
    """Limb planes ((48, N) or (deg, 48, N)) -> the port's tensor on ``device``."""
    return torch.from_numpy(_words(planes)).to(device)


def planes_from_port(x: torch.Tensor) -> np.ndarray:
    """The port's tensor ((24, ...) or (deg, 24, ...)) -> 16-bit limb planes."""
    if x.shape[0] == 24:
        return to_planes16(x)
    return np.stack([to_planes16(c) for c in x])


def r1cs_from_reference(ref) -> R1CSConstraintSystem:
    """The JAX package's constraint system -> the port's (the same terms)."""
    cs = R1CSConstraintSystem(ref.p, ref.primary_input_size, ref.auxiliary_input_size)
    for c in ref.constraints:
        cs.add_constraint(R1CSConstraint(LinearCombination(c.a.terms), LinearCombination(c.b.terms),
                                         LinearCombination(c.c.terms), c.is_square))
    return cs


def proving_key_from_jax(ref, device) -> ProvingKey:
    """The JAX package's ``ProvingKey`` (queries as affine 16-bit limb
    planes, the identity stored as (0, 0)) -> the port's, its queries as
    word tensors on ``device``; the single points are host integers in both."""
    pair = lambda xy: (tensor_from_planes(xy[0], device), tensor_from_planes(xy[1], device))
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
