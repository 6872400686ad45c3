"""Knowledge commitments: pairs (g in T1, h in T2) with componentwise group
structure (libsnark knowledge_commitment.hpp:37+).

Counterpart of the JAX package's ``proof_systems/knowledge_commitment.py``.
The reference stores the Groth16 B query as a sparse vector of (G2, G1)
pairs and walks both components together, in ``kc_batch_exp`` (key
generation) and ``kc_multi_exp_with_mixed_addition`` (proving,
kc_multiexp.tcc).  Here a vector is dense (a zero scalar costs nothing in
the bucket method), and ``kc_batch_exp`` and ``kc_multi_exp`` run the two
components one after the other.  ``kc_multi_exp_fused`` is the same call:
sharing each window group's digit cut and sort between the two groups was
measured slower than two MSMs on the H100 (PERF.md, Findings).  Both
components take the same window, the default for their length.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops import fixed_base
from ..ops import msm as msm_mod


class KCVector(NamedTuple):
    """A dense knowledge-commitment vector: two projective point batches of
    equal trailing length N (the reference's sparse_vector, knowledge_
    commitment.hpp:37, is an optimisation over exactly this)."""

    g: tuple  # T1 points, e.g. G2
    h: tuple  # T2 points, e.g. G1


def kc_batch_exp(curve_T1, curve_T2, window_T1: int, window_T2: int, table_T1, table_T2,
                 coeff_T1, coeff_T2, scalars_mont, F,
                 scalar_bits: int = msm_mod.SCALAR_BITS) -> KCVector:
    """[((coeff_T1 s_i) base_T1, (coeff_T2 s_i) base_T2)], the B query's
    builder (kc_multiexp.tcc kc_batch_exp; the Groth16 generator's
    coefficients are one, r1cs_gg_ppzksnark.tcc:330): two
    ``fixed_base.batch_exp_with_coeff`` on the model's device."""
    g = fixed_base.batch_exp_with_coeff(curve_T1, window_T1, table_T1, coeff_T1, scalars_mont, F,
                                        scalar_bits)
    h = fixed_base.batch_exp_with_coeff(curve_T2, window_T2, table_T2, coeff_T2, scalars_mont, F,
                                        scalar_bits)
    return KCVector(g=g, h=h)


def kc_multi_exp(curve_T1, curve_T2, kc: KCVector, scalars_canonical, c: int | None = None,
                 scalar_bits: int = msm_mod.SCALAR_BITS):
    """(sum s_i g_i, sum s_i h_i) by two ``msm_staged``, one a component;
    scalars (24, N) canonical.  Returns two projective points, batch ()."""
    return (msm_mod.msm_staged(curve_T1, kc.g, scalars_canonical, c, scalar_bits=scalar_bits),
            msm_mod.msm_staged(curve_T2, kc.h, scalars_canonical, c, scalar_bits=scalar_bits))


def kc_multi_exp_fused(curve_T1, curve_T2, kc: KCVector, scalars_canonical,
                       c: int | None = None, scalar_bits: int = msm_mod.SCALAR_BITS):
    """The JAX package's name for the simultaneous walk (kc_multiexp.tcc:64-130).
    It is ``kc_multi_exp``: one digit cut and sort a window group shared by
    both components was 1.4-2.1 % slower than two ``msm_staged`` at MNT4753
    2^20 on the H100 (PERF.md, Findings)."""
    return kc_multi_exp(curve_T1, curve_T2, kc, scalars_canonical, c, scalar_bits)
