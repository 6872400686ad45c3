"""Frobenius-map constants of the MNT4753 / MNT6753 extension towers, on
the host.

Counterpart of the JAX package's ``ops/frobenius.py`` (libff
fp2/fp3/fp4/fp6_2over3.tcc Frobenius_coeffs and the G2 ``mul_by_q`` twist
multipliers): x -> x^q acts on the component u^m of Fq[u]/(u^k - nr) as
multiplication by nr^(m (q - 1) / k), derived here with exact integers
(the reference publishes them as decimal strings, mnt4753_init.cpp:104-118
and 131-132, mnt6753_init.cpp:108-124 and 146-147).
"""

from __future__ import annotations

from functools import lru_cache

from ..models.primes import FIELD_A, FIELD_B


@lru_cache(maxsize=None)
def ext_frobenius_coeffs(q: int, nr: int, k: int, mult: int = 1) -> tuple:
    """(nr^(mult m (q - 1) / k) mod q for m < k): the scalars of x -> x^q on
    the components of Fq[u]/(u^k - nr); mult = 2 gives Fp3's coeffs_c2."""
    if (q - 1) % k:
        raise ValueError(f"{k} does not divide q - 1")
    e = mult * (q - 1) // k
    return tuple(pow(nr, m * e, q) for m in range(k))


def fq2_frobenius_coeffs_c1(q: int, nr: int) -> tuple:
    """fp2.tcc Frobenius_coeffs_c1: (1, nr^((q - 1) / 2)) = (1, -1)."""
    return ext_frobenius_coeffs(q, nr, 2)


def fq3_frobenius_coeffs_c1(q: int, nr: int) -> tuple:
    return ext_frobenius_coeffs(q, nr, 3)


def fq3_frobenius_coeffs_c2(q: int, nr: int) -> tuple:
    return ext_frobenius_coeffs(q, nr, 3, mult=2)


def fq4_frobenius_coeffs_c1(q: int, nr: int) -> tuple:
    """fp4.tcc: x -> x^q scales the Fq2 coefficient of v in Fq4 =
    Fq2[v]/(v^2 - u) by nr^((q - 1) / 4)."""
    return ext_frobenius_coeffs(q, nr, 4)


def fq6_frobenius_coeffs_c1(q: int, nr: int) -> tuple:
    """fp6_2over3.tcc, for Fq6 = Fq3[v]/(v^2 - u)."""
    return ext_frobenius_coeffs(q, nr, 6)


def mnt4753_twist_mul_by_q() -> tuple:
    """(X, Y) multipliers of mnt4753_G2::mul_by_q (mnt4753_g2.cpp:364-369,
    mnt4753_init.cpp:131-132): X = nr^((q - 1) / 2) = -1, Y = nr^((q - 1) / 4)."""
    q, nr = FIELD_B.p, 13
    return (pow(nr, (q - 1) // 2, q), pow(nr, (q - 1) // 4, q))


def mnt6753_twist_mul_by_q() -> tuple:
    """(X, Y) multipliers of mnt6753_G2::mul_by_q (mnt6753_init.cpp:146-147):
    X = nr^(2 (q - 1) / 3) (Fq3's coeffs_c2[1]), Y = nr^((q - 1) / 2) = -1."""
    q, nr = FIELD_A.p, 11
    return (pow(nr, 2 * (q - 1) // 3, q), pow(nr, (q - 1) // 2, q))
