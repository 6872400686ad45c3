"""Frobenius-map constants of the MNT4753 / MNT6753 extension towers, on
the host.

Counterpart of the part of the JAX package's ``ops/frobenius.py`` that the
ate pairing's final exponentiation needs (libff fp2/fp3/fp4/fp6_2over3.tcc
Frobenius_coeffs): x -> x^q acts on the component u^m of Fq[u]/(u^k - nr)
as multiplication by nr^(m (q - 1) / k), derived here with exact integers
(the reference publishes them as decimal strings, mnt4753_init.cpp:104-118,
mnt6753_init.cpp:108-124).
"""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def ext_frobenius_coeffs(q: int, nr: int, k: int) -> tuple:
    """(nr^(m (q - 1) / k) mod q for m < k): the scalars of x -> x^q on the
    components of Fq[u]/(u^k - nr)."""
    if (q - 1) % k:
        raise ValueError(f"{k} does not divide q - 1")
    e = (q - 1) // k
    return tuple(pow(nr, m * e, q) for m in range(k))
