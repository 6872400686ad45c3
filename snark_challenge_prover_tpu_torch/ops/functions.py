"""Batched modular functions on the port's word tensors.

Counterpart of the JAX package's ``ops/functions.py`` (cuda-fixnum's
``functions/``: modexp / multi_modexp, modinv, quorem, divexact, chinese,
the Paillier demo).  cuda-fixnum runs one big number a warp slot; here a
batch of big numbers is one ``int32[24, *batch]`` tensor of canonical or
Montgomery words (``ops/limbs.py``), and every step is one vectorised
operation over the batch.  The loops are fixed: 768 passes whatever the
data, with masked updates, the constant-time shape of cuda-fixnum's
``modexp.cu``.  Field products are ``Fp.mul`` / ``Fp.sqr`` (K1 on the
card); the shift-subtract division is plain torch on the limb helpers.
"""

from __future__ import annotations

import torch

from . import limbs as lb
from .field import Fp

R_BITS = 768


def _bit(words: torch.Tensor, b: int) -> torch.Tensor:
    """Bit b of widened canonical words (batch-shaped int64 0/1)."""
    return (words[b // lb.WORD_BITS] >> (b % lb.WORD_BITS)) & 1


def modexp(F: Fp, base, exp_canonical, bits: int = R_BITS):
    """base^exp mod p for Montgomery-form bases and canonical-word exponents
    (functions/modexp.cu): most significant bit first, each of the ``bits``
    passes one squaring and one multiply kept where the exponent's bit is
    set."""
    E = lb.widen(exp_canonical)
    acc = F.ones(torch.broadcast_shapes(base.shape[1:], E.shape[1:]))
    for i in range(bits):
        acc = F.sqr(acc)
        acc = F.select(_bit(E, bits - 1 - i).bool(), F.mul(acc, base), acc)
    return acc


def multi_modexp(F: Fp, base, exps_canonical, bits: int = R_BITS):
    """One base, many exponents (functions/multi_modexp.cu): ``modexp``,
    whose base broadcasts over the exponents' batch."""
    return modexp(F, base, exps_canonical, bits)


def modinv(F: Fp, a):
    """Modular inverse (functions/modinv.cu).  Every modulus here is prime,
    so Fermat replaces the binary xgcd; 0 -> 0."""
    return F.inv(a)


def _shl1(x: torch.Tensor) -> torch.Tensor:
    """Widened canonical words << 1 within the fixed width (the top bit drops)."""
    out = (x << 1) & lb.WORD_MASK
    out[1:] |= x[:-1] >> (lb.WORD_BITS - 1)
    return out


def quorem(num, den):
    """Batched integer (quotient, remainder): restoring shift-subtract
    division in 768 fixed passes (functions/quorem.cu, quorem_preinv.cu).
    ``num`` and ``den`` are canonical words (24, *batch) (``den`` may be
    one (24,) value); den must be nonzero and below 2^767."""
    N = lb.widen(num)
    D = lb.widen(den)
    if D.ndim < N.ndim:
        D = lb.bcast_const(D, N)
    q = torch.zeros_like(N)
    r = torch.zeros_like(N)
    for i in range(R_BITS):
        r = _shl1(r)
        r[0] |= _bit(N, R_BITS - 1 - i)
        d, lt = lb.sub_borrow(r, D)
        take = ~lt
        r = torch.where(take.unsqueeze(0), d, r)
        q = _shl1(q)
        q[0] |= take.to(torch.int64)
    return lb.narrow(q), lb.narrow(r)


def divexact(num, den):
    """Exact division (functions/divexact.cu): where den divides num the
    remainder is zero and quorem's quotient is exact."""
    q, _ = quorem(num, den)
    return q


def _mul_wide_const(t: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical words t (24, *batch) times a constant c < 2^768: the exact
    product as widened redundant words (48, *batch), by the 24-bit column
    helpers."""
    batch = t.shape[1:]
    T = lb.words_to_limbs24(lb.widen(t).reshape(lb.N_WORDS, -1))
    C = torch.tensor([(c >> (lb.LIMB24_BITS * i)) & lb.LIMB24_MASK for i in range(lb.N_LIMBS24)],
                     dtype=torch.int64, device=t.device).unsqueeze(1)
    cols = lb.carry_pass24(lb.mul_columns24(T, C.expand_as(T)), 3)
    return lb.limbs24_to_words(cols).reshape((2 * lb.N_WORDS,) + batch)


def chinese(F1: Fp, F2: Fp, a, b):
    """CRT combine (functions/chinese.cu): the unique x mod p1 p2 with
    x = a (mod p1) and x = b (mod p2), for canonical residue words a < p1
    and b < p2 on F2's device.  The moduli are 753-bit, so the result is
    double width: canonical words (48, *batch).  Garner's form, as chinese.cu
    recombines: t = (b - a) p1^-1 mod p2 on F2 (K1), then x = a + p1 t
    exactly, whose product is built from the limb helpers' columns."""
    p1, p2 = F1.p, F2.p
    if p1 >= 2 * p2:
        raise ValueError("chinese reduces a mod p2 by one subtraction: it needs p1 < 2 p2")
    a2 = lb.narrow(lb.cond_sub(lb.widen(a), F2.p_wide))  # a mod p2
    diff = F2.sub(F2.from_canonical(b), F2.from_canonical(a2))
    t = F2.to_canonical(F2.mul_const(diff, F2.const(pow(p1, -1, p2))))  # < p2
    x = _mul_wide_const(t, p1)
    x[: lb.N_WORDS] += lb.widen(a)
    return lb.narrow(lb.normalize(x))


# ---------------------------------------------------------------------------
# Paillier demo (host): cuda-fixnum's functions/paillier_*.cu example, not
# part of the prover.
# ---------------------------------------------------------------------------

def paillier_encrypt(n: int, g: int, m: int, r: int) -> int:
    """c = g^m * r^n mod n^2."""
    n2 = n * n
    return pow(g, m, n2) * pow(r, n, n2) % n2


def paillier_decrypt(n: int, lam: int, c: int) -> int:
    """m = L(c^lam mod n^2) / L(g^lam mod n^2) with g = n+1:
    simplifies to L(c^lam) * lam^{-1}... standard textbook form."""
    n2 = n * n
    u = pow(c, lam, n2)
    L = (u - 1) // n
    # with g = n+1, the denominator is lam mod n
    return L * pow(lam, -1, n) % n
