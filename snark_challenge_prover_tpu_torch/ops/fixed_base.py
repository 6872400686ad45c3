"""Fixed-base exponentiation and wNAF scalar multiplication.

Counterpart of the JAX package's ``ops/fixed_base.py`` (libff
multiexp.tcc:507-682 and wnaf.tcc:25-125), the key generator's workhorse:

  * ``get_window_table`` builds T[w, j] = j 2^(w c) P for w < W =
    ceil(753 / c), j < 2^c.  Its points are fixed group elements, so the
    rows are built side by side: the W row bases by a chain of c-fold
    doublings (one launch each), then each row's 2^c entries in c levels,
    level b adding 2^b times the row base to entries [0, 2^b) of every row
    in one launch of W 2^b lanes.  About W + 2c launches where the JAX
    package scans W 2^c one-lane additions.
  * ``batch_exp`` (libff's windowed_exp and batch_exp in one): per
    window, a gather of each scalar's table entry by its digit
    (``ops.msm.window_digits``) and one N-wide addition, so W additions
    whatever N; ``batch_exp_with_coeff`` scales the scalars first.
  * ``fixed_window_wnaf_exp`` / ``opt_window_wnaf_exp``: one point times a
    host scalar; the digits are host integers, a run of k zero digits is one
    launch of k doublings (``Curve.double(P, times=k)``) and the odd
    multiples are built in levels like the table's entries.

Every addition and doubling goes through ``Curve.add`` / ``Curve.double``,
the CUDA kernels on the card.
"""

from __future__ import annotations

import math

import torch

from . import limbs as lb
from .group import Curve
from .msm import SCALAR_BITS, window_digits

# windows whose digits are cut in one pass over the scalars: each pass copies
# the scalars once, and its digits and temporaries take 20 bytes a window a lane
_DIGIT_WINDOWS = 16


def get_exp_window_size(num_scalars: int) -> int:
    """Window bits for batch_exp over ``num_scalars`` scalars: the JAX
    package's rule, log2 clamped to [2, 10]."""
    if num_scalars <= 4:
        return 2
    return max(2, min(10, int(math.log2(num_scalars))))


def _cat(parts):
    """Point batches concatenated along the last axis."""
    return tuple(torch.cat(c, dim=-1) for c in zip(*parts))


def _last(P):
    """A point batch with a new last axis of length 1."""
    return tuple(t.unsqueeze(-1) for t in P)


def _doubling_levels(curve: Curve, P, levels: int):
    """[j P for j < 2^levels] along a new last axis of P's batch: level b
    adds 2^b P to entries [0, 2^b) in one launch."""
    out = _last(curve.zero(P[0].shape[curve.F.elem_ndim:]))
    step = P
    for b in range(levels):
        out = _cat([out, curve.add(out, _last(step))])
        if b + 1 < levels:
            step = curve.double(step)
    return out


def get_window_table(curve: Curve, window: int, base, scalar_bits: int = SCALAR_BITS):
    """T[w, j] = j 2^(w window) base for w < ceil(scalar_bits / window),
    j < 2^window (multiexp.tcc:552-583).  ``base`` is one projective point
    (batch ()); the table is a projective triple with batch (W, 2^window)."""
    W = (scalar_bits + window - 1) // window
    rows = [base]
    for _ in range(W - 1):
        rows.append(curve.double(rows[-1], times=window))
    bases = tuple(torch.stack(c, dim=-1) for c in zip(*rows))  # batch (W,)
    return _doubling_levels(curve, bases, window)


def batch_exp(curve: Curve, window: int, table, scalars_canonical: torch.Tensor,
              scalar_bits: int = SCALAR_BITS):
    """[s_i base] for canonical scalars (24, *batch) -> projective points
    with that batch (multiexp.tcc:585-647, windowed_exp and batch_exp): one
    gather and, from the second window on, one addition a window."""
    k = curve.F.elem_ndim
    W, B = table[0].shape[-2:]
    if (scalar_bits + window - 1) // window != W or 1 << window != B:
        raise ValueError(f"table of {W} x {B} entries, not one of {window}-bit windows")
    flat = tuple(t.reshape(t.shape[:k] + (W * B,)) for t in table)
    batch = scalars_canonical.shape[1:]
    acc = None
    for w0 in range(0, W, _DIGIT_WINDOWS):
        ws = range(w0, min(W, w0 + _DIGIT_WINDOWS))
        digits = window_digits(scalars_canonical, window, scalar_bits, ws)
        for w, dig in zip(ws, digits):
            idx = dig.reshape(-1).long() + w * B
            P = tuple(t.index_select(-1, idx).reshape(t.shape[:k] + batch) for t in flat)
            acc = P if acc is None else curve.add(acc, P)
    return acc


def batch_exp_with_coeff(curve: Curve, window: int, table, coeff_mont: torch.Tensor,
                         scalars_mont: torch.Tensor, F, scalar_bits: int = SCALAR_BITS):
    """[(coeff s_i) base] (multiexp.tcc:649-682), the coefficient and the
    scalars (24, *batch) in Montgomery form over the scalar field F; the
    coefficient is one (24,) for all, or one a scalar.  The products and
    their canonical form on the device."""
    prod = F.mul(scalars_mont, lb.bcast_const(coeff_mont, scalars_mont))
    return batch_exp(curve, window, table, F.to_canonical(prod), scalar_bits)


# ---------------------------------------------------------------------------
# wNAF
# ---------------------------------------------------------------------------
def find_wnaf(window_size: int, scalar: int) -> list[int]:
    """Width-(window_size + 1) non-adjacent form, least significant digit
    first (wnaf.tcc:25-60): every nonzero digit odd, |digit| < 2^window_size."""
    res = []
    c = scalar
    mod = 1 << (window_size + 1)
    while c > 0:
        if c & 1:
            u = c % mod
            if u > mod // 2:
                u -= mod
            c -= u
        else:
            u = 0
        res.append(u)
        c >>= 1
    return res


def fixed_window_wnaf_exp(curve: Curve, window_size: int, P, scalar: int):
    """scalar P by wNAF digits (wnaf.tcc:62-99), P one projective point
    (batch ()).  Most significant digit first: a doubling a digit, one
    launch for each run of them, and an addition of the digit's odd
    multiple of P (negated for a negative digit) at every nonzero digit."""
    naf = find_wnaf(window_size, scalar)
    if not naf:
        return curve.zero(())
    odd = _doubling_levels(curve, curve.double(P), window_size - 1)  # [2j P]
    odd = curve.add(odd, _last(P))  # [(2j + 1) P for j < 2^(window_size - 1)]
    acc, run = None, 0
    for d in reversed(naf):
        if acc is not None:
            run += 1
        if d:
            if run:
                acc = curve.double(acc, times=run)
                run = 0
            Q = tuple(t[..., (abs(d) - 1) // 2] for t in odd)
            if d < 0:
                Q = curve.neg(Q)
            acc = Q if acc is None else curve.add(acc, Q)
    return curve.double(acc, times=run) if run else acc


def opt_window_wnaf_exp(curve: Curve, P, scalar: int, scalar_bits: int | None = None):
    """wNAF with the window scaled to the scalar's size (wnaf.tcc:101-125)."""
    bits = scalar_bits if scalar_bits is not None else max(1, scalar.bit_length())
    window = max(2, min(8, int(math.log2(max(2, bits))) - 2))
    return fixed_window_wnaf_exp(curve, window, P, scalar)
