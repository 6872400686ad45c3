"""Multi-scalar multiplication: staged Pippenger bucket method.

Counterpart of the staged MSM of the JAX package's ``ops/msm.py``
(``msm_multi_staged``), and the port's only MSM.  For M independent MSMs
of N points each, with c-bit windows:

1. ``window_digits`` cuts every scalar into W = ceil(753 / c) digits.
2. Bucket stage, for a group of Gr windows at a time (R = Gr * M rows):
   sort each row's points by digit, take one inclusive prefix scan of EC
   additions along the row (work-efficient tree, ~2N additions), and read
   each bucket's total as the difference of the prefix values at its two
   ends (points form a group, so no segmented scan is needed; the
   complete addition formula makes P + (-P) exact).  Digit 0 sorts first
   and its bucket is never read.
3. Triangle stage: sum_b b * bucket_b as a reverse suffix scan over the
   buckets followed by a tree reduction.
4. Horner: c doublings (one launch) and one addition per window, most
   significant window first.

All EC arithmetic goes through ``Curve.add`` / ``Curve.double``; the rest
is sort / gather / slicing in plain PyTorch.  The whole N is one chunk;
Gr is sized so a group's working set fits the device's free memory.
"""

from __future__ import annotations

import math

import torch

from . import limbs as lb
from .group import Curve

SCALAR_BITS = 753

# bytes of working set per point lane of the bucket stage, per 96-byte
# coordinate word row: sorted points, the scan's levels and temporaries
_WORKSET_COPIES = 12
_CPU_LANES = 1 << 22


def default_window_bits(n: int) -> int:
    """Bucket window size, ~log2(n) - 3 clamped to [4, 16] (same flavour as
    libff's get_exp_window_size, multiexp.tcc:507)."""
    if n <= 1:
        return 4
    return max(4, min(16, int(math.log2(n)) - 3))


def window_digits(scalars: torch.Tensor, c: int, scalar_bits: int = SCALAR_BITS,
                  windows=None) -> torch.Tensor:
    """(24, *batch) canonical int32 words -> (W, *batch) int32 digits,
    least significant window first; ``windows`` selects a subset of window
    indices (any order; indices >= W give zero digits)."""
    if not 1 <= c <= 16:
        raise ValueError("window bits must be in [1, 16]")
    W = (scalar_bits + c - 1) // c
    if windows is None:
        windows = range(W)
    dev = scalars.device
    bit = torch.tensor([w * c for w in windows], dtype=torch.int64, device=dev)
    pad = torch.zeros((2,) + scalars.shape[1:], dtype=scalars.dtype, device=dev)
    s = torch.cat([scalars, pad], dim=0)
    i0 = (bit // 32).clamp(max=s.shape[0] - 2)
    live = (bit < scalar_bits).reshape((-1,) + (1,) * (s.ndim - 1))
    off = (bit % 32).reshape(live.shape)
    lo = lb.widen(s.index_select(0, i0))
    hi = lb.widen(s.index_select(0, i0 + 1))
    # off == 0: hi's bits land at >= 32 and are masked off (c <= 16)
    val = ((lo >> off) | (hi << (32 - off))) & ((1 << c) - 1)
    return torch.where(live, val, torch.zeros_like(val)).to(torch.int32)


def _take(curve: Curve, pts, idx: torch.Tensor):
    """Gather along the last axis with a batch-shaped index (clamped by the caller)."""
    k = curve.F.elem_ndim
    return tuple(torch.gather(t, -1, idx.expand(t.shape[:k] + idx.shape)) for t in pts)


def _ec_reduce(curve: Curve, elems):
    """Sum of the points along the last axis, by halving."""
    x = elems
    n = x[0].shape[-1]
    while n > 1:
        half = n // 2
        s = curve.add(tuple(t[..., :half] for t in x), tuple(t[..., half : 2 * half] for t in x))
        if n % 2:
            s = tuple(torch.cat([a, t[..., -1:]], dim=-1) for a, t in zip(s, x))
        x = s
        n = x[0].shape[-1]
    return tuple(t[..., 0] for t in x)


def _ec_scan(curve: Curve, elems, reverse: bool = False):
    """Inclusive EC-add scan along the last axis (Ladner-Fischer recursive
    halving: ~2N additions, odd tails handled exactly)."""
    if reverse:
        elems = tuple(t.flip(-1) for t in elems)
    k = curve.F.elem_ndim

    def rec(x):
        L = x[0].shape[-1]
        if L == 1:
            return x
        half = L // 2
        even = tuple(t[..., 0 : 2 * half : 2] for t in x)
        odd = tuple(t[..., 1 : 2 * half : 2] for t in x)
        pairs = curve.add(even, odd)
        if L % 2:
            pairs = tuple(torch.cat([p, t[..., -1:]], dim=-1) for p, t in zip(pairs, x))
        ps = rec(pairs)  # ps[i] = inclusive scan at position 2i + 1
        # even positions: scan[2i] = ps[i - 1] + x[2i], with ps[-1] the identity
        ident = curve.zero(even[0].shape[k:-1] + (1,))
        prev = tuple(torch.cat([i_, p[..., : half - 1]], dim=-1) for i_, p in zip(ident, ps))
        ev = curve.add(prev, even)
        out = tuple(
            torch.stack([a, b[..., :half]], dim=-1).reshape(a.shape[:-1] + (2 * half,))
            for a, b in zip(ev, ps)
        )
        if L % 2:
            out = tuple(torch.cat([o, p[..., -1:]], dim=-1) for o, p in zip(out, ps))
        return out

    out = rec(tuple(elems))
    if reverse:
        out = tuple(t.flip(-1) for t in out)
    return out


def _bucket_totals(curve: Curve, pts, digits: torch.Tensor, B: int):
    """pts: coordinates with batch (Gr, M, N) (the Gr axis may be a
    broadcast view); digits (Gr, M, N) in [0, B) -> totals of buckets
    1..B-1, batch (Gr * M, B - 1)."""
    k = curve.F.elem_ndim
    N = digits.shape[-1]
    R = digits.numel() // N
    keys, order = torch.sort(digits, dim=-1, stable=True)
    sorted_pts = tuple(t.reshape(t.shape[:k] + (R, N)) for t in _take(curve, pts, order))
    del order
    keys = keys.reshape(R, N)
    pref = _ec_scan(curve, sorted_pts)
    del sorted_pts
    # bucket b occupies sorted positions [end[b-1], end[b]) of its row
    probe = torch.arange(B, dtype=keys.dtype, device=keys.device).expand(R, B).contiguous()
    end = torch.searchsorted(keys, probe, right=True)
    lo, hi = end[:, :-1], end[:, 1:]
    ident = curve.zero((R, B - 1))
    upper = curve.select(hi == 0, ident, _take(curve, pref, (hi - 1).clamp(min=0)))
    lower = curve.select(lo == 0, ident, _take(curve, pref, (lo - 1).clamp(min=0)))
    # an empty bucket has hi == lo: the same prefix twice, P + (-P) = identity
    return curve.add(upper, curve.neg(lower))


def _window_sums(curve: Curve, buckets):
    """buckets 1..B-1 with batch (R, B - 1) -> sum_b b * bucket_b, batch (R,)."""
    return _ec_reduce(curve, _ec_scan(curve, buckets, reverse=True))


def _default_window_group(curve: Curve, W: int, M: int, N: int, B: int) -> int:
    """Windows per bucket-stage group: as many as the device's free memory
    holds of (Gr * M, max(N, B)) point lanes."""
    lane_bytes = 3 * curve.deg * 96 * _WORKSET_COPIES
    if curve.device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(curve.device)
        lanes = free // 2 // lane_bytes
    else:
        lanes = _CPU_LANES
    return int(max(1, min(W, lanes // max(1, M * max(N, B)))))


def msm_multi_staged(curve: Curve, points, scalars_canonical: torch.Tensor,
                     c: int | None = None, window_group: int | None = None,
                     scalar_bits: int = SCALAR_BITS):
    """M independent MSMs over one curve.

    points: projective triple with trailing batch (M, N)
    scalars_canonical: (24, M, N) canonical (non-Montgomery) words
    Returns a projective point batch of shape (M,).
    """
    k = curve.F.elem_ndim
    M, N = points[0].shape[-2:]
    if c is None:
        c = default_window_bits(N)
    B = 1 << c
    W = (scalar_bits + c - 1) // c
    Gr = window_group if window_group is not None else _default_window_group(curve, W, M, N, B)
    n_groups = (W + Gr - 1) // Gr

    carry = curve.zero((M,))
    for g in range(n_groups):
        # most significant windows first; window indices >= W carry zero digits
        wins = [n_groups * Gr - 1 - (g * Gr + j) for j in range(Gr)]
        digits = window_digits(scalars_canonical, c, scalar_bits, wins)  # (Gr, M, N)
        rows = tuple(t.unsqueeze(-3).expand(t.shape[:k] + (Gr, M, N)) for t in points)
        S = _window_sums(curve, _bucket_totals(curve, rows, digits, B))
        del rows, digits
        S = tuple(t.reshape(t.shape[:k] + (Gr, M)) for t in S)
        for j in range(Gr):
            carry = curve.double(carry, times=c)
            carry = curve.add(carry, tuple(t[..., j, :] for t in S))
    return carry


def msm_staged(curve: Curve, points, scalars_canonical, c: int | None = None,
               window_group: int | None = None, scalar_bits: int = SCALAR_BITS):
    """Single MSM: points batch (N,), scalars (24, N) -> point batch ()."""
    pts = tuple(t.unsqueeze(-2) for t in points)
    out = msm_multi_staged(curve, pts, scalars_canonical.unsqueeze(1), c, window_group, scalar_bits)
    return tuple(t[..., 0] for t in out)


def pad_and_stack(curve: Curve, point_list, scalar_list):
    """Pad M (points, scalars) pairs to a common length with identity
    points and zero scalars, and stack along a new M axis."""
    k = curve.F.elem_ndim
    n_max = max(s.shape[-1] for s in scalar_list)

    def pad_coord(t, fill):
        return torch.cat([t, fill(t.shape[k:-1] + (n_max - t.shape[-1],))], dim=-1)

    fills = (curve.F.zeros, curve.F.ones, curve.F.zeros)
    coords = tuple(
        torch.stack([pad_coord(p[i], fills[i]) for p in point_list], dim=-2) for i in range(3)
    )
    scalars = [torch.nn.functional.pad(s, (0, n_max - s.shape[-1])) for s in scalar_list]
    return coords, torch.stack(scalars, dim=1)
