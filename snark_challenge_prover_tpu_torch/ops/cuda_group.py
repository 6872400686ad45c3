"""Fused group-law kernels: the CUDA wrappers and their plain versions.

Counterpart of ``ops/pallas_group.py`` in the JAX package.  ``ec_add`` is
the complete projective addition of Renes-Costello-Batina (2015, Alg. 1,
arbitrary a): 12 products, the multiplications by a and 3b, no case
distinctions.  ``ec_dbl`` is dbl-2007-bl, ``times`` doublings in one
launch, with the identity (X = 0 and Z = 0) kept at every doubling.  Both
work on projective triples of coordinate tensors ``(24, *batch)`` (G1,
over Fq) or ``(deg, 24, *batch)`` (G2, over Fq2 or Fq3) and return
canonical coordinates, so the kernel and the plain version agree word for
word.  For a CUDA tensor the wrappers launch the kernels of
``csrc/ec_add.cu`` / ``csrc/ec_dbl.cu`` or raise; for a CPU tensor they
call the plain versions.

Both kernels are compiled once per curve group, with that group's modulus
and small a (and for the addition the sparsity of 3b) built in.  Each
model declares the ``AddKernel`` and ``DblKernel`` of its groups next to
their constants, and ``Curve`` checks the declarations against a and 3b.
A curve that declares none has no such kernel, and its CUDA tensors raise.
The doubling kernel gives each point a warp: the MSM's Horner step doubles
4 points or 1, whose time is the latency of one point's chain of products.

Op counts (``utils/op_counts``): both paths record ``<group>.add`` once a
point, and ``<group>.dbl`` once a point and a doubling.  The plain versions
record their field operations through ``Fp``; a kernel launch, which makes
them inside the kernel, records the same figures (``formula_ops``) times
its points, so a call reports the same on the card and on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..utils import op_counts
from .cuda_field import check_words, launch_lanes, launches


@dataclass(frozen=True)
class AddKernel:
    """One instantiation of ``csrc/ec_add.cu`` (``EC_ADD_INSTANTIATIONS``),
    for a curve with a = a_k u^a_s, a_k a small integer, and 3b = c u^b3_s
    (u the extension's generator, u^0 = 1)."""

    launcher: str
    a_k: int
    a_s: int
    b3_s: int


@dataclass(frozen=True)
class DblKernel:
    """One instantiation of ``csrc/ec_dbl.cu`` (``EC_DBL_INSTANTIATIONS``),
    for a curve with a = a_k u^a_s, a_k a small integer."""

    launcher: str
    a_k: int
    a_s: int


def add_kernel(curve) -> AddKernel:
    """The addition kernel compiled for this curve; raises if there is none."""
    if curve.add_form is None:
        raise RuntimeError(f"{curve.name}: no addition kernel is compiled for its modulus, "
                           "degree, a and 3b (csrc/ec_add.cu EC_ADD_INSTANTIATIONS)")
    return curve.add_form


def dbl_kernel(curve) -> DblKernel:
    """The doubling kernel compiled for this curve; raises if there is none."""
    if curve.dbl_form is None:
        raise RuntimeError(f"{curve.name}: no doubling kernel is compiled for its modulus, "
                           "degree and a (csrc/ec_dbl.cu EC_DBL_INSTANTIATIONS)")
    return curve.dbl_form


def _mulsb(F, xs, ys):
    """[x_i * y_i] through one batched field product along a fresh axis."""
    k = F.elem_ndim
    shape = torch.broadcast_shapes(*(x.shape for x in xs), *(y.shape for y in ys))
    A = torch.stack([x.expand(shape) for x in xs], dim=k)
    B = torch.stack([y.expand(shape) for y in ys], dim=k)
    return F.mul(A, B).unbind(dim=k)


def _const(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return c.reshape(c.shape + (1,) * (like.ndim - c.ndim))


def _times_monomial(F, x, s: int, scale, scale_nr):
    """x c u^s in F = Fq[u] / (u^d - nr), given scale(v) = c v and
    scale_nr(v) = (nr c) v on base-field values: component i of the result
    is c x[i - s] for i >= s and (nr c) x[i - s + d] for i < s."""
    d = getattr(F, "deg", 1)
    if d == 1:
        return scale(x)
    return torch.stack([scale(x[i - s]) if i >= s else scale_nr(x[i - s + d]) for i in range(d)])


def _mul_a(curve, F, xs, form):
    """[a x for x in xs]: small-integer scalings where the curve has the
    kernel ``form`` (an ``AddKernel`` or ``DblKernel``: a = a_k u^a_s),
    full products where it has none."""
    if form is None:
        return _mulsb(F, [_const(curve.a, xs[0])] * len(xs), xs)
    base = getattr(F, "base", F)
    nr = getattr(F, "nr", 1)
    return [_times_monomial(F, x, form.a_s, lambda v: base.mul_small(v, form.a_k),
                            lambda v: base.mul_small(v, form.a_k * nr)) for x in xs]


def _mul_b3(curve, F, xs):
    """[3b x for x in xs]: one base product a component where the curve has
    an addition kernel (3b = c u^b3_s), full products otherwise."""
    form, d = curve.add_form, curve.deg
    if form is None or d == 1:  # over Fq the monomial is the constant itself
        return _mulsb(F, [_const(curve.b3, xs[0])] * len(xs), xs)
    c, nr_c = curve.b3[form.b3_s], curve.nr_b3[form.b3_s]
    # every base product of every x through one batched call
    srcs, consts = [], []
    for x in xs:
        for i in range(d):
            srcs.append(x[i - form.b3_s] if i >= form.b3_s else x[i - form.b3_s + d])
            consts.append(_const(c if i >= form.b3_s else nr_c, srcs[-1]))
    prods = _mulsb(F.base, consts, srcs)
    return [torch.stack(prods[k * d:(k + 1) * d]) for k in range(len(xs))]


def _points(curve, *pts) -> int:
    """Points in the broadcast batch of the point triples ``pts``."""
    k = curve.F.elem_ndim
    return math.prod(torch.broadcast_shapes(*(t.shape for P in pts for t in P))[k:])


def formula_ops(curve, op: str) -> dict:
    """The field operations a point that the plain version of ``op`` ("add",
    or "dbl" for one doubling) records, {key: count}: counted once a curve by
    running it on one point."""
    cache = curve.__dict__.setdefault("_formula_ops", {})
    if op not in cache:
        P = curve.zero((1,))
        with op_counts.counting() as c:
            ec_add_plain(curve, P, P) if op == "add" else ec_dbl_plain(curve, P)
        cache[op] = {k: v for k, v in c.counts.items() if k != f"{curve.name}.{op}"}
    return cache[op]


def _count_kernel(curve, op: str, n: int):
    """What a kernel launch of ``op`` on n points (n doublings of points for
    k doublings a launch) records: the group operation and its field
    operations, those of the plain version."""
    op_counts.record(f"{curve.name}.{op}", n)
    for key, v in formula_ops(curve, op).items():
        op_counts.record(key, v * n)


def ec_add_plain(curve, P, Q):
    """Plain PyTorch complete addition on any device, on the kernel's
    schedule: a and 3b multiply as the monomials of the curve's addition
    kernel, by small-integer scaling and one base product a component."""
    if op_counts.active() is not None:
        op_counts.record(f"{curve.name}.add", _points(curve, P, Q))
    F = curve.F.plain()
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2, t3, t4, t5 = _mulsb(
        F,
        [X1, Y1, Z1, F.add(X1, Y1), F.add(X1, Z1), F.add(Y1, Z1)],
        [X2, Y2, Z2, F.add(X2, Y2), F.add(X2, Z2), F.add(Y2, Z2)],
    )
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.sub(t4, F.add(t0, t2))
    t5 = F.sub(t5, F.add(t1, t2))
    b3t2, b3t4 = _mul_b3(curve, F, [t2, t4])
    at4, t2a = _mul_a(curve, F, [t4, t2], curve.add_form)
    z = F.add(b3t2, at4)                                # 3b t2 + a t4
    xm, zm = F.sub(t1, z), F.add(t1, z)
    u = F.add(F.add(F.add(t0, t0), t0), t2a)            # 3 t0 + a t2
    v = F.add(b3t4, _mul_a(curve, F, [F.sub(t0, t2a)], curve.add_form)[0])  # 3b t4 + a (t0 - a t2)
    m = _mulsb(F, [t3, t5, xm, u, t5, t3], [xm, v, zm, v, zm, u])
    return (F.sub(m[0], m[1]), F.add(m[2], m[3]), F.add(m[4], m[5]))


def ec_dbl_plain(curve, P, times: int = 1):
    """Plain PyTorch doubling on any device, ``times`` times; the identity
    is kept.  On the kernel's schedule: four levels of products, and a ZZ
    as the monomial of the curve's doubling kernel (small-integer scaling)."""
    F = curve.F.plain()
    for _ in range(times):
        if op_counts.active() is not None:
            op_counts.record(f"{curve.name}.dbl", _points(curve, P))
        X1, Y1, Z1 = P
        XX, ZZ, Y1Z1 = _mulsb(F, [X1, Z1, Y1], [X1, Z1, Z1])
        s = F.double(Y1Z1)
        (aZZ,) = _mul_a(curve, F, [ZZ], curve.dbl_form)
        w = F.add(aZZ, F.add(XX, F.add(XX, XX)))
        ss, R, ww = _mulsb(F, [s, Y1, w], [s, s, w])
        XR = F.add(X1, R)
        sss, RR, XR2 = _mulsb(F, [s, R, XR], [ss, R, XR])
        B = F.sub(F.sub(XR2, XX), RR)
        h = F.sub(ww, F.double(B))
        X3, Y3w = _mulsb(F, [h, w], [s, F.sub(B, h)])
        Y3 = F.sub(Y3w, F.double(RR))
        ident = torch.logical_and(F.is_zero(X1), F.is_zero(Z1))
        P = tuple(F.select(ident, i, o) for i, o in zip(P, (X3, Y3, sss)))
    return P


def _launcher(stem: str, symbol: str, argtypes):
    from . import _build

    fn = getattr(_build.load(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _flat_inputs(curve, coords):
    """Broadcast the coordinate tensors to one shape and flatten each to
    contiguous (deg * 24, n) rows for the kernel."""
    F = curve.F
    k = F.elem_ndim
    for t in coords:
        check_words(t, F.device, f"{curve.name} coordinate")
        if t.shape[:k] != curve.elem_shape:
            raise ValueError(f"{curve.name}: coordinate shape {tuple(t.shape)} does not "
                             f"start with {curve.elem_shape}")
    shape = torch.broadcast_shapes(*(t.shape for t in coords))
    rows = curve.deg * 24
    return shape, [t.expand(shape).contiguous().view(rows, -1) for t in coords]


def _launch(curve, name: str, stem: str, symbol: str, coords, args, argtypes, k=None):
    """Launch ``symbol`` of ``csrc/<stem>.cu`` on the coordinates (then the
    outputs, the lanes, ``args`` and the stream) and count it under
    ``name``, with its lanes n, or (n, k) for a launch of k doublings.
    Returns the output triple."""
    shape, flat = _flat_inputs(curve, coords)
    n = flat[0].shape[1]
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    if n:
        ptr = ctypes.c_void_p
        fn = _launcher(stem, symbol, [ptr] * (len(flat) + 3) + [ctypes.c_long, *argtypes, ptr])
        rc = fn(*(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs), n, *args,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc}")
        launches[name] += 1
        launch_lanes[name][n if k is None else (n, k)] += 1
    return tuple(t.view(shape) for t in outs)


def _device_type(curve, P) -> str:
    kind = P[0].device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"{curve.name}: no kernel for device {P[0].device}")
    return kind


def ec_add(curve, P, Q):
    """P + Q.  CUDA tensors: the kernel, or an exception."""
    if _device_type(curve, P) == "cpu":
        return ec_add_plain(curve, P, Q)
    if op_counts.active() is not None:
        _count_kernel(curve, "add", _points(curve, P, Q))
    return _launch(curve, f"ec_add_{curve.kernel_field}", "ec_add",
                   f"{add_kernel(curve).launcher}_launch", (*P, *Q),
                   [curve.kconst.data_ptr()], [ctypes.c_void_p])


def ec_dbl(curve, P, times: int = 1):
    """2^times P.  CUDA tensors: one launch of the kernel, or an exception."""
    if times < 1:
        raise ValueError(f"{curve.name}: times must be at least 1, got {times}")
    if _device_type(curve, P) == "cpu":
        return ec_dbl_plain(curve, P, times)
    if op_counts.active() is not None:
        _count_kernel(curve, "dbl", _points(curve, P) * times)
    return _launch(curve, f"ec_dbl_{curve.kernel_field}", "ec_dbl",
                   f"{dbl_kernel(curve).launcher}_launch", tuple(P), [times], [ctypes.c_int],
                   k=times)
