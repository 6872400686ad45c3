"""Montgomery multiplication: the CUDA kernel's wrapper and its plain version.

Counterpart of ``ops/pallas_field.py`` in the JAX package.  ``mont_mul``
computes a * b * 2^-768 mod p, canonical, elementwise over ``(24, *batch)``
int32 word tensors (``ops/limbs.py``).  For a CUDA tensor it launches the
hand-written kernel of ``csrc/mont_mul.cu`` or raises; for a CPU tensor it
calls ``mont_mul_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import limbs as lb

# launches of the CUDA kernel, keyed by kernel name; incremented only where
# the kernel is launched
launches: collections.Counter = collections.Counter()
# lanes (elements or points) of each of those launches: name -> {n: launches
# at n}; for the doublings name -> {(n, k): launches}, k doublings a launch
launch_lanes: collections.defaultdict = collections.defaultdict(collections.Counter)

# elements per pass of the plain version: on the CPU the operands of a pass
# stay in cache; on the card a pass must be wide enough to fill it
_PLAIN_CHUNK = {"cpu": 2048, "cuda": 1 << 16}


def _mont_mul_chunk(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Widened words (24, n) x (24, n) -> widened canonical words (24, n)."""
    K = lb.N_LIMBS24
    t = lb.mul_columns24(lb.words_to_limbs24(a), lb.words_to_limbs24(b))  # 64 limbs, < p^2
    t = lb.carry_pass24(t, 3)
    # m = (t mod R) * n' mod R: limbs <= 2^24 on both sides, columns < 2^53
    m = lb.carry_pass24((F.nprime_mat @ t[:K].double()).long(), 3)
    # u = t + m * p; its low half is k * R for a small k (the carry into the high half)
    u = t + (F.p_mat @ m.double()).long()
    k = torch.round(F.low_weights @ u[:K].double()).long()
    hi = u[K:]
    hi[0] += k
    words = lb.normalize(lb.limbs24_to_words(lb.carry_pass24(hi, 2)))  # < 2p
    return lb.cond_sub(words, F.p_wide)


def mont_mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Montgomery product on any device: schoolbook product
    of 24-bit limbs, m = (t mod R) n' mod R, u = (t + m p) / R, one
    conditional subtract; the two products by constants are exact float64
    matrix products.  Operands broadcast over their batch dims."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    A = lb.widen(a.expand(shape)).reshape(lb.N_WORDS, -1)
    B = lb.widen(b.expand(shape)).reshape(lb.N_WORDS, -1)
    n = A.shape[1]
    chunk = _PLAIN_CHUNK.get(A.device.type, 2048)
    outs = [
        _mont_mul_chunk(F, A[:, i : i + chunk], B[:, i : i + chunk])
        for i in range(0, n, chunk)
    ]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return lb.narrow(out).reshape(shape)


def _lib():
    from . import _build

    lib = _build.load("mont_mul")
    fn = lib.mont_mul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_words(x: torch.Tensor, device: torch.device, what: str):
    if x.device != device:
        raise ValueError(f"{what}: tensor on {x.device}, field on {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {x.dtype}")


def mont_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-768 mod p.  CUDA tensors: the kernel, or an exception."""
    check_words(a, F.device, "mont_mul a")
    check_words(b, F.device, "mont_mul b")
    if a.shape[0] != lb.N_WORDS or b.shape[0] != lb.N_WORDS:
        raise ValueError("mont_mul: the leading axis must hold 24 words")
    if a.device.type == "cpu":
        return mont_mul_plain(F, a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"mont_mul: no kernel for device {a.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.shape != shape:
        a, b = b, a  # the product commutes: keep the full-size operand first
    A = a.expand(shape).contiguous().view(lb.N_WORDS, -1)
    n = A.shape[1]
    if b.numel() == lb.N_WORDS:
        Bm, bn = b.contiguous().view(lb.N_WORDS), 1  # one constant for every element
    else:
        Bm, bn = b.expand(shape).contiguous().view(lb.N_WORDS, -1), n
    out = torch.empty_like(A)
    if n:
        rc = _lib()(A.data_ptr(), Bm.data_ptr(), out.data_ptr(), n, bn,
                    F.kconst.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
        launches["mont_mul"] += 1
        launch_lanes["mont_mul"][n] += 1
    return out.view(shape)
