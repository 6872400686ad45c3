"""Prime-field arithmetic on batches of Montgomery-form elements.

A batch is one ``torch.int32`` tensor of shape ``(24, *batch)`` on the
field's device (``ops/limbs.py``).  Addition, subtraction and the
predicates are plain tensor code; every multiplication goes through
``ops.cuda_field.mont_mul``, which launches the CUDA kernel for a CUDA
tensor and uses the plain version only for a CPU tensor.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..models.primes import PrimeSpec
from ..utils import op_counts
from ..utils.bigint import int_to_words, ints_to_words
from . import limbs as lb
from .cuda_field import mont_mul, mont_mul_plain


def resolve_device(device) -> torch.device:
    """A torch.device; asking for CUDA where there is no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the prover runs on the GPU by default; "
            "pass device='cpu' (CLI: --device cpu) for the plain CPU path"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # tensors report cuda:N
    return dev


def canonical_words(F: "Fp", values) -> torch.Tensor:
    """Canonical host integers -> their words (24, len) on F's device; the
    Montgomery form is one ``F.from_canonical`` away, on the device."""
    return torch.from_numpy(ints_to_words(values)).to(F.device)


class Fp:
    """One prime field bound to a modulus and a device."""

    elem_ndim = 1  # leading axes of one element: (24,)

    def __init__(self, spec: PrimeSpec, device, name: str = "Fp"):
        self.spec = spec
        self.p = spec.p
        self.name = name
        self.device = resolve_device(device)
        self.p_words = self._raw(spec.p)
        self.p_wide = lb.widen(self.p_words)
        # the plain Montgomery product's constants (24-bit limb matrices)
        self.nprime_mat = lb.toeplitz24(spec.n_prime, lb.N_LIMBS24, self.device)
        self.p_mat = lb.toeplitz24(spec.p, 2 * lb.N_LIMBS24, self.device)
        self.low_weights = torch.tensor(
            [2.0 ** (lb.LIMB24_BITS * (i - lb.N_LIMBS24)) for i in range(lb.N_LIMBS24)],
            dtype=torch.float64, device=self.device)
        self.mont_one = self._raw(spec.R % spec.p)
        self._raw_one = self._raw(1)
        self._r2 = self._raw(spec.R2)
        # constants block of the CUDA kernels: p, then n0 = -p^-1 mod 2^32
        kc = np.zeros(32, np.int32)
        kc[:24] = int_to_words(spec.p)
        kc[24:25] = int_to_words(spec.n_prime & 0xFFFFFFFF)[:1]
        self.kconst = torch.from_numpy(kc).to(self.device)
        self._mont_mul = mont_mul

    def plain(self) -> "Fp":
        """The same field with every product computed by the plain PyTorch
        version whatever the device (what the kernels are held against)."""
        F = copy.copy(self)
        F._mont_mul = mont_mul_plain
        return F

    def _raw(self, value: int) -> torch.Tensor:
        return torch.from_numpy(int_to_words(value)).to(self.device)

    # ---- constructors -------------------------------------------------
    def const(self, value: int) -> torch.Tensor:
        """Montgomery-form constant, shape (24,), from an integer value."""
        return self._raw(self.spec.to_mont(value))

    def zeros(self, batch_shape) -> torch.Tensor:
        return torch.zeros((lb.N_WORDS,) + tuple(batch_shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, batch_shape) -> torch.Tensor:
        shape = (lb.N_WORDS,) + tuple(batch_shape)
        return lb.bcast_const(self.mont_one, self.zeros(batch_shape)).expand(shape).contiguous()

    # ---- op counting (PROFILE_OP_COUNTS, fp.hpp:46-52) ----------------------
    def _count(self, key: str, *xs):
        """Record ``key`` once an element of the operands' broadcast batch."""
        shape = torch.broadcast_shapes(*(x.shape for x in xs))
        op_counts.record(f"{self.name}.{key}", math.prod(shape[1:]))

    # ---- ring ops -------------------------------------------------------
    def add(self, a, b):
        if op_counts.active() is not None:
            self._count("add", a, b)
        s, _ = lb.add_carry(lb.widen(a), lb.widen(b))  # < 2p < 2^754: no carry out
        return lb.narrow(lb.cond_sub(s, self.p_wide))

    def sub(self, a, b):
        if op_counts.active() is not None:
            self._count("sub", a, b)
        d, lt = lb.sub_borrow(lb.widen(a), lb.widen(b))
        dp, _ = lb.add_carry(d, lb.bcast_const(self.p_wide, d))  # wraps back into [0, p)
        return lb.narrow(torch.where(lt.unsqueeze(0), dp, d))

    def neg(self, a):
        aw = lb.widen(a)
        d, _ = lb.sub_borrow(lb.bcast_const(self.p_wide, aw).expand(aw.shape), aw)
        return lb.select(lb.is_zero(a), a, lb.narrow(d))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        if op_counts.active() is not None:
            self._count("mul", a, b)
        return self._mont_mul(self, a, b)

    def sqr(self, a):
        if op_counts.active() is not None:
            self._count("sqr", a)
        return self._mont_mul(self, a, a)

    def mul_const(self, a, c):
        """a * c for a (24,) Montgomery-form constant c (counted as a mul)."""
        if op_counts.active() is not None:
            self._count("mul", a)
        return self._mont_mul(self, a, lb.bcast_const(c, a))

    def mul_small(self, a, k: int):
        """a * k for a small integer k >= 1 (plain scaling, not a
        Montgomery product): used for extension-field non-residues."""
        t = lb.normalize(lb.widen(a) * k)  # < k p
        kk = 1
        while kk * 2 < k:
            kk *= 2
        while kk >= 1:
            t = lb.cond_sub(t, lb.widen(self._raw(kk * self.p)))
            kk //= 2
        return lb.narrow(t)

    # ---- predicates -----------------------------------------------------
    def is_zero(self, a):
        return lb.is_zero(a)

    def eq(self, a, b):
        return lb.eq(a, b)

    def select(self, mask, a, b):
        return lb.select(mask, a, b)

    # ---- exponentiation / inversion --------------------------------------
    def pow_int(self, a, e: int):
        """a^e for a Python-int exponent e >= 0: square and multiply,
        most significant bit first, every product a ``mul`` (the
        extensions reuse it over their own ``mul`` / ``sqr``)."""
        if e < 0:
            raise ValueError("pow_int takes an exponent >= 0")
        if e == 0:
            return self.ones(a.shape[self.elem_ndim:])
        out = a
        for bit in bin(e)[3:]:
            out = self.sqr(out)
            if bit == "1":
                out = self.mul(out, a)
        return out

    def inv(self, a):
        """a^-1 by Fermat, a^(p - 2), elementwise; 0 maps to 0 (counted as
        an inv and the exponentiation's products)."""
        if op_counts.active() is not None:
            self._count("inv", a)
        return self.pow_int(a, self.p - 2)

    def batch_inv(self, a):
        """Elementwise inverse along the last axis by a product tree (the
        libff batch_invert of multiexp.tcc:684, in log depth): pairwise
        products level by level up to one element, one ``inv`` of it, and
        back down, where the inverse of a pair's product times one member
        is the inverse of the other; about 2 N products in 2 log2(N) + 1
        launches and the inversion's.  Zero lanes map to zero."""
        zero = self.is_zero(a)
        x = self.select(zero, self.ones(a.shape[1:]), a)
        levels = []  # (padded level, its length before padding)
        while x.shape[-1] > 1:
            n = x.shape[-1]
            if n % 2:
                x = torch.cat([x, self.ones(x.shape[1:-1] + (1,))], dim=-1)
            levels.append((x, n))
            x = self.mul(x[..., 0::2], x[..., 1::2])
        inv = self.inv(x)
        for lv, n in reversed(levels):
            partner = torch.stack([lv[..., 1::2], lv[..., 0::2]], dim=-1)
            inv = self.mul(partner, inv.unsqueeze(-1)).flatten(-2)[..., :n]
        return self.select(zero, self.zeros(a.shape[1:]), inv)

    # ---- Montgomery conversions -------------------------------------------
    def to_canonical(self, a):
        """Montgomery form -> canonical residue words (a product with raw 1)."""
        return self.mul_const(a, self._raw_one)

    def from_canonical(self, a):
        """Canonical residue words -> Montgomery form (a product with R^2)."""
        return self.mul_const(a, self._r2)
