"""Short-Weierstrass group law on batches of projective points.

A point batch is a triple (X, Y, Z) of coordinate-field tensors
(``ops.field.Fp`` for G1, ``ops.towers.Fp2`` or ``Fp3`` for G2).  The identity is
(0, 1, 0).  ``add`` and ``double`` go through ``ops.cuda_group``: one fused
CUDA kernel launch for CUDA tensors (``double(P, times)`` makes all its
doublings in one), the plain version for CPU tensors; both record the group
operation and its field operations in an active ``utils/op_counts`` scope.
"""

from __future__ import annotations

import torch

from .cuda_group import AddKernel, DblKernel, ec_add, ec_dbl
from .field import resolve_device


class Curve:
    """y^2 z = x^3 + a x z^2 + b z^3 over the field object F; a and b are
    Montgomery-form constants of one element's shape, on F's device."""

    def __init__(self, F, coeff_a: torch.Tensor, coeff_b: torch.Tensor, device, name: str = "Curve",
                 add_kernel: AddKernel | None = None, dbl_kernel: DblKernel | None = None):
        if resolve_device(device) != F.device:
            raise ValueError(f"{name}: field on {F.device}, curve asked for {device}")
        self.F = F
        self.name = name
        self.device = F.device
        self.a = coeff_a.to(self.device)
        self.b = coeff_b.to(self.device)
        self.b3 = F.add(self.b, F.double(self.b))  # 3b, used by the complete addition
        base = getattr(F, "base", F)
        self.deg = getattr(F, "deg", 1)
        self.elem_shape = tuple(self.a.shape)
        self.kernel_field = "fp" if self.deg == 1 else f"fp{self.deg}"
        blocks = [base.kconst, self.a.reshape(-1), self.b3.reshape(-1)]
        if self.deg > 1:  # 3b times the non-residue, which the sparse 3b of a twist needs
            self.nr_b3 = torch.stack([base.mul_small(c, F.nr) for c in self.b3])
            blocks.append(self.nr_b3.reshape(-1))
        # constants block of the CUDA kernels: the base field's (p, n0),
        # then a, 3b and NR 3b, component after component; ec_add.cu reads
        # 3b and NR 3b, and no kernel reads a (each has its a built in)
        self.kconst = torch.cat(blocks)
        # the addition and doubling kernels compiled for this curve, or None
        if add_kernel is not None:
            self._check_add_kernel(add_kernel)
        if dbl_kernel is not None and not self._a_is(dbl_kernel.a_k, dbl_kernel.a_s):
            raise ValueError(f"{self.name}: a is not a = {dbl_kernel.a_k} u^{dbl_kernel.a_s}, "
                             f"which {dbl_kernel.launcher} has built in")
        self.add_form = add_kernel
        self.dbl_form = dbl_kernel

    def _components(self, t):
        return [t] if self.deg == 1 else list(t)

    def _a_is(self, a_k: int, a_s: int) -> bool:
        """a = a_k u^a_s (u the extension's generator, u^0 = 1)."""
        base, d = getattr(self.F, "base", self.F), self.deg
        want = [base.const(a_k if i == a_s else 0) for i in range(d)]
        return 0 <= a_s < d and all(torch.equal(x, y) for x, y in zip(self._components(self.a), want))

    def _check_add_kernel(self, k: AddKernel):
        """The kernel has a = a_k u^a_s and 3b = c u^b3_s built in: refuse
        it for a curve whose constants are not of that form."""
        base, d = getattr(self.F, "base", self.F), self.deg
        b3_zero = [bool(base.is_zero(c)) for c in self._components(self.b3)]
        b3_fits = 0 <= k.b3_s < d and b3_zero == [i != k.b3_s for i in range(d)]
        if not (self._a_is(k.a_k, k.a_s) and b3_fits):
            raise ValueError(f"{self.name}: a and 3b are not a = {k.a_k} u^{k.a_s} and "
                             f"3b = c u^{k.b3_s}, which {k.launcher} has built in")

    # ---- constructors ---------------------------------------------------
    def zero(self, batch_shape=()):
        F = self.F
        return (F.zeros(batch_shape), F.ones(batch_shape), F.zeros(batch_shape))

    def from_affine(self, x, y):
        """(x, y) -> projective with Z = 1; y == 0 encodes the identity
        (the wire format's convention, libsnark/serialization.hpp:84-92)."""
        F = self.F
        batch = x.shape[F.elem_ndim:]
        ident = F.is_zero(y)
        ox, oy, oz = self.zero(batch)
        return (F.select(ident, ox, x), F.select(ident, oy, y), F.select(ident, oz, oy))

    def to_affine(self, P):
        """Projective -> (x, y, 1) by one batch inversion of Z along the last
        axis (one ``inv`` for a single point); the identity -> (0, 1, 0)
        (to_affine_coordinates, mnt4753_g1.cpp:68-83; batch_to_special,
        multiexp.tcc:684)."""
        F = self.F
        X, Y, Z = P
        ident = self.is_zero(P)
        batch = ident.shape
        Zi = F.batch_inv(Z) if batch else F.inv(Z)
        k = F.elem_ndim  # x and y in one product: stacked on a new axis after the element's
        x, y = F.mul(torch.stack([X, Y], dim=k), Zi.unsqueeze(k)).unbind(dim=k)
        zero, one = F.zeros(batch), F.ones(batch)
        return (F.select(ident, zero, x), F.select(ident, one, y), F.select(ident, zero, one))

    def is_zero(self, P):
        return torch.logical_and(self.F.is_zero(P[0]), self.F.is_zero(P[2]))

    def select(self, mask, P, Q):
        return tuple(self.F.select(mask, p, q) for p, q in zip(P, Q))

    # ---- group law -------------------------------------------------------
    def neg(self, P):
        return (P[0], self.F.neg(P[1]), P[2])

    def add(self, P, Q):
        return ec_add(self, P, Q)

    def double(self, P, times: int = 1):
        """2^times P, in one kernel launch for CUDA tensors."""
        return ec_dbl(self, P, times)
