"""Extension fields over a 753-bit base field: Fq2 = Fq[u] / (u^2 - nr)
and Fq3 = Fq[u] / (u^3 - nr).

Element layout: the component axis leads the base field's word axis, so a
vector of N elements is ``int32[deg, 24, N]``.  The non-residue is small
(13 for MNT4753's Fq2, 11 for MNT6753's Fq3), so multiplying by it is a
small-integer scaling instead of a Montgomery product.  Fq2 multiplies by
3-product Karatsuba (libff fp2.tcc:81-104) and squares by the complex
method (fp2.tcc:106-135); Fq3 multiplies by the 6-product schedule of
fp3.tcc.  The independent base-field products of one call are stacked
into a single batched ``Fp.mul``.  Inversion goes through the norm to the
base field (fp2.tcc:137-153, fp3.tcc invert), whose ``inv`` / ``batch_inv``
do the one exponentiation.
"""

from __future__ import annotations

import torch

from .field import Fp


class _Ext:
    """What the extensions share: components stacked on axis 0, the
    componentwise ring operations, predicates and constructors."""

    deg: int
    elem_ndim = 2  # leading axes of one element: (deg, 24)

    def __init__(self, base: Fp, non_residue: int, name: str | None = None):
        self.base = base
        self.nr = non_residue
        self.name = name or type(self).__name__
        self.device = base.device

    def plain(self):
        """The same field over the base field's plain version."""
        return type(self)(self.base.plain(), self.nr, self.name)

    def _componentwise(self, fn, *xs):
        # base-field code wants the word axis first: swap it with the
        # component axis (views), run once over all components, swap back
        return fn(*(x.transpose(0, 1) for x in xs)).transpose(0, 1)

    def _stacked_mul(self, xs, ys):
        """[x_i * y_i] through one batched base-field product."""
        V = self.base.mul(torch.stack(xs, dim=1), torch.stack(ys, dim=1))
        return V.unbind(dim=1)

    # ---- constructors -------------------------------------------------
    def zeros(self, batch_shape):
        return torch.zeros((self.deg, 24) + tuple(batch_shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, batch_shape):
        zero = self.base.zeros(batch_shape)
        return torch.stack([self.base.ones(batch_shape)] + [zero] * (self.deg - 1))

    # ---- ring ops -------------------------------------------------------
    def add(self, a, b):
        return self._componentwise(self.base.add, a, b)

    def sub(self, a, b):
        return self._componentwise(self.base.sub, a, b)

    def neg(self, a):
        return self._componentwise(self.base.neg, a)

    def double(self, a):
        return self.add(a, a)

    def mul_nr(self, x):
        """A base-field element times the non-residue."""
        return self.base.mul_small(x, self.nr)

    def mul_base(self, a, s):
        """a times a base-field element s (broadcast over the components),
        one batched base product."""
        return torch.stack(self._stacked_mul(list(a), [s] * self.deg))

    def inv(self, a):
        """a^-1 = c / norm(a), where ``_adjugate`` gives the components c
        with a * c = norm(a) in the base field; 0 maps to 0."""
        c, norm = self._adjugate(a)
        return self.mul_base(torch.stack(c), self.base.inv(norm))

    def batch_inv(self, a):
        """Elementwise inverse along the last axis: the norms through the
        base field's product tree; zero lanes map to zero."""
        c, norm = self._adjugate(a)
        return self.mul_base(torch.stack(c), self.base.batch_inv(norm))

    # ---- predicates -----------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask[None, None], a, b)


class Fp2(_Ext):
    deg = 2

    def mul(self, a, b):
        F = self.base
        v0, v1, t = self._stacked_mul(
            [a[0], a[1], F.add(a[0], a[1])],
            [b[0], b[1], F.add(b[0], b[1])],
        )
        c0 = F.add(v0, self.mul_nr(v1))
        c1 = F.sub(F.sub(t, v0), v1)
        return torch.stack([c0, c1])

    def sqr(self, a):
        F = self.base
        t0 = F.add(a[0], a[1])
        t1 = F.add(a[0], self.mul_nr(a[1]))
        v, w = self._stacked_mul([a[0], t0], [a[1], t1])
        c0 = F.sub(F.sub(w, v), self.mul_nr(v))
        c1 = F.double(v)
        return torch.stack([c0, c1])

    def _adjugate(self, a):
        # (a0 - a1 u)(a0 + a1 u) = a0^2 - nr a1^2
        F = self.base
        s0, s1 = self._stacked_mul([a[0], a[1]], [a[0], a[1]])
        return [a[0], F.neg(a[1])], F.sub(s0, self.mul_nr(s1))


class Fp3(_Ext):
    deg = 3

    def mul(self, a, b):
        F = self.base
        v0, v1, v2, t01, t02, t12 = self._stacked_mul(
            [a[0], a[1], a[2], F.add(a[0], a[1]), F.add(a[0], a[2]), F.add(a[1], a[2])],
            [b[0], b[1], b[2], F.add(b[0], b[1]), F.add(b[0], b[2]), F.add(b[1], b[2])],
        )
        c0 = F.add(v0, self.mul_nr(F.sub(F.sub(t12, v1), v2)))
        c1 = F.add(F.sub(F.sub(t01, v0), v1), self.mul_nr(v2))
        c2 = F.add(F.sub(F.sub(t02, v0), v2), v1)
        return torch.stack([c0, c1, c2])

    def sqr(self, a):
        return self.mul(a, a)

    def _adjugate(self, a):
        # the classical cubic formula (fp3.tcc invert): c0 = a0^2 - nr a1 a2,
        # c1 = nr a2^2 - a0 a1, c2 = a1^2 - a0 a2, norm = a0 c0 + nr (a2 c1 + a1 c2)
        F = self.base
        t0, t1, t2, t3, t4, t5 = self._stacked_mul(
            [a[0], a[1], a[2], a[0], a[0], a[1]], [a[0], a[1], a[2], a[1], a[2], a[2]])
        c = [F.sub(t0, self.mul_nr(t5)), F.sub(self.mul_nr(t2), t3), F.sub(t1, t4)]
        n0, n1, n2 = self._stacked_mul([a[0], a[2], a[1]], c)
        return c, F.add(n0, self.mul_nr(F.add(n1, n2)))
