"""Extension fields over a 753-bit base field: Fq2 = Fq[u] / (u^2 - nr)
and Fq3 = Fq[u] / (u^3 - nr), and the pairing targets over them, Fq4 =
Fq2[v] / (v^2 - u) (MNT4753's GT) and Fq6 = Fq3[v] / (v^2 - u) (MNT6753's).

Counterpart of the JAX package's ``ops/towers.py``.  Element layout: the
component axes lead the base field's word axis, so a vector of N elements
is ``int32[deg, 24, N]``, and ``int32[2, 2, 24, N]`` / ``int32[2, 3, 24,
N]`` for Fq4 / Fq6.  The non-residue is small
(13 for MNT4753's Fq2, 11 for MNT6753's Fq3), so multiplying by it is a
small-integer scaling instead of a Montgomery product.  Fq2 multiplies by
3-product Karatsuba (libff fp2.tcc:81-104) and squares by the complex
method (fp2.tcc:106-135); Fq3 multiplies by the 6-product schedule of
fp3.tcc.  The independent base-field products of one call are stacked
into a single batched ``Fp.mul``.  Inversion goes through the norm to the
base field (fp2.tcc:137-153, fp3.tcc invert), whose ``inv`` / ``batch_inv``
do the one exponentiation.  Fq4 and Fq6 take Fq2's quadratic formulas over
their base extension (fp4.tcc, fp6_2over3.tcc), with the non-residue v^2 =
u acting by a rotation of the components; their independent products
stack through both levels into one ``Fp.mul``.  The Frobenius maps scale
components by the exact constants of ``ops/frobenius.py``, one batched
constant product each; ``unitary_inverse`` is the conjugation v -> -v.
"""

from __future__ import annotations

import torch

from . import frobenius
from .field import Fp


class _Ext:
    """What the extensions share: components stacked on axis 0 (over the
    base's own axes when the base is itself an extension), the
    componentwise ring operations, predicates, constructors, powers and the
    Frobenius constants."""

    deg: int

    def __init__(self, base, non_residue: int, name: str | None = None):
        self.base = base
        self.nr = non_residue
        self.name = name or type(self).__name__
        self.device = base.device
        # leading axes of one element: (deg, 24), (2, deg', 24) over an extension
        self.elem_ndim = base.elem_ndim + 1

    def plain(self):
        """The same field over the base field's plain version."""
        return type(self)(self.base.plain(), self.nr, self.name)

    @property
    def prime_field(self) -> Fp:
        """The bottom Fp of the tower."""
        f = self.base
        while isinstance(f, _Ext):
            f = f.base
        return f

    def _componentwise(self, fn, *xs):
        # prime-field code wants the word axis first: fold the component
        # axes into one, swap it with the word axis (views), run once over
        # all components, swap back and unfold
        lead = xs[0].shape[: self.elem_ndim - 1]
        flat = [x.reshape((-1,) + x.shape[self.elem_ndim - 1:]).transpose(0, 1) for x in xs]
        out = fn(*flat).transpose(0, 1)
        return out.reshape(lead + out.shape[1:])

    def _stacked_mul(self, xs, ys):
        """[x_i * y_i] through one batched base product (over an extension
        base, its own products stack too: one ``Fp.mul`` in all)."""
        k = self.base.elem_ndim
        V = self.base.mul(torch.stack(xs, dim=k), torch.stack(ys, dim=k))
        return V.unbind(dim=k)

    # ---- constructors -------------------------------------------------
    def zeros(self, batch_shape):
        return torch.zeros((self.deg,) + tuple(self.base.zeros(batch_shape).shape),
                           dtype=torch.int32, device=self.device)

    def ones(self, batch_shape):
        zero = self.base.zeros(batch_shape)
        return torch.stack([self.base.ones(batch_shape)] + [zero] * (self.deg - 1))

    # ---- ring ops -------------------------------------------------------
    def add(self, a, b):
        return self._componentwise(self.prime_field.add, a, b)

    def sub(self, a, b):
        return self._componentwise(self.prime_field.sub, a, b)

    def neg(self, a):
        return self._componentwise(self.prime_field.neg, a)

    def double(self, a):
        return self.add(a, a)

    def mul_nr(self, x):
        """A base-field element times the non-residue."""
        return self.base.mul_small(x, self.nr)

    def mul_base(self, a, s):
        """a times a base-field element s (broadcast over the components),
        one batched base product."""
        return torch.stack(self._stacked_mul(list(a), [s] * self.deg))

    def scale_prime_const(self, a, c):
        """Every (nested) component times a prime-field Montgomery constant
        c of shape (24,): one batched constant product."""
        F = self.prime_field
        return self._componentwise(lambda x: F.mul_const(x, c), a)

    def _frob_const(self, c_int: int):
        """A Frobenius coefficient as a prime-field Montgomery constant."""
        return self.prime_field.const(c_int)

    pow_int = Fp.pow_int  # square and multiply over the extension's mul / sqr

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
        return (a == 0).flatten(0, self.elem_ndim - 1).all(dim=0)

    def eq(self, a, b):
        return (a == b).flatten(0, self.elem_ndim - 1).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask[(None,) * self.elem_ndim], a, b)


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

    def frobenius_map(self, a, power: int):
        """x -> x^(q^power) (fp2.tcc Frobenius_map): c1 times nr^((q - 1) / 2)
        = -1 when power is odd."""
        c = frobenius.fq2_frobenius_coeffs_c1(self.base.p, self.nr)[power % 2]
        if c == 1:
            return a
        return torch.stack([a[0], self.base.mul_const(a[1], self._frob_const(c))])


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

    def frobenius_map(self, a, power: int):
        """x -> x^(q^power) (fp3.tcc Frobenius_map): component m times
        coeffs_c{m}[power % 3]."""
        F = self.base
        c1 = frobenius.fq3_frobenius_coeffs_c1(F.p, self.nr)[power % 3]
        c2 = frobenius.fq3_frobenius_coeffs_c2(F.p, self.nr)[power % 3]
        if c1 == 1 and c2 == 1:
            return a
        return torch.stack([a[0], F.mul_const(a[1], self._frob_const(c1)),
                            F.mul_const(a[2], self._frob_const(c2))])


class _GTTower(Fp2):
    """A quadratic tower E[v] / (v^2 - u) over E = Fq2 or Fq3: Fq2's
    Karatsuba and complex squaring over E, where multiplying by the
    non-residue v^2 = u rotates E's components and scales the top one by
    E's own non-residue."""

    def mul_nr(self, x):
        E = self.base
        return torch.stack([E.mul_nr(x[-1])] + list(x[:-1]))

    def frobenius_map(self, a, power: int):
        """(c0^(q^power), coeff c1^(q^power)) with coeff = nr^(power (q - 1)
        / (2 deg E)) (fp4.tcc / fp6_2over3.tcc Frobenius_map)."""
        E = self.base
        c = self._frobenius_coeffs(E.base.p, self.nr)[power % (2 * E.deg)]
        a0, a1 = E.frobenius_map(a[0], power), E.frobenius_map(a[1], power)
        if c != 1:
            a1 = E.scale_prime_const(a1, self._frob_const(c))
        return torch.stack([a0, a1])

    def unitary_inverse(self, a):
        """The conjugation v -> -v: the inverse on the norm-1 elements, where
        reduced pairing values live (fp4.hpp unitary_inverse)."""
        return torch.stack([a[0], self.base.neg(a[1])])


class Fp4(_GTTower):
    """Fq4 = Fq2[v] / (v^2 - u): MNT4753's GT (fp4.tcc)."""

    _frobenius_coeffs = staticmethod(frobenius.fq4_frobenius_coeffs_c1)


class Fp6_2over3(_GTTower):
    """Fq6 = Fq3[v] / (v^2 - u): MNT6753's GT (fp6_2over3.tcc)."""

    _frobenius_coeffs = staticmethod(frobenius.fq6_frobenius_coeffs_c1)
