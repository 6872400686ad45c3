"""Curve-operation gadgets: G1/G2 affine add, double, on-curve checks.

Counterpart of the JAX package's ``gadgets/curve_gadgets.py``, on the
port's protoboard and ``host/curves.py``.

Capability parity with gadgetlib1's curve gadgets
(libsnark/gadgetlib1/gadgets/curves/weierstrass_g1_gadget.hpp and
weierstrass_g2_gadget.hpp — the layer under the pairing-verification
gadgets used for recursive composition).  Affine incomplete formulas
with an explicit slope witness, exactly the reference's constraint
shape (G1_add_gadget: 3 constraints; G1_dbl_gadget: 4 with the x^2
helper; G1_checker_gadget: 2):

  add:    lambda*(x2 - x1) = y2 - y1
          lambda*lambda    = x1 + x2 + x3
          lambda*(x1 - x3) = y1 + y3
  double: xx = x1 * x1
          lambda*(2 y1)    = 3 xx + a
          lambda*lambda    = 2 x1 + x3
          lambda*(x1 - x3) = y1 + y3
  check:  xx = x * x ;  y*y = x*xx + a*x + b

Incomplete means the caller must not feed P == +-Q to add (the
reference gadgets carry the same precondition); the prover-side
framework uses branch-free complete formulas (ops/group.py) — these
gadgets express VERIFICATION circuits, where the reference makes the
same trade.

G2 variants run the identical schedules with every product expanded
through the extension-field mul gadgets (field_ext_gadgets), giving
3 products per Fp2 mul / 6 per Fp3 mul — the same budget as
fp2_gadgets-based G2 gadgets in the reference.
"""

from __future__ import annotations

from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .field_ext_gadgets import (
    ExtVariable,
    _ext_mul_gadget,
    _lc,
)
from .protoboard import Gadget, Protoboard


class G1AddGadget(Gadget):
    """(x1,y1) + (x2,y2) = (x3,y3), P != +-Q (weierstrass_g1_gadget.tcc
    G1_add_gadget)."""

    def __init__(self, pb: Protoboard, p1, p2, result, annotation="g1add"):
        super().__init__(pb, annotation)
        self.p1, self.p2, self.result = p1, p2, result
        self.lam = pb.allocate_var(f"{annotation}.lambda")

    def generate_r1cs_constraints(self):
        (x1, y1), (x2, y2), (x3, y3) = self.p1, self.p2, self.result
        lam = self.lam
        self.pb.add_r1cs_constraint(
            R1CSConstraint(lam.lc(), _lc(x2) - _lc(x1), _lc(y2) - _lc(y1)),
            f"{self.annotation}.slope",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(lam.lc(), lam.lc(), _lc(x1) + _lc(x2) + _lc(x3)),
            f"{self.annotation}.x3",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(lam.lc(), _lc(x1) - _lc(x3), _lc(y1) + _lc(y3)),
            f"{self.annotation}.y3",
        )

    def generate_r1cs_witness(self):
        pb = self.pb
        p = pb.p
        (x1v, y1v), (x2v, y2v) = (
            (pb.lc_val(_lc(c)) for c in pt) for pt in (self.p1, self.p2)
        )
        lam = (y2v - y1v) * pow(x2v - x1v, -1, p) % p
        x3 = (lam * lam - x1v - x2v) % p
        y3 = (lam * (x1v - x3) - y1v) % p
        pb.set_val(self.lam, lam)
        xr, yr = self.result
        pb.set_val(xr, x3)
        pb.set_val(yr, y3)


class G1DoubleGadget(Gadget):
    """2 * (x1,y1) = (x3,y3), y1 != 0 (G1_dbl_gadget)."""

    def __init__(self, pb: Protoboard, a_coeff: int, p1, result,
                 annotation="g1dbl"):
        super().__init__(pb, annotation)
        self.a_coeff = a_coeff
        self.p1, self.result = p1, result
        self.xx = pb.allocate_var(f"{annotation}.xx")
        self.lam = pb.allocate_var(f"{annotation}.lambda")

    def generate_r1cs_constraints(self):
        (x1, y1), (x3, y3) = self.p1, self.result
        lam, xx = self.lam, self.xx
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_lc(x1), _lc(x1), xx.lc()),
            f"{self.annotation}.xx",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                lam.lc(), 2 * _lc(y1), 3 * xx.lc() + LC.constant(self.a_coeff)
            ),
            f"{self.annotation}.slope",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(lam.lc(), lam.lc(), 2 * _lc(x1) + _lc(x3)),
            f"{self.annotation}.x3",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(lam.lc(), _lc(x1) - _lc(x3), _lc(y1) + _lc(y3)),
            f"{self.annotation}.y3",
        )

    def generate_r1cs_witness(self):
        pb = self.pb
        p = pb.p
        x1v, y1v = (pb.lc_val(_lc(c)) for c in self.p1)
        pb.set_val(self.xx, x1v * x1v % p)
        lam = (3 * x1v * x1v + self.a_coeff) * pow(2 * y1v, -1, p) % p
        x3 = (lam * lam - 2 * x1v) % p
        y3 = (lam * (x1v - x3) - y1v) % p
        pb.set_val(self.lam, lam)
        xr, yr = self.result
        pb.set_val(xr, x3)
        pb.set_val(yr, y3)


class G1CheckerGadget(Gadget):
    """On-curve check y^2 = x^3 + a x + b (G1_checker_gadget): two
    product helpers then the curve row —
      xx = x * x ;  t = x * (xx + a) ;  y * y = t + b."""

    def __init__(self, pb: Protoboard, a_coeff: int, b_coeff: int, pt,
                 annotation="g1chk"):
        super().__init__(pb, annotation)
        self.a_coeff, self.b_coeff = a_coeff, b_coeff
        self.pt = pt
        self.xx = pb.allocate_var(f"{annotation}.xx")
        self.t = pb.allocate_var(f"{annotation}.t")

    def generate_r1cs_constraints(self):
        x, y = self.pt
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_lc(x), _lc(x), self.xx.lc()),
            f"{self.annotation}.xx",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                _lc(x), self.xx.lc() + LC.constant(self.a_coeff), self.t.lc()
            ),
            f"{self.annotation}.t",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                _lc(y), _lc(y), self.t.lc() + LC.constant(self.b_coeff)
            ),
            f"{self.annotation}.curve",
        )

    def generate_r1cs_witness(self):
        pb = self.pb
        p = pb.p
        x, _ = self.pt
        xv = pb.lc_val(_lc(x))
        pb.set_val(self.xx, xv * xv % p)
        pb.set_val(self.t, xv * (xv * xv + self.a_coeff) % p)


# ---------------------------------------------------------------------------
# G2 variants over an extension field
# ---------------------------------------------------------------------------

class G2AddGadget(Gadget):
    """Same schedule as G1AddGadget with coordinates in Fp2/Fp3; each
    product runs through the extension mul gadgets
    (weierstrass_g2_gadget.tcc)."""

    def __init__(self, pb: Protoboard, deg: int, nr: int, p1, p2, result,
                 annotation="g2add"):
        super().__init__(pb, annotation)
        self.deg, self.nr = deg, nr
        self.p1, self.p2, self.result = p1, p2, result
        x1, y1 = p1
        x2, y2 = p2
        x3, y3 = result
        self.lam = ExtVariable.allocate(pb, deg, f"{annotation}.lambda")
        sub = lambda u, v: ExtVariable(
            [cu - cv for cu, cv in zip(u.comps, v.comps)]
        )
        add = lambda u, v: ExtVariable(
            [cu + cv for cu, cv in zip(u.comps, v.comps)]
        )
        # lambda * (x2 - x1) = y2 - y1
        self.m1 = _ext_mul_gadget(
            pb, deg, nr, self.lam, sub(x2, x1), sub(y2, y1),
            f"{annotation}.m1",
        )
        # lambda^2 = x1 + x2 + x3
        self.m2 = _ext_mul_gadget(
            pb, deg, nr, self.lam, self.lam, add(add(x1, x2), x3),
            f"{annotation}.m2",
        )
        # lambda * (x1 - x3) = y1 + y3
        self.m3 = _ext_mul_gadget(
            pb, deg, nr, self.lam, sub(x1, x3), add(y1, y3),
            f"{annotation}.m3",
        )

    def generate_r1cs_constraints(self):
        for m in (self.m1, self.m2, self.m3):
            m.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        from ..host.curves import HostExt

        pb = self.pb
        p = pb.p
        F = HostExt(p, self.deg, self.nr)
        x1, y1 = (pt.values(pb) for pt in self.p1)
        x2, y2 = (pt.values(pb) for pt in self.p2)
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        self.lam.set(pb, lam)
        self.result[0].set(pb, x3)
        self.result[1].set(pb, y3)
        # fill the product wires of the three ext muls
        for m in (self.m1, self.m2, self.m3):
            m._witness_products(p)


class G2CheckerGadget(Gadget):
    """On-curve check over the extension: y^2 = x^3 + a x + b with a, b
    extension constants (G2_checker_gadget)."""

    def __init__(self, pb: Protoboard, deg: int, nr: int, a2, b2, pt,
                 annotation="g2chk"):
        super().__init__(pb, annotation)
        self.deg, self.nr = deg, nr
        self.a2, self.b2 = a2, b2  # component tuples
        self.pt = pt
        x, y = pt
        self.xx = ExtVariable.allocate(pb, deg, f"{annotation}.xx")
        self.xxx = ExtVariable.allocate(pb, deg, f"{annotation}.xxx")
        self.yy = ExtVariable.allocate(pb, deg, f"{annotation}.yy")
        self.m1 = _ext_mul_gadget(pb, deg, nr, x, x, self.xx, f"{annotation}.m1")
        self.m2 = _ext_mul_gadget(
            pb, deg, nr, self.xx, x, self.xxx, f"{annotation}.m2"
        )
        self.m3 = _ext_mul_gadget(pb, deg, nr, y, y, self.yy, f"{annotation}.m3")

    def generate_r1cs_constraints(self):
        from .field_ext_gadgets import ext_const_mul_lc

        self.m1.generate_r1cs_constraints()
        self.m2.generate_r1cs_constraints()
        self.m3.generate_r1cs_constraints()
        x, _ = self.pt
        # yy = xxx + a (x) x + b — the a*x extension product is linear
        # in x's components (constant matrix), b adds componentwise
        ax = ext_const_mul_lc(self.deg, self.nr, self.a2, x)
        for yy_c, xxx_c, ax_c, b_c in zip(
            self.yy.comps, self.xxx.comps, ax, self.b2
        ):
            self.pb.add_r1cs_constraint(
                R1CSConstraint(
                    LC.constant(1),
                    xxx_c + ax_c + LC.constant(b_c),
                    yy_c,
                ),
                f"{self.annotation}.curve",
            )

    def generate_r1cs_witness(self):
        from ..host.curves import HostExt

        pb = self.pb
        p = pb.p
        F = HostExt(p, self.deg, self.nr)
        x, y = (c.values(pb) for c in self.pt)
        self.xx.set(pb, F.sqr(x))
        self.xxx.set(pb, F.mul(F.sqr(x), x))
        self.yy.set(pb, F.sqr(y))
        for m in (self.m1, self.m2, self.m3):
            m._witness_products(p)
