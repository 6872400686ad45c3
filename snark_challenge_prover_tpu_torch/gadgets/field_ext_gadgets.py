"""Extension-field arithmetic gadgets: Fp2 / Fp3 / Fp4 / Fp6 in R1CS.

Counterpart of the JAX package's ``gadgets/field_ext_gadgets.py``, on the
port's protoboard; gadgets allocate, constrain and fill in the same order.

Capability parity with gadgetlib1's field gadgets
(libsnark/gadgetlib1/gadgets/fields/{fp2,fp3,fp4,fp6}_gadgets.hpp) —
the building blocks of the curve/pairing-verification gadget stack that
Mina uses for recursive proof composition.  Each tower element is a
vector of linear combinations over protoboard wires; multiplication
gadgets introduce one witness wire per base-field product and one R1CS
constraint per product (R1CS constraints being exactly one
multiplication each):

  Fp2  mul: 3 products (Karatsuba), sqr: 2 (complex squaring)
  Fp3  mul: 6 products (3-way Karatsuba), sqr: 6
  Fp4 = Fp2[v]/(v^2 - u): 3 Fp2 muls = 9 products (MNT4753 GT tower)
  Fp6 = Fp3[v]/(v^2 - u): 3 Fp3 muls = 18 products (MNT6753 GT tower)

Inverse gadgets constrain a * a_inv = 1 through the same mul gadgets.
The formulas mirror ops/towers.py (the tensor towers), so gadget
witnesses can be cross-checked against host tower arithmetic; the
reference's constraint schedules differ in bookkeeping but match in
product counts (fp2_gadgets.tcc mul = 3 constraints, etc.).
"""

from __future__ import annotations

from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .protoboard import Gadget, PBVariable, Protoboard


def _lc(x) -> LC:
    if isinstance(x, LC):
        return x
    if isinstance(x, PBVariable):
        return x.lc()
    if isinstance(x, int):
        return LC.constant(x)
    raise TypeError(type(x))


class ExtVariable:
    """A degree-d tower element as d linear combinations."""

    __slots__ = ("comps",)

    def __init__(self, comps):
        self.comps = [_lc(c) for c in comps]

    @classmethod
    def allocate(cls, pb: Protoboard, deg: int, annotation=""):
        return cls([pb.allocate_var(f"{annotation}.c{i}") for i in range(deg)])

    @classmethod
    def constant(cls, vals):
        return cls([LC.constant(v) for v in vals])

    def values(self, pb: Protoboard):
        return tuple(pb.lc_val(c) for c in self.comps)

    def set(self, pb: Protoboard, vals):
        for c, v in zip(self.comps, vals):
            if len(c.terms) == 1 and c.terms[0][1] == 1 and c.terms[0][0] > 0:
                pb.set_val(PBVariable(c.terms[0][0]), v)
            # constants / derived LCs carry no assignable wire (e.g. the
            # fixed ONE result of an inverse-check multiplication)


class _ProductBank(Gadget):
    """Shared machinery: allocate product wires t_k = A_k * B_k with one
    constraint each, then express outputs as linear combinations."""

    def __init__(self, pb, annotation):
        super().__init__(pb, annotation)
        self._prods = []  # (A lc, B lc, t var)

    def product(self, a: LC, b: LC, tag="t") -> LC:
        t = self.pb.allocate_var(f"{self.annotation}.{tag}{len(self._prods)}")
        self._prods.append((a, b, t))
        return t.lc()

    def generate_r1cs_constraints(self):
        for a, b, t in self._prods:
            self.pb.add_r1cs_constraint(
                R1CSConstraint(a, b, t.lc()), self.annotation
            )

    def _witness_products(self, p):
        for a, b, t in self._prods:
            va = self.pb.lc_val(a)
            vb = self.pb.lc_val(b)
            (idx, _), = t.lc().terms
            self.pb.set_val(PBVariable(idx), va * vb % p)


# ---------------------------------------------------------------------------
# Fp2 (quadratic, nonresidue nr):  (a0 + a1 u)(b0 + b1 u), u^2 = nr
# ---------------------------------------------------------------------------

class Fp2MulGadget(_ProductBank):
    """result = a * b via Karatsuba: v0 = a0 b0, v1 = a1 b1,
    v2 = (a0+a1)(b0+b1); c0 = v0 + nr v1, c1 = v2 - v0 - v1
    (fp2_gadgets.tcc mul_gadget: 3 constraints)."""

    def __init__(self, pb, nr: int, a: ExtVariable, b: ExtVariable,
                 result: ExtVariable, annotation="fp2mul"):
        super().__init__(pb, annotation)
        self.nr, self.a, self.b, self.result = nr, a, b, result
        a0, a1 = a.comps
        b0, b1 = b.comps
        self.v0 = self.product(a0, b0, "v")
        self.v1 = self.product(a1, b1, "v")
        self.v2 = self.product(a0 + a1, b0 + b1, "v")

    def generate_r1cs_constraints(self):
        super().generate_r1cs_constraints()
        c0, c1 = self.result.comps
        # linear glue: 1 * (v0 + nr*v1) = c0 ; 1 * (v2 - v0 - v1) = c1
        self.pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1), self.v0 + self.nr * self.v1, c0),
            f"{self.annotation}.c0",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1), self.v2 - self.v0 - self.v1, c1
            ),
            f"{self.annotation}.c1",
        )

    def generate_r1cs_witness(self):
        p = self.pb.p
        self._witness_products(p)
        a0, a1 = self.a.values(self.pb)
        b0, b1 = self.b.values(self.pb)
        self.result.set(
            self.pb,
            ((a0 * b0 + self.nr * a1 * b1) % p, (a0 * b1 + a1 * b0) % p),
        )


class Fp2SqrGadget(_ProductBank):
    """Complex squaring: v = a0 a1; c0 = (a0+a1)(a0+nr a1) - (1+nr) v,
    c1 = 2v  (2 constraints)."""

    def __init__(self, pb, nr: int, a: ExtVariable, result: ExtVariable,
                 annotation="fp2sqr"):
        super().__init__(pb, annotation)
        self.nr, self.a, self.result = nr, a, result
        a0, a1 = a.comps
        self.v = self.product(a0, a1, "v")
        self.w = self.product(a0 + a1, a0 + self.nr * a1, "w")

    def generate_r1cs_constraints(self):
        super().generate_r1cs_constraints()
        c0, c1 = self.result.comps
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1), self.w - (1 + self.nr) * self.v, c0
            ),
            f"{self.annotation}.c0",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1), 2 * self.v, c1),
            f"{self.annotation}.c1",
        )

    def generate_r1cs_witness(self):
        p = self.pb.p
        self._witness_products(p)
        a0, a1 = self.a.values(self.pb)
        self.result.set(
            self.pb, ((a0 * a0 + self.nr * a1 * a1) % p, 2 * a0 * a1 % p)
        )


# ---------------------------------------------------------------------------
# Fp3 (cubic, u^3 = nr)
# ---------------------------------------------------------------------------

class Fp3MulGadget(_ProductBank):
    """3-way Karatsuba, 6 products (fp3_gadgets.tcc mul_gadget)."""

    def __init__(self, pb, nr: int, a: ExtVariable, b: ExtVariable,
                 result: ExtVariable, annotation="fp3mul"):
        super().__init__(pb, annotation)
        self.nr, self.a, self.b, self.result = nr, a, b, result
        a0, a1, a2 = a.comps
        b0, b1, b2 = b.comps
        self.v0 = self.product(a0, b0, "v")
        self.v1 = self.product(a1, b1, "v")
        self.v2 = self.product(a2, b2, "v")
        self.v3 = self.product(a0 + a1, b0 + b1, "v")
        self.v4 = self.product(a0 + a2, b0 + b2, "v")
        self.v5 = self.product(a1 + a2, b1 + b2, "v")

    def generate_r1cs_constraints(self):
        super().generate_r1cs_constraints()
        c0, c1, c2 = self.result.comps
        nr = self.nr
        # c0 = v0 + nr*(v5 - v1 - v2)
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1),
                self.v0 + nr * self.v5 - nr * self.v1 - nr * self.v2,
                c0,
            ),
            f"{self.annotation}.c0",
        )
        # c1 = v3 - v0 - v1 + nr*v2
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1),
                self.v3 - self.v0 - self.v1 + nr * self.v2,
                c1,
            ),
            f"{self.annotation}.c1",
        )
        # c2 = v4 - v0 - v2 + v1
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1),
                self.v4 - self.v0 - self.v2 + self.v1,
                c2,
            ),
            f"{self.annotation}.c2",
        )

    def generate_r1cs_witness(self):
        p = self.pb.p
        self._witness_products(p)
        a0, a1, a2 = self.a.values(self.pb)
        b0, b1, b2 = self.b.values(self.pb)
        nr = self.nr
        self.result.set(
            self.pb,
            (
                (a0 * b0 + nr * (a1 * b2 + a2 * b1)) % p,
                (a0 * b1 + a1 * b0 + nr * a2 * b2) % p,
                (a0 * b2 + a2 * b0 + a1 * b1) % p,
            ),
        )


# ---------------------------------------------------------------------------
# quadratic-over-base towers: Fp4 = Fp2[v]/(v^2-u), Fp6 = Fp3[v]/(v^2-u)
# (fp4_gadgets.hpp / fp6_gadgets.hpp — MNT4/MNT6 GT towers)
# ---------------------------------------------------------------------------

class Tower2Variable:
    """(c0, c1) with c0, c1 in the base extension (Fp2 or Fp3)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: ExtVariable, c1: ExtVariable):
        self.c0, self.c1 = c0, c1

    @classmethod
    def allocate(cls, pb, base_deg, annotation=""):
        return cls(
            ExtVariable.allocate(pb, base_deg, f"{annotation}.c0"),
            ExtVariable.allocate(pb, base_deg, f"{annotation}.c1"),
        )

    def values(self, pb):
        return (self.c0.values(pb), self.c1.values(pb))

    def set(self, pb, vals):
        self.c0.set(pb, vals[0])
        self.c1.set(pb, vals[1])


def _ext_mul_gadget(pb, base_deg, nr, a, b, out, ann):
    if base_deg == 2:
        return Fp2MulGadget(pb, nr, a, b, out, ann)
    return Fp3MulGadget(pb, nr, a, b, out, ann)


def ext_const_mul_lc(deg: int, nr: int, const_comps, var: ExtVariable):
    """Extension product (constant) * (variable) as linear combinations
    of the variable's components — multiplication by a fixed extension
    element is a constant matrix, so it costs zero constraints."""
    x = var.comps
    if deg == 2:
        a0, a1 = const_comps
        return [a0 * x[0] + (nr * a1) * x[1], a0 * x[1] + a1 * x[0]]
    a0, a1, a2 = const_comps
    return [
        a0 * x[0] + (nr * a1) * x[2] + (nr * a2) * x[1],
        a0 * x[1] + a1 * x[0] + (nr * a2) * x[2],
        a0 * x[2] + a2 * x[0] + a1 * x[1],
    ]


def _ext_shift(base_deg, nr, comps):
    """Multiply an element (as component-value tuple) by u (the base
    nonresidue root): matches ops/towers mul_by_nonresidue."""
    if base_deg == 2:
        c0, c1 = comps
        return (nr * c1, c0)
    c0, c1, c2 = comps
    return (nr * c2, c0, c1)


class Tower2MulGadget(Gadget):
    """(a0 + a1 v)(b0 + b1 v) with v^2 = u: Karatsuba over the base ext:
    v0 = a0 b0, v1 = a1 b1, v2 = (a0+a1)(b0+b1);
    c0 = v0 + u*v1 ; c1 = v2 - v0 - v1   (3 base-ext muls)."""

    def __init__(self, pb, base_deg: int, nr: int, a: Tower2Variable,
                 b: Tower2Variable, result: Tower2Variable,
                 annotation="tw2mul"):
        super().__init__(pb, annotation)
        self.base_deg, self.nr = base_deg, nr
        self.a, self.b, self.result = a, b, result
        d = base_deg
        self.v0 = ExtVariable.allocate(pb, d, f"{annotation}.v0")
        self.v1 = ExtVariable.allocate(pb, d, f"{annotation}.v1")
        self.v2 = ExtVariable.allocate(pb, d, f"{annotation}.v2")
        add = lambda x, y: ExtVariable(
            [cx + cy for cx, cy in zip(x.comps, y.comps)]
        )
        self.m0 = _ext_mul_gadget(pb, d, nr, a.c0, b.c0, self.v0, f"{annotation}.m0")
        self.m1 = _ext_mul_gadget(pb, d, nr, a.c1, b.c1, self.v1, f"{annotation}.m1")
        self.m2 = _ext_mul_gadget(
            pb, d, nr, add(a.c0, a.c1), add(b.c0, b.c1), self.v2, f"{annotation}.m2"
        )

    def generate_r1cs_constraints(self):
        for m in (self.m0, self.m1, self.m2):
            m.generate_r1cs_constraints()
        # linear glue rows
        shifted_v1 = _ext_shift(
            self.base_deg, self.nr, tuple(self.v1.comps)
        )
        for out_c, v0_c, sh_c in zip(
            self.result.c0.comps, self.v0.comps, shifted_v1
        ):
            self.pb.add_r1cs_constraint(
                R1CSConstraint(LC.constant(1), v0_c + _lc(sh_c), out_c),
                f"{self.annotation}.c0",
            )
        for out_c, v2_c, v0_c, v1_c in zip(
            self.result.c1.comps, self.v2.comps, self.v0.comps, self.v1.comps
        ):
            self.pb.add_r1cs_constraint(
                R1CSConstraint(
                    LC.constant(1), v2_c - v0_c - v1_c, out_c
                ),
                f"{self.annotation}.c1",
            )

    def generate_r1cs_witness(self):
        p = self.pb.p
        for m in (self.m0, self.m1, self.m2):
            m.generate_r1cs_witness()
        v0 = self.v0.values(self.pb)
        v1 = self.v1.values(self.pb)
        v2 = self.v2.values(self.pb)
        sh = _ext_shift(self.base_deg, self.nr, v1)
        self.result.set(
            self.pb,
            (
                tuple((x + y) % p for x, y in zip(v0, sh)),
                tuple((x - y - z) % p for x, y, z in zip(v2, v0, v1)),
            ),
        )


# ---------------------------------------------------------------------------
# inverse gadgets: a * inv = one, via the matching mul gadget
# ---------------------------------------------------------------------------

class ExtInvGadget(Gadget):
    """inv satisfies a * inv = 1 (fp*_gadgets inv semantics: the
    inverse arrives as witness; the mul constraint enforces it)."""

    def __init__(self, pb, deg: int, nr: int, a: ExtVariable,
                 inv: ExtVariable, annotation="extinv"):
        super().__init__(pb, annotation)
        self.deg, self.nr, self.a, self.inv = deg, nr, a, inv
        one = ExtVariable.constant([1] + [0] * (deg - 1))
        self.mul = _ext_mul_gadget(pb, deg, nr, a, inv, one, f"{annotation}.m")

    def generate_r1cs_constraints(self):
        self.mul.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        """Compute the inverse on host (ops-tower formulas) and fill."""
        p = self.pb.p
        vals = self.a.values(self.pb)
        inv_vals = _ext_inverse(p, self.nr, vals)
        self.inv.set(self.pb, inv_vals)
        self.mul.generate_r1cs_witness()


def _ext_inverse(p, nr, vals):
    if len(vals) == 2:
        a0, a1 = vals
        norm = (a0 * a0 - nr * a1 * a1) % p
        ninv = pow(norm, -1, p)
        return (a0 * ninv % p, (-a1) * ninv % p)
    a0, a1, a2 = vals
    # standard cubic-extension inverse (towers.py fp3_inv)
    t0 = a0 * a0 % p
    t1 = a1 * a1 % p
    t2 = a2 * a2 % p
    t3 = a0 * a1 % p
    t4 = a0 * a2 % p
    t5 = a1 * a2 % p
    c0 = (t0 - nr * t5) % p
    c1 = (nr * t2 - t3) % p
    c2 = (t1 - t4) % p
    t6 = (a0 * c0 + nr * (a2 * c1 + a1 * c2)) % p
    t6i = pow(t6, -1, p)
    return (c0 * t6i % p, c1 * t6i % p, c2 * t6i % p)
