"""Pairing-verification gadgets: the ate pairing as an R1CS circuit.

Counterpart of the JAX package's ``gadgets/pairing_gadgets.py``, on the
port's protoboard, ``host/curves.py`` and ``proof_systems/ate_pairing.py``.

Capability parity with gadgetlib1's pairing gadget stack
(libsnark/gadgetlib1/gadgets/pairing/{mnt_pairing_params,
weierstrass_precomputation,weierstrass_miller_loop,
weierstrass_final_exponentiation}.hpp) — the circuits Mina uses to
verify SNARK proofs INSIDE SNARKs (recursive composition over the
MNT4753/MNT6753 cycle).  The circuit mirrors this framework's own host
ate engine (proof_systems/ate_pairing.py, itself structured after
mnt4753_pairing.cpp):

  * G1 precompute: PX_twist / PY_twist are FREE (multiplication by the
    tower generator u is a component rotation);
  * G2 precompute gadget: the flipped-Miller-loop (X:Y:Z:T) doubling /
    mixed-addition chains with per-step coefficient wires, every
    extension square/multiply one ext-mul gadget
    (weierstrass_precomputation.hpp G2 precompute gadgets);
  * Miller loop gadget: the shared f-chain with line-function
    assembly; scalar-by-extension products (cJ * PX_twist etc.) cost
    deg products instead of deg^2 (the reference's mul_by_lc gadgets);
  * final exponentiation gadget: Frobenius maps are free linear maps,
    inverses are one-product witnesses, the w0 power is a fixed
    square-and-multiply chain (mnt4/mnt6 final_exp gadgets).

Everything registers witness-fill closures at build time (same pattern
as reductions/ram_to_r1cs); `fill()` runs them against values computed
by the host engine step-by-step — each wire's value is the circuit's
own constraint-satisfying assignment, verified by pb.is_satisfied().

Cost (MNT4753): ~62k constraints / ~62k wires per reduced pairing —
the same order as the reference's miller-loop + final-exp gadget
budget; a full 3-pairing Groth16-verifier circuit lands around 200k
constraints on this stack.
"""

from __future__ import annotations

from ..host.curves import HostCurve, HostExt
from ..proof_systems.ate_pairing import ATE_LOOP_COUNT, AtePairing
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .field_ext_gadgets import ExtVariable, _ext_mul_gadget
from .protoboard import Protoboard


def _c(x):
    return LC.constant(x)


class _B:
    """Extension-level ops as gadget allocations + fill closures."""

    def __init__(self, pb: Protoboard, F: HostExt, nr: int):
        self.pb = pb
        self.F = F
        self.deg = F.deg
        self.nr = nr
        self.fillers = []

    # ---- value/wire plumbing ------------------------------------------
    def const(self, val) -> ExtVariable:
        return ExtVariable.constant(list(self.F.components(val)))

    def wire(self, ann="") -> ExtVariable:
        return ExtVariable.allocate(self.pb, self.deg, ann)

    def lin(self, comps) -> ExtVariable:
        return ExtVariable(comps)

    def add(self, a: ExtVariable, b: ExtVariable) -> ExtVariable:
        return ExtVariable([x + y for x, y in zip(a.comps, b.comps)])

    def sub(self, a: ExtVariable, b: ExtVariable) -> ExtVariable:
        return ExtVariable([x - y for x, y in zip(a.comps, b.comps)])

    def smul(self, k: int, a: ExtVariable) -> ExtVariable:
        return ExtVariable([comp * k for comp in a.comps])

    def mul_u(self, a: ExtVariable) -> ExtVariable:
        """Multiply by the tower generator u: component rotation with an
        nr scale on the wrapped component — free."""
        return ExtVariable(
            [a.comps[-1] * self.nr] + list(a.comps[: self.deg - 1])
        )

    def mul(self, a: ExtVariable, b: ExtVariable, ann="m") -> ExtVariable:
        """Full ext product: one ext-mul gadget + product fills."""
        out = self.wire(ann)
        g = _ext_mul_gadget(self.pb, self.deg, self.nr, a, b, out, ann)
        g.generate_r1cs_constraints()

        def fill(g=g, a=a, b=b, out=out):
            va = tuple(self.pb.lc_val(comp) for comp in a.comps)
            vb = tuple(self.pb.lc_val(comp) for comp in b.comps)
            out.set(self.pb, self.F.mul(va, vb))
            g._witness_products(self.pb.p)

        self.fillers.append(fill)
        return out

    def sqr(self, a: ExtVariable, ann="s") -> ExtVariable:
        return self.mul(a, a, ann)

    def scalar_mul(self, x_lc, a: ExtVariable, ann="sm") -> ExtVariable:
        """(base-field wire) * (ext wire): deg products."""
        outs = []
        for i, comp in enumerate(a.comps):
            t = self.pb.allocate_var(f"{ann}.{i}")
            self.pb.add_r1cs_constraint(
                R1CSConstraint(x_lc, comp, t.lc()), ann
            )
            outs.append(t)

        def fill(x_lc=x_lc, a=a, outs=outs):
            xv = self.pb.lc_val(x_lc)
            for t, comp in zip(outs, a.comps):
                self.pb.set_val(t, xv * self.pb.lc_val(comp))

        self.fillers.append(fill)
        return ExtVariable([t.lc() for t in outs])

    def inv(self, a: ExtVariable, ann="inv") -> ExtVariable:
        """Witness inverse + one ext-mul check a * ainv = 1."""
        out = self.wire(ann)
        one = ExtVariable.constant([1] + [0] * (self.deg - 1))
        g = _ext_mul_gadget(self.pb, self.deg, self.nr, a, out, one, ann)
        g.generate_r1cs_constraints()

        def fill(g=g, a=a, out=out):
            va = tuple(self.pb.lc_val(comp) for comp in a.comps)
            out.set(self.pb, self.F.inv(va))
            g._witness_products(self.pb.p)

        self.fillers.append(fill)
        return out

    def fill(self):
        for f in self.fillers:
            f()


class _GTOps:
    """GT = Fq^e[v]/(v^2-u) over _B ext ops (HostGT mirrored as
    gadgets; elements are (c0, c1) ExtVariable pairs)."""

    def __init__(self, b: _B):
        self.b = b

    def one(self):
        d = self.b.deg
        return (
            ExtVariable.constant([1] + [0] * (d - 1)),
            ExtVariable.constant([0] * d),
        )

    def mul(self, A, B, ann="gtm"):
        b = self.b
        t0 = b.mul(A[0], B[0], f"{ann}.t0")
        t1 = b.mul(A[1], B[1], f"{ann}.t1")
        c0 = b.add(t0, b.mul_u(t1))
        t2 = b.mul(b.add(A[0], A[1]), b.add(B[0], B[1]), f"{ann}.t2")
        c1 = b.sub(t2, b.add(t0, t1))
        return (c0, c1)

    def sqr(self, A, ann="gts"):
        return self.mul(A, A, ann)

    def inv(self, A, ann="gti"):
        """Witness GT inverse + one GT-mul check."""
        b = self.b
        c0 = b.wire(f"{ann}.c0")
        c1 = b.wire(f"{ann}.c1")
        out = (c0, c1)

        def fill(A=A, out=out):
            from ..proof_systems.ate_pairing import HostGT

            gt = HostGT(b.F)
            va = tuple(
                tuple(b.pb.lc_val(comp) for comp in part.comps) for part in A
            )
            iv = gt.inv(va)
            out[0].set(b.pb, b.F.components(iv[0]))
            out[1].set(b.pb, b.F.components(iv[1]))

        b.fillers.append(fill)
        prod = self.mul(A, out, f"{ann}.chk")
        # prod == GT one (componentwise linear pins)
        one = [1] + [0] * (b.deg - 1)
        for comp, want in zip(prod[0].comps, one):
            b.pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), comp, _c(want)), f"{ann} c0"
            )
        for comp in prod[1].comps:
            b.pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), comp, _c(0)), f"{ann} c1"
            )
        return out

    def unitary_inverse(self, A):
        return (A[0], self.b.smul(-1, A[1]))

    def frobenius(self, A, power: int):
        """Free linear map: component-scale by the Frobenius constants
        (fp4/fp6_2over3 Frobenius_map)."""
        from ..ops.frobenius import ext_frobenius_coeffs

        b = self.b
        p = b.pb.p
        e = b.deg
        co_base = ext_frobenius_coeffs(p, b.nr, e)
        co_top = ext_frobenius_coeffs(p, b.nr, 2 * e)[power % (2 * e)]

        def frob_ext(x):
            return ExtVariable([
                comp * pow(co_base[m], power, p)
                for m, comp in enumerate(x.comps)
            ])

        c0 = frob_ext(A[0])
        c1f = frob_ext(A[1])
        return (c0, b.smul(co_top, c1f))

    def pow_const(self, A, e: int, A_is_inv_of=None, ann="gtp"):
        """Fixed-exponent square-and-multiply chain."""
        out = self.one()
        started = False
        for i, bit in enumerate(bin(e)[2:]):
            if started:
                out = self.sqr(out, f"{ann}.s{i}")
            if bit == "1":
                out = A if not started else self.mul(out, A, f"{ann}.m{i}")
                started = True
        return out


class ReducedPairingGadget:
    """e(P, Q) as a circuit: precompute + Miller loop + final exp.

    P = (x, y) base-field wires (affine G1, non-identity);
    Q = (X, Y) ExtVariable pair (affine G2).  `.result` is the GT
    element (pair of ExtVariables).  Build once; generate_r1cs_witness
    fills every wire from the host engine's step values."""

    def __init__(self, pb: Protoboard, hc: HostCurve, P, Q,
                 annotation="pair"):
        self.pb = pb
        self.hc = hc
        F2 = hc.g2.F
        self.engine = AtePairing(hc)
        b = _B(pb, F2, F2.nr)
        self.b = b
        gt = _GTOps(b)
        self.gt = gt
        self.P = P
        self.Q = Q
        e_deg = F2.deg

        x_lc = P[0].lc() if hasattr(P[0], "lc") else P[0]
        y_lc = P[1].lc() if hasattr(P[1], "lc") else P[1]

        # ---- G1 precompute (free): PX_twist = emb(x)*u etc. -----------
        zero = _c(0)
        PX_twist = ExtVariable(
            [zero, x_lc] + [zero] * (e_deg - 2)
        )
        PY_twist = ExtVariable(
            [zero, y_lc] + [zero] * (e_deg - 2)
        )

        # ---- G2 precompute gadget (dbl/add chains) --------------------
        QX, QY = Q
        twist_inv = self.engine.twist_inv
        QY2 = b.sqr(QY, "qy2")
        QX_over = b.mul(QX, b.const(twist_inv), "qxo")
        QY_over = b.mul(QY, b.const(twist_inv), "qyo")
        a_const = b.const(self.engine.twist_coeff_a)

        R = [QX, QY,
             ExtVariable.constant([1] + [0] * (e_deg - 1)),
             ExtVariable.constant([1] + [0] * (e_deg - 1))]
        dbl_coeffs = []
        add_coeffs = []
        bits = bin(ATE_LOOP_COUNT)[2:]

        def dbl_step(R, i):
            X, Y, Z, T = R
            A = b.sqr(T, f"d{i}.A")
            Bq = b.sqr(X, f"d{i}.B")
            C = b.sqr(Y, f"d{i}.C")
            D = b.sqr(C, f"d{i}.D")
            E = b.sub(b.sub(b.sqr(b.add(X, C), f"d{i}.E"), Bq), D)
            Fv = b.add(b.smul(3, Bq), b.mul(a_const, A, f"d{i}.aA"))
            G = b.sqr(Fv, f"d{i}.G")
            X3 = b.add(b.smul(-4, E), G)
            Y3 = b.add(
                b.smul(-8, D),
                b.mul(Fv, b.sub(b.smul(2, E), X3), f"d{i}.Y3"),
            )
            Z3 = b.sub(b.sub(b.sqr(b.add(Y, Z), f"d{i}.Z3"), C),
                       b.sqr(Z, f"d{i}.Z2"))
            T3 = b.sqr(Z3, f"d{i}.T3")
            cH = b.sub(b.sub(b.sqr(b.add(Z3, T), f"d{i}.cH"), T3), A)
            c4C = b.smul(4, C)
            cJ = b.sub(b.sub(b.sqr(b.add(Fv, T), f"d{i}.cJ"), G), A)
            cL = b.sub(b.sub(b.sqr(b.add(Fv, X), f"d{i}.cL"), G), Bq)
            return [X3, Y3, Z3, T3], (cH, c4C, cJ, cL)

        def add_step(bX, bY, bY2, R, i):
            X1, Y1, Z1, T1 = R
            Bq = b.mul(bX, T1, f"a{i}.B")
            D = b.mul(
                b.sub(b.sub(b.sqr(b.add(bY, Z1), f"a{i}.D1"), bY2), T1),
                T1, f"a{i}.D",
            )
            H = b.sub(Bq, X1)
            I = b.sqr(H, f"a{i}.I")
            E = b.smul(4, I)
            J = b.mul(H, E, f"a{i}.J")
            V = b.mul(X1, E, f"a{i}.V")
            L1 = b.sub(D, b.smul(2, Y1))
            X3 = b.sub(b.sub(b.sqr(L1, f"a{i}.X3"), J), b.smul(2, V))
            Y3 = b.sub(
                b.mul(L1, b.sub(V, X3), f"a{i}.Y3a"),
                b.mul(b.smul(2, Y1), J, f"a{i}.Y3b"),
            )
            Z3 = b.sub(b.sub(b.sqr(b.add(Z1, H), f"a{i}.Z3"), T1), I)
            T3 = b.sqr(Z3, f"a{i}.T3")
            return [X3, Y3, Z3, T3], (L1, Z3)

        for i, bit in enumerate(bits[1:]):
            R, dc = dbl_step(R, i)
            dbl_coeffs.append(dc)
            if bit == "1":
                R, ac = add_step(QX, QY, QY2, R, i)
                add_coeffs.append(ac)
        if self.engine.loop_neg:
            RZ_inv = b.inv(R[2], "rzin")
            RZ2_inv = b.sqr(RZ_inv, "rz2i")
            RZ3_inv = b.mul(RZ2_inv, RZ_inv, "rz3i")
            mX = b.mul(R[0], RZ2_inv, "mX")
            mY = b.smul(-1, b.mul(R[1], RZ3_inv, "mY"))
            mY2 = b.sqr(mY, "mY2")
            R, ac = add_step(mX, mY, mY2, R, "neg")
            add_coeffs.append(ac)

        # ---- Miller loop ----------------------------------------------
        L1_coeff = b.sub(
            ExtVariable([x_lc] + [zero] * (e_deg - 1)), QX_over
        )
        f = gt.one()
        dbl_idx = add_idx = 0

        def g_dbl(dc, i):
            cH, c4C, cJ, cL = dc
            # cJ * PX_twist = x * (cJ * u); cH * PY_twist = y * (cH * u)
            t1 = b.scalar_mul(x_lc, b.mul_u(cJ), f"gd{i}.jx")
            t2 = b.scalar_mul(y_lc, b.mul_u(cH), f"gd{i}.hy")
            return (b.add(b.sub(b.smul(-1, c4C), t1), cL), t2)

        def g_add(ac, i):
            cL1, cRZ = ac
            t1 = b.scalar_mul(y_lc, b.mul_u(cRZ), f"ga{i}.rzy")
            t2 = b.mul(QY_over, cRZ, f"ga{i}.qyrz")
            t3 = b.mul(L1_coeff, cL1, f"ga{i}.l1")
            return (t1, b.smul(-1, b.add(t2, t3)))

        for i, bit in enumerate(bits[1:]):
            dc = dbl_coeffs[dbl_idx]
            dbl_idx += 1
            f = gt.mul(gt.sqr(f, f"f{i}.s"), g_dbl(dc, i), f"f{i}.m")
            if bit == "1":
                ac = add_coeffs[add_idx]
                add_idx += 1
                f = gt.mul(f, g_add(ac, i), f"f{i}.a")
        if self.engine.loop_neg:
            ac = add_coeffs[add_idx]
            f = gt.inv(gt.mul(f, g_add(ac, "neg"), "fneg"), "finv")

        # ---- final exponentiation -------------------------------------
        elt = f
        elt_inv = gt.inv(elt, "ei")
        first = self._first_chunk(elt, elt_inv)
        first_inv = self._first_chunk(elt_inv, elt)
        elt_q = gt.frobenius(first, 1)
        w0_base = first_inv if self.engine.w0_neg else first
        w0_part = gt.pow_const(w0_base, self.engine.w0, ann="w0")
        w1_part = (
            elt_q
            if self.engine.w1 == 1
            else gt.pow_const(elt_q, self.engine.w1, ann="w1")
        )
        self.result = gt.mul(w1_part, w0_part, "fin")

    def _first_chunk(self, elt, elt_inv):
        gt = self.gt
        if self.b.deg == 2:
            return gt.mul(gt.frobenius(elt, 2), elt_inv, "fc")
        q3 = gt.mul(gt.frobenius(elt, 3), elt_inv, "fc3")
        return gt.mul(gt.frobenius(q3, 1), q3, "fc1")

    def generate_r1cs_constraints(self):
        """Constraints are emitted during construction (one pass —
        the reference's precompute gadgets do the same in their
        constructors); kept for API parity."""

    def generate_r1cs_witness(self):
        self.b.fill()

    def result_values(self):
        pb = self.pb
        return tuple(
            tuple(pb.lc_val(comp) for comp in part.comps)
            for part in self.result
        )
