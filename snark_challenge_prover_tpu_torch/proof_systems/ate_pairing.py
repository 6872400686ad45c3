"""The reference's ate pairing over exact host integers.

Counterpart of the JAX package's ``proof_systems/ate_pairing.py`` (libff
mnt4753_pairing.cpp:420-693 and mnt6753_pairing.cpp) over the port's
``host/curves.py``: the G1 / G2 precomputations, the "flipped" Miller loop
over extended projective (X:Y:Z:T) coordinates with cached doubling and
addition coefficients, and the final exponentiation split into its first
and last chunks (Frobenius maps and the published w0 / w1 decomposition,
mnt4753_init.cpp:258-263, mnt6753_init.cpp:274-279).  The key generator
needs one pairing, e(alpha, beta) of the verification key; it is O(1) a
key, so exact integers are the right tool.  The verifiers' double Miller
loop comes with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..host.curves import HostCurve, HostExt
from ..ops.frobenius import ext_frobenius_coeffs

# ate loop count, shared by the cycle (mnt4753_init.cpp:258 == mnt6753_init.cpp:274)
ATE_LOOP_COUNT = int(
    "20469120881933096200946986810463613278326969679001197740022389846243181010"
    "2935615891307667367766898917669754470400"
)

# (is_loop_count_neg, w0_abs, w0_is_neg, w1)
ATE_PARAMS = {
    "MNT4753": (True, ATE_LOOP_COUNT - 1, True, 1),   # mnt4753_init.cpp:259-263
    "MNT6753": (False, ATE_LOOP_COUNT, False, 1),     # mnt6753_init.cpp:275-279
}


class HostGT:
    """GT = Fq^(2e) = Fq^e[v]/(v^2 - u) as pairs of HostExt elements
    (libff Fp4_model / Fp6_2over3_model layout)."""

    def __init__(self, base: HostExt):
        self.base = base
        self.p = base.p

    def mul_u(self, a):
        """u a in Fq^e (rotate the components, nr-scale the top one)."""
        c = self.base.components(a)
        return self.base.from_components([c[-1] * self.base.nr % self.p] + c[:-1])

    @property
    def one(self):
        return (self.base.one, self.base.zero)

    def mul(self, A, B):
        F = self.base
        t0 = F.mul(A[0], B[0])
        t1 = F.mul(A[1], B[1])
        c0 = F.add(t0, self.mul_u(t1))
        c1 = F.sub(F.mul(F.add(A[0], A[1]), F.add(B[0], B[1])), F.add(t0, t1))
        return (c0, c1)

    def sqr(self, A):
        return self.mul(A, A)

    def inv(self, A):
        F = self.base
        norm = F.sub(F.mul(A[0], A[0]), self.mul_u(F.mul(A[1], A[1])))
        ni = F.inv(norm)
        return (F.mul(A[0], ni), F.smul(-1, F.mul(A[1], ni)))

    def pow(self, A, e: int):
        if e < 0:
            return self.pow(self.inv(A), -e)
        out = self.one
        for bit in bin(e)[2:] if e else "0":
            out = self.sqr(out)
            if bit == "1":
                out = self.mul(out, A)
        return out

    def frobenius_map(self, A, power: int):
        """(c0^(q^power), coeff c1^(q^power)), coeff = nr^(power (q - 1) / (2e))
        (fp4.tcc / fp6_2over3.tcc Frobenius_map)."""
        F = self.base
        coeff = ext_frobenius_coeffs(self.p, F.nr, 2 * F.deg)[power % (2 * F.deg)]
        return (self._ext_frob(A[0], power), F.smul(coeff, self._ext_frob(A[1], power)))

    def _ext_frob(self, a, power: int):
        F = self.base
        co = ext_frobenius_coeffs(self.p, F.nr, F.deg)
        return F.from_components([c * pow(co[m], power, self.p) % self.p
                                  for m, c in enumerate(F.components(a))])


@dataclass
class AteG1Precomp:
    """mnt4753_ate_G1_precomp (mnt4753_pairing.cpp:463-478)."""

    PX: int
    PY: int
    PX_twist: tuple
    PY_twist: tuple


@dataclass
class AteG2Precomp:
    """mnt4753_ate_G2_precomp: affine Q and the cached step coefficients."""

    QX: tuple
    QY: tuple
    QY2: tuple
    QX_over_twist: tuple
    QY_over_twist: tuple
    dbl_coeffs: list = field(default_factory=list)
    add_coeffs: list = field(default_factory=list)


class AtePairing:
    """One curve's ate pairing over exact host integers."""

    def __init__(self, hc: HostCurve):
        self.hc = hc
        F2 = hc.g2.F  # Fq2 or Fq3
        self.F2 = F2
        self.GT = HostGT(F2)
        self.e = F2.deg
        # twist = u, the tower's generator (mnt4753_init.cpp:121, mnt6753_init.cpp:132)
        self.twist = F2.from_components([0, 1] + [0] * (self.e - 2))
        self.twist_inv = F2.inv(self.twist)
        self.twist_coeff_a = hc.g2.a
        self.loop_neg, self.w0, self.w0_neg, self.w1 = ATE_PARAMS[hc.name]

    def _embed(self, v: int):
        return self.F2.from_components([v] + [0] * (self.e - 1))

    # ---- precompute -----------------------------------------------------
    def precompute_g1(self, P) -> AteG1Precomp:
        """mnt4753_ate_precompute_G1 (:463-478); P affine (x, y)."""
        x, y = P
        return AteG1Precomp(PX=x, PY=y, PX_twist=self.F2.mul(self._embed(x), self.twist),
                            PY_twist=self.F2.mul(self._embed(y), self.twist))

    def _dbl_step(self, R):
        """doubling_step_for_flipped_miller_loop (:404-431); R = [X, Y, Z, T]
        is updated; returns (c_H, c_4C, c_J, c_L)."""
        F = self.F2
        X, Y, Z, T = R
        A = F.sqr(T)
        B = F.sqr(X)
        C = F.sqr(Y)
        D = F.sqr(C)
        E = F.sub(F.sub(F.sqr(F.add(X, C)), B), D)
        Fv = F.add(F.add(F.add(B, B), B), F.mul(self.twist_coeff_a, A))
        G = F.sqr(Fv)
        X3 = F.add(F.smul(-4, E), G)
        Y3 = F.add(F.smul(-8, D), F.mul(Fv, F.sub(F.add(E, E), X3)))
        Z3 = F.sub(F.sub(F.sqr(F.add(Y, Z)), C), F.sqr(Z))
        T3 = F.sqr(Z3)
        dc = (
            F.sub(F.sub(F.sqr(F.add(Z3, T)), T3), A),  # c_H
            F.smul(4, C),                               # c_4C
            F.sub(F.sub(F.sqr(F.add(Fv, T)), G), A),    # c_J
            F.sub(F.sub(F.sqr(F.add(Fv, X)), G), B),    # c_L
        )
        R[0], R[1], R[2], R[3] = X3, Y3, Z3, T3
        return dc

    def _add_step(self, base_X, base_Y, base_Y2, R):
        """mixed_addition_step_for_flipped_miller_loop (:433-460); returns
        (c_L1, c_RZ)."""
        F = self.F2
        X1, Y1, Z1, T1 = R
        B = F.mul(base_X, T1)
        D = F.mul(F.sub(F.sub(F.sqr(F.add(base_Y, Z1)), base_Y2), T1), T1)
        H = F.sub(B, X1)
        I = F.sqr(H)
        E = F.smul(4, I)
        J = F.mul(H, E)
        V = F.mul(X1, E)
        L1 = F.sub(D, F.add(Y1, Y1))
        X3 = F.sub(F.sub(F.sqr(L1), J), F.add(V, V))
        Y3 = F.sub(F.mul(L1, F.sub(V, X3)), F.mul(F.add(Y1, Y1), J))
        Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), T1), I)
        R[0], R[1], R[2], R[3] = X3, Y3, Z3, F.sqr(Z3)
        return (L1, Z3)

    def precompute_g2(self, Q) -> AteG2Precomp:
        """mnt4753_ate_precompute_G2 (:480-541); Q affine (X, Y)."""
        F = self.F2
        QX, QY = Q
        prec = AteG2Precomp(QX=QX, QY=QY, QY2=F.sqr(QY), QX_over_twist=F.mul(QX, self.twist_inv),
                            QY_over_twist=F.mul(QY, self.twist_inv))
        R = [QX, QY, F.one, F.one]
        for bit in bin(ATE_LOOP_COUNT)[3:]:  # below the top bit
            prec.dbl_coeffs.append(self._dbl_step(R))
            if bit == "1":
                prec.add_coeffs.append(self._add_step(QX, QY, prec.QY2, R))
        if self.loop_neg:
            RZ_inv = F.inv(R[2])
            RZ2_inv = F.sqr(RZ_inv)
            mX = F.mul(R[0], RZ2_inv)
            mY = F.smul(-1, F.mul(R[1], F.mul(RZ2_inv, RZ_inv)))
            prec.add_coeffs.append(self._add_step(mX, mY, F.sqr(mY), R))
        return prec

    # ---- Miller loop and final exponentiation ---------------------------
    def _g_add(self, ac, prec_P, prec_Q, L1_coeff):
        F = self.F2
        c_L1, c_RZ = ac
        return (F.mul(c_RZ, prec_P.PY_twist),
                F.smul(-1, F.add(F.mul(prec_Q.QY_over_twist, c_RZ), F.mul(L1_coeff, c_L1))))

    def miller_loop(self, prec_P: AteG1Precomp, prec_Q: AteG2Precomp):
        """mnt4753_ate_miller_loop (:543-594)."""
        F, GT = self.F2, self.GT
        L1_coeff = F.sub(self._embed(prec_P.PX), prec_Q.QX_over_twist)
        f = GT.one
        adds = iter(prec_Q.add_coeffs)
        for bit, (c_H, c_4C, c_J, c_L) in zip(bin(ATE_LOOP_COUNT)[3:], prec_Q.dbl_coeffs):
            g_RR = (F.add(F.sub(F.smul(-1, c_4C), F.mul(c_J, prec_P.PX_twist)), c_L),
                    F.mul(c_H, prec_P.PY_twist))
            f = GT.mul(GT.sqr(f), g_RR)
            if bit == "1":
                f = GT.mul(f, self._g_add(next(adds), prec_P, prec_Q, L1_coeff))
        if self.loop_neg:
            f = GT.inv(GT.mul(f, self._g_add(next(adds), prec_P, prec_Q, L1_coeff)))
        return f

    def _first_chunk(self, elt, elt_inv):
        """MNT4753: elt^(q^2 - 1) (:198-211); MNT6753: elt^((q^3 - 1)(q + 1))
        (mnt6753_pairing.cpp:200-216)."""
        GT = self.GT
        if self.e == 2:
            return GT.mul(GT.frobenius_map(elt, 2), elt_inv)
        q3_over = GT.mul(GT.frobenius_map(elt, 3), elt_inv)
        return GT.mul(GT.frobenius_map(q3_over, 1), q3_over)

    def _last_chunk(self, elt, elt_inv):
        """(:180-196): elt^(q w1) (elt or elt^-1)^w0."""
        GT = self.GT
        w1_part = GT.pow(GT.frobenius_map(elt, 1), self.w1)
        return GT.mul(w1_part, GT.pow(elt_inv if self.w0_neg else elt, self.w0))

    def final_exponentiation(self, elt):
        """(:213-224)."""
        elt_inv = self.GT.inv(elt)
        return self._last_chunk(self._first_chunk(elt, elt_inv), self._first_chunk(elt_inv, elt))

    def ate_pairing(self, P, Q):
        """The Miller loop alone (:674-682); P, Q affine and not the identity."""
        return self.miller_loop(self.precompute_g1(P), self.precompute_g2(Q))

    def reduced_pairing(self, P, Q):
        """final_exponentiation(ate_pairing(P, Q)) (:684-693); an identity
        (None) gives GT's one."""
        if P is None or Q is None:
            return self.GT.one
        return self.final_exponentiation(self.ate_pairing(P, Q))
