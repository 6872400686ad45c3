"""The reduced Tate pairing for MNT4753 (GT = Fq4) and MNT6753 (GT = Fq6),
over exact host integers.

Counterpart of the JAX package's ``proof_systems/pairing.py``: the
cross-check engine kept beside the reference's ate pairing
(``proof_systems/ate_pairing.py``).  It takes the port's ``HostCurve``
(``host/curves.py``), whose ``HostExt`` fields give the tower arithmetic.

Design note: the reduced Tate pairing with denominator elimination, not
libff's optimised ate loop.  Any non-degenerate bilinear pairing used
consistently on both sides of the Groth16 verification equation gives the
same verdicts; bilinearity and the generator pairing are checked in tests.

Tower layout: GT = Fq^(2e) = Fq^e[v] / (v^2 - u), where u is the degree-e
tower generator (libff Fp4_model / Fp6_2over3_model shape).  The G2 twist
is by u (mnt4753_init.cpp:121, mnt6753_init.cpp:132): the untwist map
psi(x', y') = (x'/u, y' * v / u^2) lands on E(Fq^(2e)); x(psi) stays in
the Fq^e subfield, enabling denominator elimination.
"""

from __future__ import annotations


class GTField:
    """Fq^(2e) = Fq^e[v]/(v^2 - u): elements are pairs (c0, c1) of
    elements of the base ``HostExt``."""

    def __init__(self, base):
        self.base = base  # a HostExt of degree e

    # u-multiplication in Fq^e: multiply by the tower generator x
    def _mul_u(self, a):
        F = self.base
        if F.deg == 1:
            # e==1 never happens here (MNT embedding degrees are 4/6)
            raise ValueError
        comps = F.components(a)
        # (c0 + c1 x + ... + c_{e-1} x^{e-1}) * x
        rot = [F.nr * comps[-1] % F.p] + [c for c in comps[:-1]]
        return F.from_components(rot)

    @property
    def one(self):
        return (self.base.one, self.base.zero)

    def mul(self, A, B):
        F = self.base
        a0, a1 = A
        b0, b1 = B
        t0 = F.mul(a0, b0)
        t1 = F.mul(a1, b1)
        c0 = F.add(t0, self._mul_u(t1))
        c1 = F.sub(F.mul(F.add(a0, a1), F.add(b0, b1)), F.add(t0, t1))
        return (c0, c1)

    def sqr(self, A):
        return self.mul(A, A)

    def inv(self, A):
        F = self.base
        a0, a1 = A
        norm = F.sub(F.mul(a0, a0), self._mul_u(F.mul(a1, a1)))
        ni = F.inv(norm)
        return (F.mul(a0, ni), F.sub(F.zero, F.mul(a1, ni)))

    def conj(self, A):
        """v -> -v (the q^e Frobenius); unitary inverse for cyclotomic
        elements (libff Fp4 unitary_inverse)."""
        F = self.base
        return (A[0], F.sub(F.zero, A[1]))

    def pow(self, A, e: int):
        if e < 0:
            return self.pow(self.inv(A), -e)
        R = self.one
        while e:
            if e & 1:
                R = self.mul(R, A)
            A = self.sqr(A)
            e >>= 1
        return R

    def eq(self, A, B):
        return A == B


class PairingEngine:
    """Reduced Tate pairing for one curve (a ``HostCurve``)."""

    def __init__(self, host_curve):
        self.cur = host_curve
        self.fq = host_curve.fq_spec
        self.fr = host_curve.fr_spec
        self.g1 = host_curve.g1
        self.g2 = host_curve.g2
        self.ext = self.g2.F  # Fq^e
        self.gt = GTField(self.ext)
        self.e = self.ext.deg
        self.k = 2 * self.e  # embedding degree

    # ---- untwist: E'(Fq^e) -> E(Fq^(2e)) ------------------------------
    def _untwist(self, Q):
        """(x', y') on the twist -> (x in Fq^e, y-coeff of v in Fq^e):
        x = x'/u, y = y' / (u v) = (y' / u^2) * v  (v^2 = u)."""
        F = self.ext
        xq, yq = Q
        u = F.from_components([0, 1] + [0] * (F.deg - 2))
        u_inv = F.inv(u)
        x = F.mul(xq, u_inv)
        y_v = F.mul(yq, F.mul(u_inv, u_inv))  # coefficient of v
        return x, y_v

    # ---- Miller loop (Tate: scalar r over G1 points) --------------------
    def miller_loop(self, P, Q) -> tuple:
        """f_{r,P}(psi(Q)) in GT (denominators eliminated)."""
        if P is None or Q is None:
            return self.gt.one
        F = self.ext
        p = self.fq.p
        xQ, yQv = self._untwist(Q)  # xQ in Fq^e; y = yQv * v

        def line(T, U, lam):
            """l(x,y) = y - yT - lam (x - xT) evaluated at psi(Q):
            = (-yT - lam (xQ - xT)) + yQv * v  in GT."""
            xT, yT = T
            c0 = F.sub(
                F.smul(-1, self._lift(yT)),
                F.mul(self._lift_int(lam), F.sub(xQ, self._lift(xT))),
            )
            return (c0, yQv)

        def vert(xT):
            """vertical line x - xT (used only when doubling lands at
            infinity, i.e. yT == 0; stays in Fq^e => final exp kills it,
            but we must not divide by zero so handle explicitly)."""
            return (F.sub(xQ, self._lift(xT)), F.zero)

        gt = self.gt
        f = gt.one
        T = P
        r_bits = bin(self.fr.p)[3:]  # MSB already consumed by T = P
        g = self.g1
        for bit in r_bits:
            # doubling step
            if T is None:
                f = gt.sqr(f)
            else:
                x1, y1 = T
                if y1 == 0:
                    f = gt.mul(gt.sqr(f), vert(x1))
                    T = None
                else:
                    lam = (
                        (3 * x1 * x1 + g.a)
                        * pow(2 * y1 % p, -1, p)
                    ) % p
                    f = gt.mul(gt.sqr(f), line(T, T, lam))
                    T = g.add(T, T)
            if bit == "1":
                if T is None:
                    T = P
                elif T == P:
                    # would be a doubling; r is prime > group order cases
                    x1, y1 = T
                    lam = ((3 * x1 * x1 + g.a) * pow(2 * y1 % p, -1, p)) % p
                    f = gt.mul(f, line(T, T, lam))
                    T = g.add(T, T)
                else:
                    x1, y1 = T
                    x2, y2 = P
                    if x1 == x2:  # T == -P: vertical
                        f = gt.mul(f, vert(x1))
                        T = None
                    else:
                        lam = (y2 - y1) * pow((x2 - x1) % p, -1, p) % p
                        f = gt.mul(f, line(T, P, lam))
                        T = g.add(T, P)
        return f

    def _lift(self, c: int):
        """Fq scalar -> Fq^e constant."""
        return self.ext.from_components([c % self.fq.p] + [0] * (self.ext.deg - 1))

    _lift_int = _lift

    def final_exponentiation(self, f):
        """f^((q^k - 1)/r)."""
        exp = (self.fq.p ** self.k - 1) // self.fr.p
        return self.gt.pow(f, exp)

    def reduced_pairing(self, P, Q):
        """e(P, Q) for P in G1 (affine int pair / None), Q in G2."""
        return self.final_exponentiation(self.miller_loop(P, Q))
