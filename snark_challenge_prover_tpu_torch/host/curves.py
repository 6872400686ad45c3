"""Exact-integer host arithmetic for the MNT4753 and MNT6753 curves.

The O(1) tail of a proof (C = Ht + Lt + r * Bt1, the affine conversion),
the key generator's single points and pairing, and every independent
check of the device code run on Python ints.

Group elements are affine tuples; None is the identity:
  G1: (x, y) ints;  G2: (x, y) with x, y tuples of 2 (MNT4753) or 3
  (MNT6753) ints (twist coords).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models import mnt4753 as m4
from ..models import mnt6753 as m6
from ..models.primes import FIELD_A, FIELD_B, FIELD_B_SMALL, PrimeSpec


class HostExt:
    """Fq[u]/(u^deg - nr) with exact int tuples (deg == 1 degenerates to Fq)."""

    def __init__(self, p: int, deg: int, nr: int):
        self.p = p
        self.deg = deg
        self.nr = nr
        self.zero = (0,) * deg if deg > 1 else 0
        self.one = ((1,) + (0,) * (deg - 1)) if deg > 1 else 1

    def components(self, a) -> list:
        return list(a) if self.deg > 1 else [a]

    def from_components(self, comps):
        comps = [c % self.p for c in comps]
        return tuple(comps) if self.deg > 1 else comps[0]

    def add(self, a, b):
        if self.deg == 1:
            return (a + b) % self.p
        return tuple((x + y) % self.p for x, y in zip(a, b))

    def sub(self, a, b):
        if self.deg == 1:
            return (a - b) % self.p
        return tuple((x - y) % self.p for x, y in zip(a, b))

    def smul(self, k: int, a):
        if self.deg == 1:
            return k * a % self.p
        return tuple(k * x % self.p for x in a)

    def mul(self, a, b):
        p, d = self.p, self.deg
        if d == 1:
            return a * b % p
        # schoolbook with u^d = nr reduction
        acc = [0] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                acc[i + j] += a[i] * b[j]
        for k in range(2 * d - 2, d - 1, -1):
            acc[k - d] += self.nr * acc[k]
        return tuple(v % p for v in acc[:d])

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        p = self.p
        if self.deg == 1:
            return pow(a, -1, p)
        if self.deg == 2:
            # (a0 - a1 u) / (a0^2 - nr a1^2)
            ninv = pow((a[0] * a[0] - self.nr * a[1] * a[1]) % p, -1, p)
            return (a[0] * ninv % p, -a[1] * ninv % p)
        if self.deg == 3:
            # the classical cubic formula (libff fp3.tcc invert):
            # c0 = a0^2 - nr a1 a2, c1 = nr a2^2 - a0 a1, c2 = a1^2 - a0 a2,
            # norm = a0 c0 + nr (a2 c1 + a1 c2)
            a0, a1, a2 = a
            c0 = (a0 * a0 - self.nr * a1 * a2) % p
            c1 = (self.nr * a2 * a2 - a0 * a1) % p
            c2 = (a1 * a1 - a0 * a2) % p
            ninv = pow((a0 * c0 + self.nr * (a2 * c1 + a1 * c2)) % p, -1, p)
            return (c0 * ninv % p, c1 * ninv % p, c2 * ninv % p)
        raise NotImplementedError("inverse for degree > 3")

    def is_zero(self, a):
        return a == self.zero


class HostGroup:
    """Affine short-Weierstrass group law over a HostExt field."""

    def __init__(self, F: HostExt, a, b):
        self.F = F
        self.a = a
        self.b = b

    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        F = self.F
        x, y = P
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        return F.sqr(y) == rhs

    def neg(self, P):
        if P is None:
            return None
        x, y = P
        return (x, self.F.sub(self.F.zero, y))

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        F = self.F
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if F.add(y1, y2) == F.zero:
                return None
            lam = F.mul(F.add(F.smul(3, F.sqr(x1)), self.a), F.inv(F.smul(2, y1)))
        else:
            lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, k: int, P):
        if P is None or k == 0:
            return None
        if k < 0:
            return self.mul(-k, self.neg(P))
        R = None
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            k >>= 1
        return R

    def msm(self, scalars, points, scalar_bits: int = 753):
        """sum_i scalars[i] * points[i] by the bucket method over exact ints."""
        n = len(points)
        if n == 0:
            return None
        c = max(2, n.bit_length() - 2)
        mask = (1 << c) - 1
        acc = None
        for w in reversed(range((scalar_bits + c - 1) // c)):
            if acc is not None:
                for _ in range(c):
                    acc = self.add(acc, acc)
            buckets = [None] * (1 << c)
            for s, P in zip(scalars, points):
                d = (s >> (w * c)) & mask
                if d:
                    buckets[d] = self.add(buckets[d], P)
            run = total = None
            for b in range(mask, 0, -1):
                run = self.add(run, buckets[b])
                total = self.add(total, run)
            acc = self.add(acc, total)
        return acc


@dataclass
class HostCurve:
    """The curve's host-side algebra and generators."""

    name: str
    fr_spec: PrimeSpec
    fq_spec: PrimeSpec
    g1: HostGroup
    g2: HostGroup
    g1_gen: tuple
    g2_gen: tuple


def mnt4753_host() -> HostCurve:
    q = FIELD_B.p
    fq = HostExt(q, 1, 0)
    fq2 = HostExt(q, 2, m4.FQ2_NON_RESIDUE)
    g1 = HostGroup(fq, m4.G1_COEFF_A, m4.G1_COEFF_B % q)
    # twist coefficients (mnt4753_init.cpp:122-126)
    a2 = (m4.G1_COEFF_A * m4.FQ2_NON_RESIDUE % q, 0)
    b2 = (0, m4.G1_COEFF_B * m4.FQ2_NON_RESIDUE % q)
    g2 = HostGroup(fq2, a2, b2)
    return HostCurve(
        "MNT4753", FIELD_A, FIELD_B, g1, g2,
        (m4.G1_ONE_X % q, m4.G1_ONE_Y % q),
        ((m4.G2_ONE_X0 % q, m4.G2_ONE_X1 % q), (m4.G2_ONE_Y0 % q, m4.G2_ONE_Y1 % q)),
    )


def mnt6753_host() -> HostCurve:
    q = FIELD_A.p  # q(MNT6753) == r(MNT4753)
    fq = HostExt(q, 1, 0)
    fq3 = HostExt(q, 3, m6.FQ3_NON_RESIDUE)
    g1 = HostGroup(fq, m6.G1_COEFF_A, m6.G1_COEFF_B % q)
    # twist coefficients (mnt6753_init.cpp:133-137)
    a3 = (0, 0, m6.G1_COEFF_A % q)
    b3 = (m6.G1_COEFF_B * m6.FQ3_NON_RESIDUE % q, 0, 0)
    g2 = HostGroup(fq3, a3, b3)
    return HostCurve(
        "MNT6753", FIELD_B_SMALL, FIELD_A, g1, g2,
        (m6.G1_ONE_X % q, m6.G1_ONE_Y % q),
        ((m6.G2_ONE_X0 % q, m6.G2_ONE_X1 % q, m6.G2_ONE_X2 % q),
         (m6.G2_ONE_Y0 % q, m6.G2_ONE_Y1 % q, m6.G2_ONE_Y2 % q)),
    )


_HOST_CURVES = {"MNT4753": mnt4753_host, "MNT6753": mnt6753_host}


def host_curve(name: str) -> HostCurve:
    if name not in _HOST_CURVES:
        raise NotImplementedError(f"host curve {name}")
    return _HOST_CURVES[name]()
