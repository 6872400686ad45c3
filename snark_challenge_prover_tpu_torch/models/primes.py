"""The two 753-bit primes of the MNT4753/MNT6753 cycle and derived numerics.

The curve cycle shares its primes: r(MNT4753) = q(MNT6753) and
q(MNT4753) = r(MNT6753) (depends/libff/.../mnt4753_init.cpp:48,75 and
mnt6753_init.cpp:50,79).  Everything else (Montgomery constants, 2-adic
root towers, small-subgroup roots) is derived here with exact host
integer arithmetic instead of being copied — the derivations are checked
against the reference's published decimal constants in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

# r(MNT4753) == q(MNT6753): 2-adicity s=30 (mnt4753_init.cpp:65)
P_MNT4_R = int(
    "418984909679189534023442147912406371281707099199539490717835029210253528125711067730588937637903389214180709718884584773231730574915938550696962418547963961657214163253500644414704181378463984696119357190599081642207844761"
    "60001"
)

# q(MNT4753) == r(MNT6753): 2-adicity s=15, small subgroup 5^2 on the
# MNT6753-Fr side (mnt4753_init.cpp:75, mnt6753_init.cpp:66,73-76)
P_MNT4_Q = int(
    "418984909679189534023442147912406371281707099199539490717835029210253528125711067730588937637903389214180709718882537861143537265295843852015916057220131264689314043479498405430079863277434628537206280516921412653031147216"
    "89601"
)

R_BITS = 768  # the wire format's Montgomery R = 2^768 (12x64-bit limbs,
              # libff fp.tcc mul_reduce for n=12); limb width is free


@lru_cache(maxsize=None)
def _r_inverse(p: int) -> int:
    """R^-1 mod p, once a modulus."""
    return pow(1 << R_BITS, -1, p)


def _two_adicity(n: int):
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s, n


@dataclass(frozen=True)
class PrimeSpec:
    """Exact host-side numerics for one prime field."""

    p: int
    multiplicative_generator: int
    nqr: int  # quadratic non-residue (used as extension non-residue seed)
    small_subgroup_base: int = 0   # 0 = not defined
    small_subgroup_power: int = 0

    @property
    def R(self) -> int:
        return (1 << R_BITS) % self.p

    @property
    def R2(self) -> int:
        return (self.R * self.R) % self.p

    @property
    def n_prime(self) -> int:
        # -p^{-1} mod 2^768 (per-limb variant of libff Fp_model::inv)
        return (-pow(self.p, -1, 1 << R_BITS)) % (1 << R_BITS)

    @property
    def s(self) -> int:
        """2-adicity of p-1 after removing the small subgroup part."""
        s, _ = _two_adicity(self.p - 1)
        return s

    @property
    def t(self) -> int:
        """Odd cofactor: p - 1 == 2^s * t."""
        _, t = _two_adicity(self.p - 1)
        return t

    @property
    def root_of_unity(self) -> int:
        """g^t — a primitive 2^s-th root of unity (mnt4753_init.cpp:69)."""
        return pow(self.multiplicative_generator, self.t, self.p)

    @property
    def full_root_of_unity(self) -> int:
        """Primitive (2^s * base^power)-th root for small-subgroup fields
        (mnt6753_init.cpp:76)."""
        if not self.small_subgroup_base:
            raise ValueError("no small subgroup")
        order = (1 << self.s) * self.small_subgroup_base ** self.small_subgroup_power
        assert (self.p - 1) % order == 0
        return pow(self.multiplicative_generator, (self.p - 1) // order, self.p)

    def get_root_of_unity(self, n: int) -> int:
        """omega for a size-n evaluation domain, matching libff
        get_root_of_unity (field_utils.tcc:40-89) exactly."""
        two_adicity, rest = _two_adicity(n)
        if self.small_subgroup_base:
            q = self.small_subgroup_base
            q_adicity = 0
            while rest % q == 0:
                rest //= q
                q_adicity += 1
            if rest != 1 or two_adicity > self.s or q_adicity > self.small_subgroup_power:
                raise ValueError(f"bad domain size {n}")
            omega = self.full_root_of_unity
            for _ in range(self.small_subgroup_power - q_adicity):
                omega = pow(omega, q, self.p)
            for _ in range(self.s - two_adicity):
                omega = omega * omega % self.p
            return omega
        if rest != 1:
            raise ValueError(f"domain size {n} not a power of two")
        if two_adicity > self.s:
            raise ValueError(f"2-adicity of {n} exceeds field 2-adicity {self.s}")
        omega = self.root_of_unity
        for _ in range(self.s - two_adicity):
            omega = omega * omega % self.p
        return omega

    def to_mont(self, x: int) -> int:
        return (x % self.p) * self.R % self.p

    def from_mont(self, x: int) -> int:
        return x * _r_inverse(self.p) % self.p


# Field specs as used by each curve (generator/nqr from mnt4753_init.cpp:68-70,
# 94-96 and mnt6753_init.cpp:69-75, 98-100).
FIELD_A = PrimeSpec(p=P_MNT4_R, multiplicative_generator=17, nqr=11)  # MNT4753 Fr, MNT6753 Fq
FIELD_B = PrimeSpec(p=P_MNT4_Q, multiplicative_generator=17, nqr=13)  # MNT4753 Fq
# MNT6753's Fr is FIELD_B with the 5^2 small subgroup enabled
# (mnt6753_init.cpp:73-76): domains of size 2^a * 5^b, a <= 15, b <= 2.
FIELD_B_SMALL = PrimeSpec(
    p=P_MNT4_Q, multiplicative_generator=17, nqr=13,
    small_subgroup_base=5, small_subgroup_power=2,
)
