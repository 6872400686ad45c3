"""Evaluation domains over the scalar field: radix-2, extended radix-2,
mixed radix 2^a * 5^b and step radix-2, and the domain selection.

Counterpart of ``Radix2Domain``, ``ExtendedRadix2Domain``,
``MixedRadixDomain``, ``StepRadix2Domain``, ``get_evaluation_domain``,
``best_mixed_domain_size`` and ``get_domain_of_min_size`` of the JAX
package's ``ops/fft.py`` (libfqfft's basic_radix2_domain,
extended_radix2_domain, step_radix2_domain, the small-subgroup branch of
its basic domain and get_evaluation_domain.tcc): FFT, iFFT, cosetFFT,
icosetFFT and divide_by_Z_on_coset.  The sequence domains, the last
fallbacks of the selection, are in ``ops/sequence_domains.py``.  Data is
one ``(24, n)`` tensor; each butterfly stage is a reshape, one full-width
Montgomery product and an add/sub.

Tables live on the device and are built there.  Stage s needs the
twiddles w^(j n / 2^(s+1)), j < 2^s, which are a strided view of the last
stage's table [w^j, j < n/2], so one table per direction is kept.  A
table of powers is built by doubling, t[m:2m] = t[:m] * g^m, from
log2(n) host constants.  The mixed-radix domain keeps one table of all n
powers of omega per direction and reads every stage's factors out of it
by index.
"""

from __future__ import annotations

import torch

from ..utils.bigint import ints_to_words
from .field import Fp


def power_table(F: Fp, g: int, n: int) -> torch.Tensor:
    """[g^i for i < n] in Montgomery form, shape (24, n), built on F's
    device with log2(n) products (the JAX package's ``_power_vector``, which
    builds the same words on the host)."""
    t = F.ones((n,))
    m = 1
    while m < n:
        k = min(m, n - m)
        t[:, m : m + k] = F.mul_const(t[:, :k], F.const(pow(g, m, F.p)))
        m *= 2
    return t


def _bit_reverse_perm(n: int, device) -> torch.Tensor:
    logn = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def basic_radix2_fft(F: Fp, a: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Unnormalised in-order radix-2 DIT FFT of a (24, n) tensor;
    ``twiddles`` is [w^j for j < n/2] for the n-th root of unity w
    (basic_radix2_domain_aux.tcc:168-205, one product per stage)."""
    n = a.shape[1]
    a = a.index_select(1, _bit_reverse_perm(n, a.device))
    m = 1
    while m < n:
        x = a.reshape(24, n // (2 * m), 2, m)
        even = x[:, :, 0, :]
        tw = twiddles[:, :: n // (2 * m)]  # (24, m): w_m^j
        t = F.mul(x[:, :, 1, :], tw[:, None, :])
        a = torch.stack([F.add(even, t), F.sub(even, t)], dim=2).reshape(24, n)
        m *= 2
    return a


class _Domain:
    """What the domains share.  The coset is g * domain, g the field's
    multiplicative generator; a subclass sets F, n, g and ``_tables`` and
    gives fft and ifft."""

    def _coset_table(self, inverse: bool) -> torch.Tensor:
        """[g^i] or [g^-i] for i < n, built at first use."""
        key = "icoset" if inverse else "coset"
        if key not in self._tables:
            g = pow(self.g, -1, self.F.p) if inverse else self.g
            self._tables[key] = power_table(self.F, g, self.n)
        return self._tables[key]

    def coset_fft(self, a):
        """evaluate on the coset g * domain."""
        return self.fft(self.F.mul(a, self._coset_table(False)))

    def icoset_fft(self, a):
        """inverse of coset_fft."""
        return self.F.mul(self.ifft(a), self._coset_table(True))

    def divide_by_z_on_coset(self, a):
        """For a subgroup domain Z(g omega^i) = g^n - 1 is constant on the
        coset: multiply by its inverse."""
        p = self.F.p
        zinv = pow(pow(self.g, self.n, p) - 1, -1, p)
        return self.F.mul_const(a, self.F.const(zinv))


class Radix2Domain(_Domain):
    """Size-n multiplicative subgroup domain, n = 2^k, with omega from the
    field's 2-adic root tower (field_utils.tcc:71-89)."""

    def __init__(self, F: Fp, n: int):
        if n & (n - 1) or n < 2:
            raise ValueError("Radix2Domain needs n == 2^k >= 2")
        self.F = F
        self.n = n
        p = F.p
        self.omega = F.spec.get_root_of_unity(n)
        self.omega_inv = pow(self.omega, -1, p)
        self.g = F.spec.multiplicative_generator
        self.n_inv_mont = F.const(pow(n, -1, p))
        self._tables: dict = {}  # built at first use, kept for the domain's life

    def _table(self, key: str) -> torch.Tensor:
        if key not in self._tables:
            base, count = {
                "fwd": (self.omega, self.n // 2),
                "inv": (self.omega_inv, self.n // 2),
            }[key]
            self._tables[key] = power_table(self.F, base, count)
        return self._tables[key]

    def fft(self, a):
        """coefficients -> evaluations at [omega^i]."""
        return basic_radix2_fft(self.F, a, self._table("fwd"))

    def ifft(self, a):
        """evaluations -> coefficients (scaled by 1/n)."""
        out = basic_radix2_fft(self.F, a, self._table("inv"))
        return self.F.mul_const(out, self.n_inv_mont)


class MixedRadixDomain(_Domain):
    """Size-n multiplicative subgroup domain with n = 2^a * 5^b, b > 0: the
    small-subgroup capability of MNT6753's Fr (mnt6753_init.cpp:73-76,
    libfqfft aux.tcc:46-166).

    A decimation-in-time Cooley-Tukey recursion that splits by 2 while the
    size is even and by 5 below that:
        DFT_size(a)[q m + s] = sum_i w_size^((q m + s) i) DFT_m(a[i::split])[s]
    with m = size / split and w_size = omega^(n / size).  A split by 2 is
    one butterfly (w_size^(m + s) = -w_size^s); a split by 5 is four
    products by factors gathered from the table of omega's powers.  The
    arithmetic is exact, so the words equal those of any correct DFT with
    the same omega."""

    def __init__(self, F: Fp, n: int):
        two_part = n & (-n)
        rest = n // two_part
        while rest % 5 == 0:
            rest //= 5
        if rest != 1 or n == two_part:
            raise ValueError(f"size {n} is not 2^a * 5^b with b > 0")
        self.F = F
        self.n = n
        p = F.p
        self.omega = F.spec.get_root_of_unity(n)  # raises beyond 2^s * 5^2
        self.omega_inv = pow(self.omega, -1, p)
        self.g = F.spec.multiplicative_generator
        self.n_inv_mont = F.const(pow(n, -1, p))
        self._tables: dict = {}

    def _omega_table(self, inverse: bool) -> torch.Tensor:
        key = "inv" if inverse else "fwd"
        if key not in self._tables:
            self._tables[key] = power_table(
                self.F, self.omega_inv if inverse else self.omega, self.n)
        return self._tables[key]

    def _rec(self, a, size: int, table):
        """DFT along axis 1 of a (24, size, B) tensor."""
        if size == 1:
            return a
        F = self.F
        split = 2 if size % 2 == 0 else 5
        m = size // split
        B = a.shape[2]
        # a[j * split + i] is element j of substream i: the reshape puts i beside B
        sub = self._rec(a.reshape(24, m, split * B), m, table).reshape(24, m, split, B)
        stride = self.n // size  # w_size^e is entry e * stride of the table
        if split == 2:
            t = F.mul(sub[:, :, 1, :], table[:, : m * stride : stride, None])
            x0 = sub[:, :, 0, :]
            return torch.stack([F.add(x0, t), F.sub(x0, t)], dim=1).reshape(24, size, B)
        k = torch.arange(size, dtype=torch.int64, device=a.device)  # k = q m + s
        out = sub[:, None, :, 0, :].expand(24, split, m, B)  # i = 0: the factor is 1
        for i in range(1, split):
            W = table.index_select(1, (k * i) % size * stride).reshape(24, split, m, 1)
            out = F.add(out, F.mul(sub[:, None, :, i, :], W))
        return out.reshape(24, size, B)

    def _dft(self, a, inverse: bool):
        return self._rec(a.reshape(24, self.n, 1), self.n,
                         self._omega_table(inverse)).reshape(24, self.n)

    def fft(self, a):
        return self._dft(a, False)

    def ifft(self, a):
        return self.F.mul_const(self._dft(a, True), self.n_inv_mont)


class ExtendedRadix2Domain(_Domain):
    """Size-m domain, m = 2^(s+1): the union S + shift * S of two cosets of
    the largest 2-adic subgroup S, shift = g^2 (libfqfft
    extended_radix2_domain.tcc:21-199).  Lets a field of 2-adicity s host a
    domain one power of two beyond its root tower."""

    def __init__(self, F: Fp, m: int):
        if m <= 1 or m & (m - 1) or m.bit_length() - 1 != F.spec.s + 1:
            raise ValueError("ExtendedRadix2Domain needs m == 2^(s+1)")
        self.F = F
        self.n = self.m = m
        self.small_m = m // 2
        p = F.p
        self.omega = F.spec.get_root_of_unity(self.small_m)
        self.omega_inv = pow(self.omega, -1, p)
        self.g = F.spec.multiplicative_generator
        self.shift = self.g * self.g % p
        self.shift_inv = pow(self.shift, -1, p)
        self.shift_to_small_m = pow(self.shift, self.small_m, p)
        self._tables: dict = {}

    def _table(self, key: str) -> torch.Tensor:
        if key not in self._tables:
            base, count = {
                "fwd": (self.omega, self.small_m // 2),
                "inv": (self.omega_inv, self.small_m // 2),
                "shift": (self.shift, self.small_m),
                "ishift": (self.shift_inv, self.small_m),
            }[key]
            self._tables[key] = power_table(self.F, base, count)
        return self._tables[key]

    def fft(self, a):
        """tcc:48-75: fold into two half-size coefficient vectors, one FFT
        for S and one for shift * S."""
        F, sm = self.F, self.small_m
        lo, hi = a[:, :sm], a[:, sm:]
        a0 = F.add(lo, hi)
        a1 = F.mul(F.add(lo, F.mul_const(hi, F.const(self.shift_to_small_m))),
                   self._table("shift"))
        tw = self._table("fwd")
        return torch.cat([basic_radix2_fft(F, a0, tw), basic_radix2_fft(F, a1, tw)], dim=1)

    def ifft(self, a):
        """tcc:77-103 (the 1 / small_m scale is folded into sconst)."""
        F, sm, p = self.F, self.small_m, self.F.p
        tw = self._table("inv")
        a0 = basic_radix2_fft(F, a[:, :sm], tw)
        a1s = F.mul(basic_radix2_fft(F, a[:, sm:], tw), self._table("ishift"))
        sconst = F.const(pow(sm * (1 - self.shift_to_small_m) % p, -1, p))
        t0 = F.mul_const(a0, F.const(self.shift_to_small_m))
        return torch.cat([F.mul_const(F.sub(a1s, t0), sconst),
                          F.mul_const(F.sub(a0, a1s), sconst)], dim=1)

    def divide_by_z_on_coset(self, a):
        """tcc:173-195: Z(x) = (x^sm - 1)(x^sm - shift^sm) takes one value
        on each half of the coset."""
        F, sm, p = self.F, self.small_m, self.F.p
        c_sm = pow(self.g, sm, p)
        s_sm = self.shift_to_small_m
        z0 = (c_sm - 1) * (c_sm - s_sm) % p
        z1 = (c_sm * s_sm - 1) * (c_sm * s_sm - s_sm) % p
        return torch.cat([F.mul_const(a[:, :sm], F.const(pow(z0, -1, p))),
                          F.mul_const(a[:, sm:], F.const(pow(z1, -1, p)))], dim=1)


def host_table(F: Fp, values) -> torch.Tensor:
    """Canonical host integers -> their Montgomery words, (24, len), on F's device."""
    return torch.from_numpy(ints_to_words([F.spec.to_mont(v) for v in values])).to(F.device)


def batch_inverse(values, p: int) -> list:
    """[v^-1 mod p] by Montgomery's trick: one inversion and 3 (n - 1)
    products.  A zero raises ValueError, as pow(0, -1, p) does."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % p
    inv = pow(acc, -1, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % p
        inv = inv * values[i] % p
    return out


def _sum_rows(F: Fp, e: torch.Tensor) -> torch.Tensor:
    """(24, k, s) with k a power of two -> (24, s), the sum over k, by
    halving (exact, so the order of the sums does not show)."""
    k = e.shape[1]
    while k > 1:
        k //= 2
        e = F.add(e[:, :k], e[:, k:])
    return e[:, 0]


class StepRadix2Domain(_Domain):
    """Size-m domain, m = 2^k + 2^r (r < k): the subgroup of size 2^k and
    omega times the subgroup of size 2^r, omega a 2^(k+1)-th root of unity
    (libfqfft step_radix2_domain.tcc:20-276) -- the tightest fit for sizes
    just over a power of two.  Both parts' FFTs are the radix-2 core."""

    def __init__(self, F: Fp, m: int):
        if m <= 1:
            raise ValueError("StepRadix2Domain needs m > 1")
        big_m = 1 << (m.bit_length() - 1)
        small_m = m - big_m
        if small_m == 0 or small_m & (small_m - 1):
            raise ValueError(f"size {m} is not 2^k + 2^r")
        self.F = F
        self.n = self.m = m
        self.big_m = big_m
        self.small_m = small_m
        p = F.p
        self.omega = F.spec.get_root_of_unity(2 * big_m)  # 2^ceil(log2 m)
        self.big_omega = self.omega * self.omega % p
        self.small_omega = F.spec.get_root_of_unity(small_m)
        self.g = F.spec.multiplicative_generator
        self._tables: dict = {}

    def _table(self, key: str) -> torch.Tensor:
        if key not in self._tables:
            p = self.F.p
            base, count = {
                "omega": (self.omega, self.big_m),  # fft's d, ifft's U0 scaling
                "iomega": (pow(self.omega, -1, p), self.small_m),
                "big": (self.big_omega, self.big_m // 2),  # the radix-2 twiddles
                "ibig": (pow(self.big_omega, -1, p), self.big_m // 2),
                "small": (self.small_omega, self.small_m // 2),
                "ismall": (pow(self.small_omega, -1, p), self.small_m // 2),
            }[key]
            self._tables[key] = power_table(self.F, base, count)
        return self._tables[key]

    def fft(self, a):
        """tcc:56-100: c = lo + [hi, 0...] and d = omega^i (lo - [hi, 0...]);
        the big part is FFT(c), the small part FFT(e), e[i] = sum_j d[i + j sm]."""
        F, bm, sm = self.F, self.big_m, self.small_m
        lo, hi = a[:, :bm], a[:, bm:]
        c, d = lo.clone(), lo.clone()
        c[:, :sm] = F.add(lo[:, :sm], hi)
        d[:, :sm] = F.sub(lo[:, :sm], hi)
        d = F.mul(d, self._table("omega"))
        e = _sum_rows(F, d.reshape(24, bm // sm, sm))
        return torch.cat([basic_radix2_fft(F, c, self._table("big")),
                          basic_radix2_fft(F, e, self._table("small"))], dim=1)

    def ifft(self, a):
        """tcc:102-171."""
        F, p, bm, sm = self.F, self.F.p, self.big_m, self.small_m
        U0 = F.mul_const(basic_radix2_fft(F, a[:, :bm], self._table("ibig")),
                         F.const(pow(bm, -1, p)))
        U1 = F.mul_const(basic_radix2_fft(F, a[:, bm:], self._table("ismall")),
                         F.const(pow(sm, -1, p)))
        t = F.mul(U0, self._table("omega")).reshape(24, bm // sm, sm)
        # U1[i] -= sum_{j >= 1} t[i + j sm]: the sum over all j, less j = 0
        U1 = F.add(F.sub(U1, _sum_rows(F, t)), t[:, 0])
        U1 = F.mul(U1, self._table("iomega"))
        half = F.const(pow(2, -1, p))
        lo = U0[:, :sm]
        return torch.cat([F.mul_const(F.add(lo, U1), half), U0[:, sm:],
                          F.mul_const(F.sub(lo, U1), half)], dim=1)

    def divide_by_z_on_coset(self, a):
        """tcc:238-276.  On the big part, at g * big_omega^i,
        Z = Z0 (g^sm w^(2 sm i) - w^sm) with Z0 = g^bm - 1: w^(2 sm) has order
        bm / sm, so one period of inverses (Montgomery's trick on the host)
        is tiled over the big part.  On the small part Z is one constant."""
        F, p, bm, sm = self.F, self.F.p, self.big_m, self.small_m
        c = self.g
        Z0 = (pow(c, bm, p) - 1) % p
        c_sm, w_sm, step = pow(c, sm, p), pow(self.omega, sm, p), pow(self.omega, 2 * sm, p)
        period = bm // sm
        vals, elt = [], 1
        for _ in range(period):
            vals.append(Z0 * (c_sm * elt - w_sm) % p)
            elt = elt * step % p
        inv0 = host_table(F, batch_inverse(vals, p))  # entry i of the big part: inv0[i % period]
        lo = F.mul(a[:, :bm].reshape(24, sm, period), inv0[:, None, :]).reshape(24, bm)
        cw = c * self.omega % p
        Z1 = (pow(cw, bm, p) - 1) * (pow(cw, sm, p) - w_sm) % p
        hi = F.mul_const(a[:, bm:], F.const(pow(Z1, -1, p)))
        return torch.cat([lo, hi], dim=1)

    # ---- host-side scalar helpers -----------------------------------------
    def get_domain_element(self, i: int) -> int:
        p = self.F.p
        if i < self.big_m:
            return pow(self.big_omega, i, p)
        return self.omega * pow(self.small_omega, i - self.big_m, p) % p

    def compute_vanishing_polynomial(self, t: int) -> int:
        """Z(t) = (t^big - 1)(t^small - omega^small)."""
        p = self.F.p
        return (pow(t, self.big_m, p) - 1) * (
            pow(t, self.small_m, p) - pow(self.omega, self.small_m, p)) % p


def get_evaluation_domain(F: Fp, n: int):
    """libfqfft's domain selection in its order of preference
    (get_evaluation_domain.tcc:60-131), as the JAX package has it: basic
    radix-2, extended radix-2, the mixed-radix 2^a * 5^b domain of a field
    with a small subgroup (MNT6753's Fr), step radix-2, then the geometric
    sequence domain (the arithmetic one only where the geometric one cannot
    be built).  A mixed size beyond the field's subgroup raises ValueError."""
    if n >= 2 and (n & (n - 1)) == 0:
        if n.bit_length() - 1 <= F.spec.s:
            return Radix2Domain(F, n)
        if n.bit_length() - 1 == F.spec.s + 1:
            return ExtendedRadix2Domain(F, n)
    if n > 1 and (n & (n - 1)):
        if F.spec.small_subgroup_base:
            q = F.spec.small_subgroup_base
            rest = n // (n & (-n))
            while rest % q == 0:
                rest //= q
            if rest == 1:
                return MixedRadixDomain(F, n)
        big = 1 << (n.bit_length() - 1)
        small = n - big
        if small and not (small & (small - 1)) and n.bit_length() <= F.spec.s:
            return StepRadix2Domain(F, n)
    if n > 1:
        from .sequence_domains import ArithmeticSequenceDomain, GeometricSequenceDomain

        try:
            return GeometricSequenceDomain(F, n)
        except ValueError:
            return ArithmeticSequenceDomain(F, n)
    raise ValueError(f"no evaluation domain of size {n} for this field")


def best_mixed_domain_size(F: Fp, min_size: int) -> int | None:
    """min { n = 2^a * q^b : n >= min_size, b <= small_subgroup_power,
    a <= s } (get_evaluation_domain.tcc:33-57); None without a small subgroup."""
    spec = F.spec
    if not spec.small_subgroup_base:
        return None
    best = None
    for b in range(spec.small_subgroup_power + 1):
        r = spec.small_subgroup_base ** b
        a = 0
        while r < min_size:
            r *= 2
            a += 1
        if a <= spec.s and (best is None or r < best):
            best = r
    return best


def get_domain_of_min_size(F: Fp, min_size: int):
    """Smallest supported domain of size >= min_size, in the reference's
    order (get_evaluation_domain.tcc:60-135): basic / extended / step at
    min_size, then at big + rounded_small, then the best mixed size, then
    the sequence domains.  The domain's ``n`` may exceed min_size."""

    def _try(size):
        try:
            return get_evaluation_domain(F, size)
        except (ValueError, KeyError):
            return None

    d = _try(min_size)
    if d is not None and not _is_sequence_domain(d):
        return d
    # big + rounded_small (tcc:88-108): libff::log2 is the ceiling
    ceil_log2 = max(1, (min_size - 1).bit_length())
    big = 1 << (ceil_log2 - 1)
    small = min_size - big
    if small > 0:
        rounded_small = 1 << max(0, (small - 1).bit_length())
        d = _try(big + rounded_small)
        if d is not None and not _is_sequence_domain(d):
            return d
    mixed = best_mixed_domain_size(F, min_size)
    if mixed is not None:
        d = _try(mixed)
        if d is not None and not _is_sequence_domain(d):
            return d
    return get_evaluation_domain(F, min_size)  # the sequence domains


def _is_sequence_domain(domain) -> bool:
    from .sequence_domains import ArithmeticSequenceDomain, GeometricSequenceDomain

    return isinstance(domain, (GeometricSequenceDomain, ArithmeticSequenceDomain))
