"""Polynomial arithmetic over the scalar fields.

Counterpart of the JAX package's ``ops/polynomial.py`` (libfqfft's
polynomial_arithmetic/ and kronecker_substitution/: naive evaluation, the
basic operations, xgcd, Kronecker substitution).  Coefficients are exact
host integers mod p, little-endian (index = degree), and every function but
``multiplication_fft`` is host code, copied.  ``multiplication_fft`` pads
to a power of two and runs on the field's device: the coefficients go up
as canonical words and into Montgomery form by one ``F.from_canonical``,
then two ``fft``, one ``F.mul`` and one ``ifft`` of the port's evaluation
domain (``ops/fft.get_evaluation_domain``), and one ``F.to_canonical``
back; every product is a K1 launch on the card.
"""

from __future__ import annotations

from ..utils.bigint import words_to_ints
from .fft import get_evaluation_domain
from .field import Fp, canonical_words


def _trim(a: list, p: int) -> list:
    a = [x % p for x in a]
    while len(a) > 1 and a[-1] == 0:
        a.pop()
    return a


def evaluate_polynomial(coeffs, t: int, p: int) -> int:
    """Horner evaluation (polynomial_arithmetic/naive_evaluate.tcc)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * t + c) % p
    return acc


def evaluate_lagrange_polynomial(domain_points, evals, t: int, p: int) -> int:
    """Interpolate through (x_i, y_i) and evaluate at t
    (naive_evaluate.tcc evaluate_lagrange_polynomial)."""
    acc = 0
    n = len(domain_points)
    for i in range(n):
        num = 1
        den = 1
        for j in range(n):
            if i == j:
                continue
            num = num * ((t - domain_points[j]) % p) % p
            den = den * ((domain_points[i] - domain_points[j]) % p) % p
        acc = (acc + evals[i] * num % p * pow(den, -1, p)) % p
    return acc


def addition(a, b, p: int) -> list:
    """basic_operations.tcc _polynomial_addition."""
    n = max(len(a), len(b))
    out = [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) for i in range(n)]
    return _trim(out, p)


def subtraction(a, b, p: int) -> list:
    n = max(len(a), len(b))
    out = [(a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0) for i in range(n)]
    return _trim(out, p)


def multiplication_naive(a, b, p: int) -> list:
    """basic_operations.tcc _polynomial_multiplication_naive."""
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if not ai:
            continue
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return _trim(out, p)


def multiplication_fft(F: Fp, a, b) -> list:
    """_polynomial_multiplication_on_fft: pad to the power of two that
    covers deg(a) + deg(b) + 1 and multiply the evaluations pointwise, on
    F's device."""
    p = F.p
    need = len(a) + len(b) - 1
    n = 1
    while n < need:
        n *= 2
    dom = get_evaluation_domain(F, n)

    def up(coeffs):
        padded = [c % p for c in coeffs] + [0] * (n - len(coeffs))
        return F.from_canonical(canonical_words(F, padded))

    prod = dom.ifft(F.mul(dom.fft(up(a)), dom.fft(up(b))))
    out = words_to_ints(F.to_canonical(prod).cpu().numpy())
    return _trim(out[:need], p)


def multiplication(F: Fp, a, b, naive_threshold: int = 64) -> list:
    if len(a) + len(b) <= naive_threshold:
        return multiplication_naive(a, b, F.p)
    return multiplication_fft(F, a, b)


def division(a, b, p: int):
    """Euclidean division: a = q*b + r (basic_operations.tcc
    _polynomial_division).  Returns (q, r)."""
    a = _trim(list(a), p)
    b = _trim(list(b), p)
    if b == [0]:
        raise ZeroDivisionError
    q = [0] * max(1, len(a) - len(b) + 1)
    r = list(a)
    inv_lead = pow(b[-1], -1, p)
    while len(r) >= len(b) and _trim(r, p) != [0]:
        shift = len(r) - len(b)
        c = r[-1] * inv_lead % p
        if c == 0:
            r.pop()
            continue
        q[shift] = c
        for i, bi in enumerate(b):
            r[shift + i] = (r[shift + i] - c * bi) % p
        r.pop()
    return _trim(q, p), _trim(r if r else [0], p)


def xgcd(a, b, p: int):
    """Extended Euclid over F_p[x] (xgcd.tcc _polynomial_xgcd):
    returns (g, u, v) monic with u*a + v*b = g."""
    r0, r1 = _trim(list(a), p), _trim(list(b), p)
    s0, s1 = [1], [0]
    t0, t1 = [0], [1]
    while r1 != [0]:
        q, r = division(r0, r1, p)
        r0, r1 = r1, r
        s0, s1 = s1, subtraction(s0, multiplication_naive(q, s1, p), p)
        t0, t1 = t1, subtraction(t0, multiplication_naive(q, t1, p), p)
    # normalize to monic gcd
    lead = r0[-1]
    if lead not in (0, 1):
        li = pow(lead, -1, p)
        r0 = [c * li % p for c in r0]
        s0 = [c * li % p for c in s0]
        t0 = [c * li % p for c in t0]
    return r0, s0, t0


def kronecker_substitution(a, b, p: int) -> list:
    """Multiply via packing into one big integer (kronecker_substitution.tcc):
    each coefficient gets 2*bits(p) + log2(min_len) bits of room, then one
    native bigint multiply and an unpack — the host-CPU analogue of the
    reference's GMP fast path."""
    if not a or not b:
        return [0]
    bits = 2 * p.bit_length() + max(1, min(len(a), len(b)).bit_length())
    mask = (1 << bits) - 1
    pa = 0
    for c in reversed(a):
        pa = (pa << bits) | (c % p)
    pb = 0
    for c in reversed(b):
        pb = (pb << bits) | (c % p)
    prod = pa * pb
    out = []
    for _ in range(len(a) + len(b) - 1):
        out.append((prod & mask) % p)
        prod >>= bits
    return _trim(out, p)
