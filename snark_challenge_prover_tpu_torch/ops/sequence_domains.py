"""Geometric and arithmetic sequence evaluation domains.

Counterpart of the JAX package's ``ops/sequence_domains.py`` (libfqfft's
geometric_sequence_domain.tcc and arithmetic_sequence_domain.tcc): where a
size fits none of the radix-2 family, ``get_evaluation_domain`` evaluates
and interpolates on a plain point sequence, geometric x_i = 2^i
(geometric_generator, fp.tcc:292-297) or arithmetic x_i = i
(arithmetic_generator, fp.tcc:301-306).

The transforms are dense: the evaluation matrix V[j, i] = x_j^i and its
exact inverse (the Lagrange basis's coefficients) are built once a domain
in exact host integers, kept on the device in Montgomery form, and applied
there as one Montgomery product per entry (``Fp.mul``) and a halving sum
of each row (``Fp.add``): O(n^2) field operations, exact, so the words equal
the JAX package's, which sums the same products in another order.

``divide_by_z_on_coset`` divides entry j by Z(g x_j), deliberately as the
JAX package does (its module docstring): that is the correct quotient step
on a domain where Z is not constant on the coset.  The reference divides
every entry by the constant Z(g) (geometric_sequence_domain.tcc:249-257).
``evaluate_all_lagrange_polynomials`` and ``add_poly_Z`` serve the key
generator, on host integers.
"""

from __future__ import annotations

import torch

from ..utils.bigint import ints_to_words
from .fft import _Domain, batch_inverse, host_table
from .field import Fp

# Montgomery products a pass of _apply: bounds its working memory to about
# 2^22 lanes of 24 words (and their widened temporaries)
_APPLY_LANES = 1 << 22


def _vanishing_coeffs(points: list[int], p: int) -> list[int]:
    """Z(x) = prod (x - x_i), coefficients low to high, degree n."""
    Z = [1]
    for x in points:
        Z = [(-x * Z[0]) % p] + [(Z[k - 1] - x * Z[k]) % p for k in range(1, len(Z))] + [1]
    return Z


def _lagrange_coeff_matrix(points: list[int], p: int, scale: int = 1) -> list[list[int]]:
    """M[k][j] = scale * coefficient k of L_j(x) = (Z / (x - x_j)) / Z'(x_j),
    by synthetic division of the vanishing polynomial: O(n^2) host integers
    (scale = R gives the Montgomery form at no extra product)."""
    n = len(points)
    Z = _vanishing_coeffs(points, p)
    M = [[0] * n for _ in range(n)]
    for j, xj in enumerate(points):
        q = [0] * n  # Z / (x - x_j), degree n - 1
        carry = Z[n]
        for k in range(n - 1, -1, -1):
            q[k] = carry
            carry = (Z[k] + xj * carry) % p
        d = 0  # Z'(x_j) = q(x_j)
        for k in range(n - 1, -1, -1):
            d = (d * xj + q[k]) % p
        dinv = pow(d, -1, p) * scale % p
        for k in range(n):
            M[k][j] = q[k] * dinv % p
    return M


def _sum_last(F: Fp, x: torch.Tensor) -> torch.Tensor:
    """(24, r, n) -> (24, r), the sum over the last axis by halving (an odd
    length carries its last column to the next level)."""
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        s = F.add(x[..., :half], x[..., half : 2 * half])
        x = torch.cat([s, x[..., 2 * half :]], dim=-1) if n % 2 else s
        n = x.shape[-1]
    return x[..., 0]


class _SequenceDomain(_Domain):
    """Dense evaluation and interpolation on a list of points."""

    def __init__(self, F: Fp, points: list[int]):
        self.F = F
        self.n = self.m = len(points)
        self.points = points
        self.g = F.spec.multiplicative_generator
        self._tables: dict = {}

    def _matrix(self, key: str) -> torch.Tensor:
        """(24, n, n) Montgomery words, entry [:, j, i] the weight of input i
        in output j, built at first use (the reference's do_precomputation,
        geometric_sequence_domain.tcc:260-275)."""
        if key not in self._tables:
            F, p, n = self.F, self.F.p, self.n
            R = F.spec.R  # the entries are built in Montgomery form
            if key == "eval":  # V[j, i] = x_j^i
                flat = []
                for x in self.points:
                    v = R
                    for _ in range(n):
                        flat.append(v)
                        v = v * x % p
            else:  # coefficient k of the interpolant: sum_j M[k][j] a_j
                flat = [v for row in _lagrange_coeff_matrix(self.points, p, R) for v in row]
            words = torch.from_numpy(ints_to_words(flat))
            self._tables[key] = words.to(F.device).reshape(24, n, n)
        return self._tables[key]

    def _apply(self, W: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """out[j] = sum_i W[j, i] a[i], in passes of whole rows."""
        F, n = self.F, self.n
        rows = max(1, _APPLY_LANES // n)
        return torch.cat([_sum_last(F, F.mul(W[:, r : r + rows], a[:, None, :]))
                          for r in range(0, n, rows)], dim=1)

    def fft(self, a):
        """coefficients -> evaluations at [x_j]."""
        return self._apply(self._matrix("eval"), a)

    def ifft(self, a):
        """evaluations -> coefficients."""
        return self._apply(self._matrix("interp"), a)

    def divide_by_z_on_coset(self, a):
        """Entry j divided by Z(g x_j) (see the module docstring: deliberate,
        as the JAX package does)."""
        F, p = self.F, self.F.p
        if "zinv" not in self._tables:
            zs = [self.compute_vanishing_polynomial(self.g * x % p) for x in self.points]
            if any(z == 0 for z in zs):
                # a coset point inside the domain: always so for the arithmetic
                # sequence, whose x_0 = 0 every multiplicative coset fixes
                raise ValueError("coset intersects the domain; Z not invertible")
            self._tables["zinv"] = host_table(F, batch_inverse(zs, p))
        return F.mul(a, self._tables["zinv"])

    def get_domain_element(self, i: int) -> int:
        return self.points[i]

    def compute_vanishing_polynomial(self, t: int) -> int:
        """Z(t) = prod (t - x_i)."""
        p, Z = self.F.p, 1
        for x in self.points:
            Z = Z * (t - x) % p
        return Z

    def add_poly_Z(self, coeff: int, H: list):
        """H += coeff * Z, Z = prod (x - x_i) of degree m (len(H) == m + 1)."""
        if len(H) != self.m + 1:
            raise ValueError("add_poly_Z expects len(H) == m+1")
        p = self.F.p
        for k, z in enumerate(_vanishing_coeffs(self.points, p)):
            H[k] = (H[k] + coeff * z) % p

    def evaluate_all_lagrange_polynomials(self, t: int) -> list:
        """[L_j(t)] = Z(t) / ((t - x_j) prod_{k != j} (x_j - x_k)), the
        inverses by Montgomery's trick; the indicator of t where t is a
        domain point (geometric_sequence_domain.tcc:143-155)."""
        p = self.F.p
        t %= p
        if t in self.points:
            return [int(x == t) for x in self.points]
        dens = []
        for j, xj in enumerate(self.points):
            d = t - xj
            for k, xk in enumerate(self.points):
                if k != j:
                    d = d * (xj - xk) % p
            dens.append(d)
        z = self.compute_vanishing_polynomial(t)
        return [z * v % p for v in batch_inverse(dens, p)]


class GeometricSequenceDomain(_SequenceDomain):
    """x_i = geometric_generator^i = 2^i (fp.tcc:292)."""

    def __init__(self, F: Fp, m: int):
        if m <= 1:
            raise ValueError("GeometricSequenceDomain needs m > 1")
        p = F.p
        pts, v = [], 1
        for _ in range(m):
            pts.append(v)
            v = v * 2 % p
        if len(set(pts)) != m:
            raise ValueError("geometric sequence has repeated points")
        super().__init__(F, pts)


class ArithmeticSequenceDomain(_SequenceDomain):
    """x_i = arithmetic_generator * i = i (fp.tcc:301)."""

    def __init__(self, F: Fp, m: int):
        if m <= 1:
            raise ValueError("ArithmeticSequenceDomain needs m > 1")
        if m >= F.p:
            raise ValueError("domain larger than field")
        super().__init__(F, [i % F.p for i in range(m)])
