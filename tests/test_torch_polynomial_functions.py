"""The port's polynomial arithmetic (``ops/polynomial.py``) and batched
modular functions (``ops/functions.py``) against the JAX package's, on the
same inputs drawn from a seed with numpy, and against exact Python integers:

  * the host polynomial functions (evaluation, Lagrange interpolation,
    addition, subtraction, naive multiplication, division, xgcd, Kronecker
    substitution) give the JAX functions' results;
  * ``multiplication_fft`` at the JAX test's sizes (degrees 5 and 4)
    equals the JAX function's and the naive product; ``multiplication``
    switches to it above 64 coefficients in all, as the JAX one does;
  * ``modexp``, ``multi_modexp``, ``modinv`` on MNT4753 Fr and Fq and
    MNT6753 Fr, ``quorem``, ``divexact`` and ``chinese`` at batch 4: the
    port's words are the JAX package's limb planes, and the values are the
    Python integers';
  * the Paillier demo round-trips.

Every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.ops import functions as jax_fn
from snark_challenge_prover_tpu.ops import polynomial as jax_poly
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs, limbs_to_ints
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import functions as fn
from snark_challenge_prover_tpu_torch.ops import polynomial as poly
from snark_challenge_prover_tpu_torch.ops.field import canonical_words
from snark_challenge_prover_tpu_torch.ops.limbs import to_planes16
from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints

torch.set_num_threads(1)

BATCH = 4
FIELDS = {"MNT4753.Fr": (jax_mnt4753, mnt4753, "Fr"), "MNT4753.Fq": (jax_mnt4753, mnt4753, "Fq"),
          "MNT6753.Fr": (jax_mnt6753, mnt6753, "Fr")}


def fields(name):
    jm, pm, attr = FIELDS[name]
    return getattr(jm.get(), attr), getattr(pm.get("cpu"), attr)


def draw(seed: int, n: int, bits: int = 768, mod: int | None = None) -> list:
    """n integers below 2^bits (then reduced mod ``mod``) from numpy's generator."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, -(-bits // 32)),
                                                 dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % (1 << bits) for row in words]
    return [v % mod for v in vals] if mod else vals


def port_ints(x: torch.Tensor) -> list:
    return words_to_ints(x.numpy())


def same(port: torch.Tensor, jax_planes) -> bool:
    """The port's words are the JAX limb planes, bit for bit."""
    return np.array_equal(to_planes16(port), np.asarray(jax_planes))


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------

def test_host_polynomial_functions_match_jax():
    p = mnt4753.get("cpu").Fr.p
    a, b = draw(1, 10, mod=p), draw(2, 7, mod=p)
    t = draw(3, 1, mod=p)[0]
    for name in ("addition", "subtraction", "multiplication_naive", "kronecker_substitution",
                 "division", "xgcd"):
        got = getattr(poly, name)(a, b, p)
        assert got == getattr(jax_poly, name)(a, b, p), name
    assert poly.evaluate_polynomial(a, t, p) == jax_poly.evaluate_polynomial(a, t, p)
    pts = draw(4, 5, mod=p)
    assert (poly.evaluate_lagrange_polynomial(pts, b[:5], t, p)
            == jax_poly.evaluate_lagrange_polynomial(pts, b[:5], t, p))
    # exact integers: the product at t, the division identity, the gcd's cofactors
    m = poly.multiplication_naive(a, b, p)
    assert poly.evaluate_polynomial(m, t, p) == (poly.evaluate_polynomial(a, t, p)
                                                 * poly.evaluate_polynomial(b, t, p) % p)
    q, r = poly.division(a, b, p)
    assert poly.addition(poly.multiplication_naive(q, b, p), r, p) == poly._trim(a, p)
    g, u, v = poly.xgcd(a, b, p)
    assert poly.addition(poly.multiplication_naive(u, a, p), poly.multiplication_naive(v, b, p),
                         p) == g


def test_multiplication_fft_matches_jax():
    JF, F = fields("MNT4753.Fr")
    a, b = draw(10, 6, mod=F.p), draw(11, 5, mod=F.p)
    got = poly.multiplication_fft(F, a, b)
    assert got == poly.multiplication_naive(a, b, F.p)
    assert got == jax_poly.multiplication_fft(JF, a, b)


@pytest.mark.parametrize("sizes", [(33, 31), (33, 32)])
def test_multiplication_switches_at_the_threshold(sizes):
    """63 coefficients in all go naive, 65 through a domain of 64."""
    F = fields("MNT4753.Fr")[1]
    a, b = draw(12, sizes[0], mod=F.p), draw(13, sizes[1], mod=F.p)
    got = poly.multiplication(F, a, b)
    assert got == jax_poly.kronecker_substitution(a, b, F.p)
    assert got == (poly.multiplication_fft(F, a, b) if sum(sizes) > 64
                   else poly.multiplication_naive(a, b, F.p))


# ---------------------------------------------------------------------------
# batched modular functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", FIELDS)
def test_modexp_matches_jax(field):
    JF, F = fields(field)
    p = F.p
    bases, exps = draw(30, BATCH, mod=p), draw(31, BATCH, bits=753)
    base = F.from_canonical(canonical_words(F, bases))
    got = fn.modexp(F, base, canonical_words(F, exps))
    jbase = jnp.asarray(ints_to_limbs([JF.spec.to_mont(v) for v in bases]))
    assert same(got, jax_fn.modexp(JF, jbase, jnp.asarray(ints_to_limbs(exps))))
    assert port_ints(F.to_canonical(got)) == [pow(b, e, p) for b, e in zip(bases, exps)]
    # one base, many exponents
    one = F.from_canonical(canonical_words(F, bases[:1]))
    multi = fn.multi_modexp(F, one, canonical_words(F, exps))
    assert port_ints(F.to_canonical(multi)) == [pow(bases[0], e, p) for e in exps]


@pytest.mark.parametrize("field", FIELDS)
def test_modinv_matches_jax(field):
    JF, F = fields(field)
    p = F.p
    vals = draw(40, BATCH, mod=p)[:-1] + [0]
    got = fn.modinv(F, F.from_canonical(canonical_words(F, vals)))
    jval = jnp.asarray(ints_to_limbs([JF.spec.to_mont(v) for v in vals]))
    assert same(got, jax_fn.modinv(JF, jval))
    assert port_ints(F.to_canonical(got)) == [pow(v, -1, p) if v else 0 for v in vals]


def test_quorem_divexact_match_jax():
    nums, dens = draw(50, BATCH, bits=753), draw(51, BATCH, bits=400)
    q, r = fn.quorem(canonical_words(mnt4753.get("cpu").Fr, nums),
                     canonical_words(mnt4753.get("cpu").Fr, dens))
    jq, jr = jax_fn.quorem(jnp.asarray(ints_to_limbs(nums)), jnp.asarray(ints_to_limbs(dens)))
    assert same(q, jq) and same(r, jr)
    assert port_ints(q) == [n // d for n, d in zip(nums, dens)]
    assert port_ints(r) == [n % d for n, d in zip(nums, dens)]
    quots = draw(52, BATCH, bits=370)
    dens = draw(53, BATCH, bits=370)
    prods = [a * b for a, b in zip(quots, dens)]
    F = mnt4753.get("cpu").Fr
    got = fn.divexact(canonical_words(F, prods), canonical_words(F, dens))
    assert same(got, jax_fn.divexact(jnp.asarray(ints_to_limbs(prods)),
                                     jnp.asarray(ints_to_limbs(dens))))
    assert port_ints(got) == quots


@pytest.mark.parametrize("pair", [("MNT4753.Fr", "MNT4753.Fq"), ("MNT4753.Fq", "MNT4753.Fr")])
def test_chinese_matches_jax(pair):
    (JF1, F1), (JF2, F2) = fields(pair[0]), fields(pair[1])
    xs = draw(60, BATCH, bits=1536, mod=F1.p * F2.p)
    a, b = [x % F1.p for x in xs], [x % F2.p for x in xs]
    got = fn.chinese(F1, F2, canonical_words(F2, a), canonical_words(F2, b))
    assert got.shape == (48, BATCH)
    want = jax_fn.chinese(JF1, JF2, jnp.asarray(ints_to_limbs(a)), jnp.asarray(ints_to_limbs(b)))
    assert same(got, want)
    assert limbs_to_ints(np.asarray(want)) == xs
    assert [int.from_bytes(got[:, i].numpy().astype("<u4").tobytes(), "little")
            for i in range(BATCH)] == xs


def test_paillier_demo():
    pp, qq = 1000003, 1000033
    n, lam = pp * qq, (pp - 1) * (qq - 1)
    rng = random.Random(7)
    m, r = rng.randrange(n), rng.randrange(1, n)
    c = fn.paillier_encrypt(n, n + 1, m, r)
    assert c == jax_fn.paillier_encrypt(n, n + 1, m, r)
    assert fn.paillier_decrypt(n, lam, c) == m
