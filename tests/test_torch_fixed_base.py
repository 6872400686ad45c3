"""The port's fixed-base exponentiation, wNAF, inversions and affine form
on device="cpu".

``find_wnaf`` and ``get_exp_window_size`` against the JAX package's; the
window table (12-bit scalars, every entry), ``batch_exp`` on 12-bit
scalars and ``opt_window_wnaf_exp`` over G1 and G2 of both curves, and
``batch_exp`` and ``batch_exp_with_coeff`` (one coefficient, and one a
scalar) on full 753-bit scalars 0, 1, 2, random and r - 1 over one group a
curve, against exact host scalar multiplication; ``inv`` / ``batch_inv``
over Fp, Fp2 and Fp3 with zero lanes and ``mul_base`` against exact
integers; ``to_affine`` with identity lanes.  The JAX package's table, walk
and ``batch_exp`` are not run: under ``jax.jit`` they compile for minutes."""

import random

import pytest
import torch

from snark_challenge_prover_tpu.ops import fixed_base as jax_fb
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import fixed_base as fb
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words, words_to_ints

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
GROUPS = [(c, g) for c in MODELS for g in ("G1", "G2")]
IDS = [f"{c}-{g}" for c, g in GROUPS]


def _setup(name, group):
    model = MODELS[name].get("cpu")
    hc = host_curve(name)
    if group == "G1":
        return model, model.G1, model.g1_generator(), hc.g1, hc.g1_gen
    return model, model.G2, model.g2_generator(), hc.g2, hc.g2_gen


def _ints(F, t):
    """Montgomery words (24, n) -> canonical ints."""
    return [F.spec.from_mont(v) for v in words_to_ints(t.reshape(24, -1).numpy())]


def _host_points(model, curve, P):
    """Projective batch (n,) -> host affine points (None for Z = 0), by host inverses."""
    Fq, hF = model.Fq, host_curve(model.name).g2.F
    if curve.deg == 1:
        X, Y, Z = (_ints(Fq, t) for t in P)
        return [None if z == 0 else (x * pow(z, -1, Fq.p) % Fq.p, y * pow(z, -1, Fq.p) % Fq.p)
                for x, y, z in zip(X, Y, Z)]
    X, Y, Z = (list(zip(*(_ints(Fq, c) for c in t))) for t in P)
    return [None if hF.is_zero(z) else (hF.mul(x, hF.inv(z)), hF.mul(y, hF.inv(z)))
            for x, y, z in zip(X, Y, Z)]


def _words(values):
    return torch.from_numpy(ints_to_words(values))


# ---------------------------------------------------------------------------
# host helpers against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [2, 3, 5, 7, 8])
def test_find_wnaf_matches_jax(window):
    r = mnt4753.FIELD_A.p
    rng = random.Random(window)
    for s in [0, 1, 2, 3, 2 ** 752 + 1, r - 1] + [rng.randrange(r) for _ in range(8)]:
        assert fb.find_wnaf(window, s) == jax_fb.find_wnaf(window, s)


def test_get_exp_window_size_matches_jax():
    sizes = [1, 2, 4, 5, 7, 8, 9, 31, 32, 33, 1000, 2 ** 20, 2 ** 20 + 1, 4 * 2 ** 20, 2 ** 30]
    assert [fb.get_exp_window_size(n) for n in sizes] == [jax_fb.get_exp_window_size(n) for n in sizes]


# ---------------------------------------------------------------------------
# the table, batch_exp and the walk against exact multiplication
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,group", GROUPS, ids=IDS)
def test_window_table_entries(name, group):
    """Every entry of a 12-bit table of 3-bit windows: T[w, j] = j 2^(3w) P."""
    model, curve, gen, hg, hgen = _setup(name, group)
    base = curve.double(gen, times=2)  # 4 G
    T = fb.get_window_table(curve, 3, base, scalar_bits=12)
    assert T[0].shape[-2:] == (4, 8)
    got = _host_points(model, curve, tuple(t.flatten(-2) for t in T))
    assert got == [hg.mul(4 * j << (3 * w), hgen) for w in range(4) for j in range(8)]


@pytest.mark.parametrize("name,group", GROUPS, ids=IDS)
def test_batch_exp_small_scalars(name, group):
    """batch_exp over a 12-bit table of 3-bit windows: 0, 1, 2, a random
    scalar and 2^12 - 1, in a (2, 3) batch."""
    model, curve, gen, hg, hgen = _setup(name, group)
    T = fb.get_window_table(curve, 3, gen, scalar_bits=12)
    scal = [0, 1, 2, random.Random(12).randrange(1 << 12), (1 << 12) - 1, 7]
    got = fb.batch_exp(curve, 3, T, _words(scal).reshape(24, 2, 3), scalar_bits=12)
    flat = tuple(t.reshape(t.shape[:curve.F.elem_ndim] + (6,)) for t in got)
    assert _host_points(model, curve, flat) == [hg.mul(s, hgen) for s in scal]


# one group a curve at full width: Fq2 (MNT4753 G2) and Fp (MNT6753 G1); the
# key generator's test covers the other two at full width
FULL_GROUPS = [("MNT4753", "G2"), ("MNT6753", "G1")]


@pytest.fixture(scope="module", params=FULL_GROUPS, ids=[f"{c}-{g}" for c, g in FULL_GROUPS])
def full_table(request):
    """One 753-bit table of 5-bit windows over the generator (151 rows; its
    cost is the chain of 750 doublings that any 753-bit table needs)."""
    model, curve, gen, hg, hgen = _setup(*request.param)
    return model, curve, fb.get_window_table(curve, 5, gen), hg, hgen


def _scalars(model):
    r = model.Fr.p
    return [0, 1, 2, random.Random(r % 1000).randrange(r), r - 1]


def test_batch_exp(full_table):
    model, curve, T, hg, hgen = full_table
    scal = _scalars(model)
    got = fb.batch_exp(curve, 5, T, _words(scal))
    assert _host_points(model, curve, got) == [hg.mul(s, hgen) for s in scal]


def test_batch_exp_with_coeff(full_table):
    model, curve, T, hg, hgen = full_table
    Fr, r = model.Fr, model.Fr.p
    scal = _scalars(model)
    coeff = random.Random(5).randrange(r)
    mont = _words([Fr.spec.to_mont(s) for s in scal])
    got = fb.batch_exp_with_coeff(curve, 5, T, Fr.const(coeff), mont, Fr)
    assert _host_points(model, curve, got) == [hg.mul(coeff * s % r, hgen) for s in scal]


def test_batch_exp_with_a_coefficient_a_scalar(full_table):
    """The key generator's form: one coefficient a scalar, (24, N)."""
    model, curve, T, hg, hgen = full_table
    Fr, r = model.Fr, model.Fr.p
    scal = _scalars(model)
    rng = random.Random(6)
    coeffs = [1, rng.randrange(r), 0, rng.randrange(r), r - 1]
    mont = _words([Fr.spec.to_mont(s) for s in scal])
    cm = _words([Fr.spec.to_mont(c) for c in coeffs])
    got = fb.batch_exp_with_coeff(curve, 5, T, cm, mont, Fr)
    assert _host_points(model, curve, got) == [hg.mul(c * s % r, hgen) for c, s in zip(coeffs, scal)]


def test_batch_exp_refuses_another_window(full_table):
    model, curve, T, _, _ = full_table
    with pytest.raises(ValueError, match="not one of 6-bit windows"):
        fb.batch_exp(curve, 6, T, _words([1]))


@pytest.mark.parametrize("name,group", GROUPS, ids=IDS)
def test_opt_window_wnaf_exp(name, group):
    """0, 1, 2 and a random 96-bit scalar (negative digits included); the
    753-bit walk is the key generator's (tests/test_torch_keygen.py)."""
    model, curve, gen, hg, hgen = _setup(name, group)
    s96 = random.Random(96).getrandbits(96) | 1 << 95
    for s in (0, 1, 2, s96):
        if s == s96:
            assert any(d < 0 for d in fb.find_wnaf(4, s))
        P = fb.opt_window_wnaf_exp(curve, gen, s)
        assert _host_points(model, curve, tuple(t.unsqueeze(-1) for t in P)) == [hg.mul(s, hgen)]


@pytest.mark.parametrize("name", list(MODELS))
def test_g1_wnaf_at_r_minus_one(name):
    model, curve, gen, hg, hgen = _setup(name, "G1")
    P = fb.opt_window_wnaf_exp(curve, gen, model.Fr.p - 1)
    assert _host_points(model, curve, tuple(t.unsqueeze(-1) for t in P)) == [hg.neg(hgen)]


# ---------------------------------------------------------------------------
# inversions and the affine form
# ---------------------------------------------------------------------------
def _field_values(p, n, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(p) for _ in range(n)]
    vals[1], vals[-2], vals[-1] = 0, 1, p - 1
    return vals


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("n", [1, 6, 13])
def test_fp_inv_and_batch_inv(name, n):
    F = MODELS[name].get("cpu").Fq
    p = F.p
    vals = _field_values(p, max(n, 3), n)[:n] if n > 1 else [0]
    a = _words([F.spec.to_mont(v) for v in vals])
    want = [pow(v, -1, p) if v else 0 for v in vals]
    assert _ints(F, F.batch_inv(a)) == want
    assert _ints(F, F.batch_inv(a.reshape(24, 1, n).expand(24, 2, n)).reshape(24, 2, n)[:, 1]) == want
    if n == 6:
        assert _ints(F, F.inv(a)) == want
        assert _ints(F, F.pow_int(a, 5)) == [pow(v, 5, p) for v in vals]
        assert _ints(F, F.pow_int(a, 0)) == [1] * n


@pytest.mark.parametrize("name", list(MODELS))
def test_extension_inv_batch_inv_and_mul_base(name):
    model = MODELS[name].get("cpu")
    E = model.G2.F
    hF = host_curve(name).g2.F
    p, deg = E.base.p, E.deg
    comps = [_field_values(p, 7, 10 + c) for c in range(deg)]
    for c in comps:
        c[0] = 0  # lane 0 is zero
    comps[0][3] = 0  # lane 3 has one zero component
    elems = list(zip(*comps))
    a = torch.stack([_words([E.base.spec.to_mont(v) for v in c]) for c in comps])
    want = [hF.zero if hF.is_zero(e) else hF.inv(e) for e in elems]
    for got in (E.batch_inv(a), E.inv(a)):
        assert list(zip(*(_ints(E.base, c) for c in got))) == want
    s = _field_values(p, 7, 99)
    got = E.mul_base(a, _words([E.base.spec.to_mont(v) for v in s]))
    assert list(zip(*(_ints(E.base, c) for c in got))) == [hF.smul(k, e) for k, e in zip(s, elems)]


@pytest.mark.parametrize("name,group", GROUPS, ids=IDS)
def test_to_affine_with_identity_lanes(name, group):
    """Projective points with random Z, and identity lanes (0, 1, 0) and
    (0, y, 0): (x, y, 1), and (0, 1, 0) for the identity; one point alone
    through the single inverse."""
    model, curve, gen, hg, hgen = _setup(name, group)
    F = curve.F
    pts = fb._doubling_levels(curve, gen, 3)  # j G for j < 8; lane 0 the identity
    rng = random.Random(7)
    Z = torch.stack([_words([model.Fq.spec.to_mont(rng.randrange(1, model.Fq.p))
                             for _ in range(8)]) for _ in range(curve.deg)])
    Z = Z[0] if curve.deg == 1 else Z
    P = (F.mul(pts[0], Z), F.mul(pts[1], Z), F.mul(pts[2], Z))
    P[1][..., 0] = F.ones((1,))[..., 0]
    P[1][..., 0] = F.double(P[1][..., 0:1])[..., 0]  # identity lane (0, 2, 0)
    x, y, z = curve.to_affine(P)
    ident = curve.is_zero(P)
    assert ident.tolist() == [True] + [False] * 7
    assert torch.equal(z, F.select(ident, F.zeros((8,)), F.ones((8,))))
    assert torch.equal(x[..., 0], F.zeros(())) and torch.equal(y[..., 0], F.ones(()))
    assert _host_points(model, curve, (x, y, z)) == [hg.mul(j, hgen) for j in range(8)]
    one = curve.to_affine(tuple(t[..., 5] for t in P))
    assert all(torch.equal(a, b[..., 5]) for a, b in zip(one, (x, y, z)))
