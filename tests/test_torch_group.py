"""The port's Curve on device="cpu" (plain group-law versions).

G1: limb for limb against the JAX package's jitted ``Curve._add_flat`` /
``_double_flat`` at batch 8 (what its fused kernel is itself held to),
with the edge lanes identity P, identity Q, P = Q and Q = -P; k doublings
in one call against k calls of ``_double_flat``.
G2: against the same formulas (Renes-Costello-Batina complete addition,
dbl-2007-bl) evaluated over Fq2 (MNT4753) and Fq3 (MNT6753) with Python
integers in this file.  Then the kernel declarations of each curve group
against the compiled sources and the curve's constants."""

import dataclasses
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs, limbs_to_ints
from snark_challenge_prover_tpu_torch.convert import planes_from_port, tensor_from_planes
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import cuda_group
from snark_challenge_prover_tpu_torch.ops.group import Curve
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

N = 8
MODELS = {"MNT4753": (jax_mnt4753, mnt4753), "MNT6753": (jax_mnt6753, mnt6753)}


def _points(group, gen, rng):
    P = group.mul(rng.randrange(2, 1 << 30), gen)
    step = group.mul(rng.randrange(2, 1 << 30), gen)
    out = []
    for _ in range(N):
        out.append(P)
        P = group.add(P, step)
    return out


def _planes(fqs, pts, coord, deg):
    if deg == 1:
        return ints_to_limbs([fqs.to_mont(P[coord]) for P in pts])
    return np.stack([ints_to_limbs([fqs.to_mont(P[coord][c]) for P in pts]) for c in range(deg)])


def _edge_lanes(curve, P, Q, where):
    """identity P, identity Q, P == Q (doubling), Q == -P in lanes 0..3."""
    zero = curve.zero((N,))
    lane = lambda i: where(i)
    P = curve.select(lane(0), zero, P)
    Q = curve.select(lane(1), zero, Q)
    Q = curve.select(lane(2), P, Q)
    return P, curve.select(lane(3), curve.neg(P), Q)


def _g1_case(name):
    jax_model, port_model = MODELS[name]
    rng = random.Random(1234)
    ocur = orc.ORACLES[name]()
    fqs = ocur.fq_spec
    pts, pts2 = _points(ocur.g1, ocur.g1_gen, rng), _points(ocur.g1, ocur.g1_gen, rng)
    planes = [_planes(fqs, pts, 0, 1), _planes(fqs, pts, 1, 1),
              _planes(fqs, pts2, 0, 1), _planes(fqs, pts2, 1, 1)]

    GJ = jax_model.get().G1
    x1, y1, x2, y2 = (jnp.asarray(t) for t in planes)
    PJ, QJ = _edge_lanes(GJ, GJ.from_affine(x1, y1), GJ.from_affine(x2, y2),
                         lambda i: jnp.arange(N) == i)
    GT = port_model.get("cpu").G1
    x1, y1, x2, y2 = (tensor_from_planes(t, "cpu") for t in planes)
    PT, QT = _edge_lanes(GT, GT.from_affine(x1, y1), GT.from_affine(x2, y2),
                         lambda i: torch.arange(N) == i)
    return GJ, PJ, QJ, GT, PT, QT


@pytest.fixture(scope="module")
def g1_case():
    return _g1_case("MNT4753")


@pytest.fixture(scope="module")
def g1_case_mnt6753():
    return _g1_case("MNT6753")


def test_g1_from_affine_and_edge_lanes_match_jax(g1_case):
    _, PJ, QJ, _, PT, QT = g1_case
    for j, t in zip((*PJ, *QJ), (*PT, *QT)):
        np.testing.assert_array_equal(planes_from_port(t), np.asarray(j))


def _check_g1_add(case):
    GJ, PJ, QJ, GT, PT, QT = case
    want = jax.jit(GJ._add_flat)(PJ, QJ)
    got = GT.add(PT, QT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(planes_from_port(g), np.asarray(w))
    assert GT.is_zero(got).tolist() == [False, False, False, True] + [False] * (N - 4)


_JITTED_DOUBLE = {}


def _jax_double(GJ):
    """The JAX doubling of this curve object, jitted once per test process."""
    if id(GJ) not in _JITTED_DOUBLE:
        _JITTED_DOUBLE[id(GJ)] = (GJ, jax.jit(GJ._double_flat))
    return _JITTED_DOUBLE[id(GJ)][1]


def _check_g1_double(case):
    GJ, PJ, _, GT, PT, _ = case
    want = _jax_double(GJ)(PJ)
    got = GT.double(PT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(planes_from_port(g), np.asarray(w))
    assert GT.is_zero(got).tolist() == [True] + [False] * (N - 1)


def _check_g1_doubles(case, k):
    """k doublings in one call equal k calls of the JAX doubling (jitted once)."""
    GJ, PJ, _, GT, PT, _ = case
    dbl = _jax_double(GJ)
    want = PJ
    for _ in range(k):
        want = dbl(want)
    got = GT.double(PT, times=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(planes_from_port(g), np.asarray(w))
    assert GT.is_zero(got).tolist() == [True] + [False] * (N - 1)


def test_g1_add_matches_jax_limb_for_limb(g1_case):
    _check_g1_add(g1_case)


def test_g1_double_matches_jax_limb_for_limb(g1_case):
    _check_g1_double(g1_case)


def test_mnt6753_g1_add_matches_jax_limb_for_limb(g1_case_mnt6753):
    _check_g1_add(g1_case_mnt6753)


def test_mnt6753_g1_double_matches_jax_limb_for_limb(g1_case_mnt6753):
    _check_g1_double(g1_case_mnt6753)


@pytest.mark.parametrize("k", [2, 5])
def test_g1_doubles_match_repeated_jax_doubling(g1_case, k):
    _check_g1_doubles(g1_case, k)


@pytest.mark.parametrize("k", [2, 5])
def test_mnt6753_g1_doubles_match_repeated_jax_doubling(g1_case_mnt6753, k):
    _check_g1_doubles(g1_case_mnt6753, k)


# ---- the two formulas over a field given by exact-integer add/sub/mul -------
def _rcb_add(F, a, b3, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = F.mul(X1, X2), F.mul(Y1, Y2), F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t4 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    t5 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.sub(t4, F.add(t0, t2))
    t5 = F.sub(t5, F.add(t1, t2))
    b3t2, at4, t2a, t4b = F.mul(b3, t2), F.mul(a, t4), F.mul(a, t2), F.mul(b3, t4)
    Z3 = F.add(b3t2, at4)
    X3 = F.sub(t1, Z3)
    Z3 = F.add(t1, Z3)
    t1 = F.add(F.add(F.add(t0, t0), t0), t2a)
    Y3 = F.mul(X3, Z3)
    t4 = F.add(t4b, F.mul(a, F.sub(t0, t2a)))
    return (F.sub(F.mul(t3, X3), F.mul(t5, t4)), F.add(Y3, F.mul(t1, t4)),
            F.add(F.mul(t5, Z3), F.mul(t3, t1)))


def _dbl_2007_bl(F, a, P):
    X1, Y1, Z1 = P
    if F.is_zero(X1) and F.is_zero(Z1):
        return P
    XX, ZZ = F.mul(X1, X1), F.mul(Z1, Z1)
    s = F.smul(2, F.mul(Y1, Z1))
    ss, R = F.mul(s, s), F.mul(Y1, s)
    w = F.add(F.mul(a, ZZ), F.smul(3, XX))
    RR = F.mul(R, R)
    XR = F.add(X1, R)
    B = F.sub(F.sub(F.mul(XR, XR), XX), RR)
    h = F.sub(F.mul(w, w), F.smul(2, B))
    return (F.mul(h, s), F.sub(F.mul(w, F.sub(B, h)), F.smul(2, RR)), F.mul(s, ss))


def _proj_ints(fqs, P, deg):
    """Port tensors -> per-lane projective tuples of canonical ints."""
    def coord(t):
        planes = planes_from_port(t)
        if deg == 1:
            return [fqs.from_mont(v) for v in limbs_to_ints(planes)]
        comps = [[fqs.from_mont(v) for v in limbs_to_ints(planes[c])] for c in range(deg)]
        return list(zip(*comps))
    return list(zip(*(coord(t) for t in P)))


@pytest.mark.parametrize("grp,deg", [("g1", 1), ("g2", 2)])
def test_add_and_double_match_integer_formulas(grp, deg):
    _check_integer_formulas("MNT4753", grp, deg)


@pytest.mark.parametrize("grp,deg", [("g1", 1), ("g2", 3)])
def test_mnt6753_add_and_double_match_integer_formulas(grp, deg):
    _check_integer_formulas("MNT6753", grp, deg)


def _check_integer_formulas(name, grp, deg):
    rng = random.Random(99 + deg)
    ocur = orc.ORACLES[name]()
    og, gen = (ocur.g1, ocur.g1_gen) if grp == "g1" else (ocur.g2, ocur.g2_gen)
    fqs = ocur.fq_spec
    model = MODELS[name][1].get("cpu")
    assert model.G2.deg == {"MNT4753": 2, "MNT6753": 3}[name]
    curve = model.G1 if grp == "g1" else model.G2
    pts, pts2 = _points(og, gen, rng), _points(og, gen, rng)
    xy = [tensor_from_planes(_planes(fqs, ps, c, deg), "cpu") for ps in (pts, pts2) for c in (0, 1)]
    P, Q = _edge_lanes(curve, curve.from_affine(xy[0], xy[1]), curve.from_affine(xy[2], xy[3]),
                       lambda i: torch.arange(N) == i)
    F = og.F
    b3 = F.smul(3, og.b)
    Pi, Qi = _proj_ints(fqs, P, deg), _proj_ints(fqs, Q, deg)
    assert _proj_ints(fqs, curve.add(P, Q), deg) == [
        _rcb_add(F, og.a, b3, p, q) for p, q in zip(Pi, Qi)]
    assert _proj_ints(fqs, curve.double(P), deg) == [_dbl_2007_bl(F, og.a, p) for p in Pi]
    # four doublings in one call: the formula four times, the identity kept
    want4 = Pi
    for _ in range(4):
        want4 = [_dbl_2007_bl(F, og.a, p) for p in want4]
    assert _proj_ints(fqs, curve.double(P, times=4), deg) == want4
    # and as group elements: the affine results are the oracle's
    def affine(T):
        X, Y, Z = T
        if F.is_zero(Z):
            return None
        zi = F.inv(Z)
        return (F.mul(X, zi), F.mul(Y, zi))
    want = [pts2[0], pts[1], og.add(pts[2], pts[2]), None] + [
        og.add(p, q) for p, q in zip(pts[4:], pts2[4:])]
    assert [affine(T) for T in _proj_ints(fqs, curve.add(P, Q), deg)] == want


# ---- the addition kernels: one instantiation per curve group ---------------
GROUPS = [("MNT4753", "G1"), ("MNT4753", "G2"), ("MNT6753", "G1"), ("MNT6753", "G2")]
CSRC = Path(cuda_group.__file__).resolve().parent.parent / "csrc"


def _random_elements(curve, rng, n=8):
    deg, p = curve.deg, curve.F.base.p if curve.deg > 1 else curve.F.p
    vals = [p - 1] * deg + [rng.randrange(p) for _ in range((n - 1) * deg)]
    t = torch.from_numpy(ints_to_words(vals)).reshape(24, n, deg).permute(2, 0, 1)
    return t[0].contiguous() if deg == 1 else t.contiguous()


@pytest.mark.parametrize("name,group,want", [
    ("MNT4753", "G1", ("ec_add_fp_mnt4753", 2, 0, 0)),
    ("MNT4753", "G2", ("ec_add_fp2_mnt4753", 26, 0, 1)),   # a' = (26, 0), 3b' = (0, c)
    ("MNT6753", "G1", ("ec_add_fp_mnt6753", 11, 0, 0)),
    ("MNT6753", "G2", ("ec_add_fp3_mnt6753", 11, 2, 0)),   # a' = 11 u^2, 3b' = (c, 0, 0)
])
def test_add_kernel_table_gives_each_curve_group_its_instantiation(name, group, want):
    curve = getattr(MODELS[name][1].get("cpu"), group)
    form = cuda_group.add_kernel(curve)
    assert (form.launcher, form.a_k, form.a_s, form.b3_s) == want


def test_add_kernel_table_matches_the_compiled_source():
    """Every addition kernel a model declares is one of ec_add.cu's
    instantiations, with the same degree, non-residue, small a and 3b
    pattern, and the modulus compiled into it is the curve's."""
    src = (CSRC / "ec_add.cu").read_text()
    inst = {m[0]: m[1:] for m in re.findall(
        r"X\((\w+), (\w+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", src)}
    hdr = (CSRC / "fp753_fast.cuh").read_text()
    moduli = {}
    for mod, body, n0 in re.findall(r"struct (Mod\w+) \{.*?W24\{\{(.*?)\}\}.*?n0 = (0x[0-9a-f]+)u",
                                    hdr, re.S):
        words = [int(w.rstrip("u"), 16) for w in body.replace("\n", " ").split(",")]
        moduli[mod] = (sum(w << (32 * i) for i, w in enumerate(words)), int(n0, 16))
    declared = []
    for name, group in GROUPS:
        curve = getattr(MODELS[name][1].get("cpu"), group)
        form = cuda_group.add_kernel(curve)
        declared.append(form.launcher)
        mod, *ints = inst[form.launcher]
        d, nr, a_k, a_s, b3_s = map(int, ints)
        p = curve.F.p if curve.deg == 1 else curve.F.base.p
        assert moduli[mod] == (p, (-pow(p, -1, 1 << 32)) % (1 << 32))
        assert (d, a_k, a_s, b3_s) == (curve.deg, form.a_k, form.a_s, form.b3_s)
        if d > 1:
            assert nr == curve.F.nr
    assert sorted(declared) == sorted(inst)


@pytest.mark.parametrize("name,group", GROUPS)
def test_sparse_products_equal_products_by_the_full_constants(name, group):
    curve = getattr(MODELS[name][1].get("cpu"), group)
    F = curve.F
    x = _random_elements(curve, random.Random(f"{name} {group}"))
    const = lambda c: c.reshape(c.shape + (1,))
    for form in (curve.add_form, curve.dbl_form):
        assert torch.equal(cuda_group._mul_a(curve, F, [x], form)[0], F.mul(const(curve.a), x))
    assert torch.equal(cuda_group._mul_b3(curve, F, [x])[0], F.mul(const(curve.b3), x))


@pytest.mark.parametrize("name,group", [("MNT4753", "G1"), ("MNT6753", "G2")])
def test_curve_with_general_constants_has_no_add_kernel(name, group):
    """A curve outside the table gets no entry, the kernel's selector
    raises for it (so its CUDA tensors would), and on the CPU the plain
    version adds with full products by a and 3b."""
    rng = random.Random(7)
    model = MODELS[name][1].get("cpu")
    old = getattr(model, group)
    ocur = orc.ORACLES[name]()
    F = ocur.g1.F if old.deg == 1 else ocur.g2.F
    a, b = ([rng.randrange(ocur.fq_spec.p) for _ in range(old.deg)] for _ in range(2))
    as_tensor = lambda vs: model.Fq.const(vs[0]) if old.deg == 1 else torch.stack(
        [model.Fq.const(v) for v in vs])
    curve = Curve(old.F, as_tensor(a), as_tensor(b), "cpu", "general")
    assert curve.add_form is None
    with pytest.raises(RuntimeError, match="no addition kernel"):
        cuda_group.add_kernel(curve)
    P = tuple(_random_elements(curve, rng, 4) for _ in range(3))
    Q = tuple(_random_elements(curve, rng, 4) for _ in range(3))
    ca, cb = (a[0], b[0]) if old.deg == 1 else (tuple(a), tuple(b))
    fqs = ocur.fq_spec
    want = [_rcb_add(F, ca, F.smul(3, cb), pp, qq)
            for pp, qq in zip(_proj_ints(fqs, P, old.deg), _proj_ints(fqs, Q, old.deg))]
    assert _proj_ints(fqs, curve.add(P, Q), old.deg) == want


@pytest.mark.parametrize("name,group,change", [
    ("MNT4753", "G1", dict(a_k=3)),
    ("MNT4753", "G2", dict(b3_s=0)),
    ("MNT6753", "G1", dict(b3_s=1)),
    ("MNT6753", "G2", dict(a_s=0)),
    ("MNT6753", "G2", dict(a_k=121)),
])
def test_curve_refuses_an_add_kernel_that_does_not_fit_its_constants(name, group, change):
    """A declared addition kernel whose a or 3b differs from the curve's
    (another small a, another monomial degree, a degree out of range) is
    refused when the curve is made, not found out in a wrong sum."""
    old = getattr(MODELS[name][1].get("cpu"), group)
    wrong = dataclasses.replace(old.add_form, **change)
    with pytest.raises(ValueError, match="built in"):
        Curve(old.F, old.a, old.b, "cpu", old.name, wrong)


# ---- the doubling kernels: one instantiation per curve group ---------------
@pytest.mark.parametrize("name,group,want", [
    ("MNT4753", "G1", ("ec_dbl_fp_mnt4753", 2, 0)),
    ("MNT4753", "G2", ("ec_dbl_fp2_mnt4753", 26, 0)),   # a' = (26, 0)
    ("MNT6753", "G1", ("ec_dbl_fp_mnt6753", 11, 0)),
    ("MNT6753", "G2", ("ec_dbl_fp3_mnt6753", 11, 2)),   # a' = 11 u^2
])
def test_dbl_kernel_table_gives_each_curve_group_its_instantiation(name, group, want):
    curve = getattr(MODELS[name][1].get("cpu"), group)
    form = cuda_group.dbl_kernel(curve)
    assert (form.launcher, form.a_k, form.a_s) == want


def test_dbl_kernel_table_matches_the_compiled_source():
    """Every doubling kernel a model declares is one of ec_dbl.cu's
    instantiations, with the same degree, non-residue and small a, and
    the modulus of the addition kernel of the same group."""
    dbl = {m[0]: m[1:] for m in re.findall(
        r"X\((ec_dbl_\w+), (\w+), (\d+), (\d+), (\d+), (\d+)\)", (CSRC / "ec_dbl.cu").read_text())}
    add = {m[0]: m[1:] for m in re.findall(
        r"X\((ec_add_\w+), (\w+), (\d+), (\d+), (\d+), (\d+), (\d+)\)",
        (CSRC / "ec_add.cu").read_text())}
    declared = []
    for name, group in GROUPS:
        curve = getattr(MODELS[name][1].get("cpu"), group)
        form = cuda_group.dbl_kernel(curve)
        declared.append(form.launcher)
        mod, *ints = dbl[form.launcher]
        d, nr, a_k, a_s = map(int, ints)
        assert mod == add[cuda_group.add_kernel(curve).launcher][0]
        assert (d, a_k, a_s) == (curve.deg, form.a_k, form.a_s)
        if d > 1:
            assert nr == curve.F.nr
    assert sorted(declared) == sorted(dbl)


@pytest.mark.parametrize("name,group", [("MNT4753", "G2"), ("MNT6753", "G1")])
def test_curve_with_general_constants_has_no_dbl_kernel(name, group):
    """A curve without a declared doubling kernel: the kernel's selector
    raises for it (so its CUDA tensors would), and on the CPU the plain
    version doubles with a full product by a, k times in one call."""
    rng = random.Random(8)
    model = MODELS[name][1].get("cpu")
    old = getattr(model, group)
    ocur = orc.ORACLES[name]()
    F = ocur.g1.F if old.deg == 1 else ocur.g2.F
    a = [rng.randrange(ocur.fq_spec.p) for _ in range(old.deg)]
    a_t = model.Fq.const(a[0]) if old.deg == 1 else torch.stack([model.Fq.const(v) for v in a])
    curve = Curve(old.F, a_t, old.b, "cpu", "general")
    assert curve.dbl_form is None
    with pytest.raises(RuntimeError, match="no doubling kernel"):
        cuda_group.dbl_kernel(curve)
    P = tuple(_random_elements(curve, rng, 4) for _ in range(3))
    want = _proj_ints(ocur.fq_spec, P, old.deg)
    for _ in range(3):
        want = [_dbl_2007_bl(F, a[0] if old.deg == 1 else tuple(a), p) for p in want]
    assert _proj_ints(ocur.fq_spec, curve.double(P, times=3), old.deg) == want


@pytest.mark.parametrize("name,group,change", [
    ("MNT4753", "G1", dict(a_k=3)),
    ("MNT4753", "G2", dict(a_s=1)),
    ("MNT6753", "G2", dict(a_s=0)),
    ("MNT6753", "G2", dict(a_s=3)),
    ("MNT6753", "G2", dict(a_k=121)),
])
def test_curve_refuses_a_dbl_kernel_that_does_not_fit_its_a(name, group, change):
    """A declared doubling kernel whose a differs from the curve's (another
    small a, another monomial degree, a degree out of range) is refused
    when the curve is made."""
    old = getattr(MODELS[name][1].get("cpu"), group)
    wrong = dataclasses.replace(old.dbl_form, **change)
    with pytest.raises(ValueError, match="built in"):
        Curve(old.F, old.a, old.b, "cpu", old.name, old.add_form, wrong)
    assert Curve(old.F, old.a, old.b, "cpu", old.name, old.add_form, old.dbl_form).dbl_form == old.dbl_form


def test_dbl_refuses_bad_arguments():
    G1 = mnt4753.get("cpu").G1
    P = G1.zero((2,))
    for times in (0, -3):
        with pytest.raises(ValueError, match="at least 1"):
            G1.double(P, times=times)
    assert G1.is_zero(G1.double(P, times=3)).tolist() == [True, True]
