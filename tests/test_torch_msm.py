"""The port's staged MSM on device="cpu".

``window_digits`` against the JAX package's; the MSMs against the exact
integer groups of tools/oracle.py, compared as affine points (the
projective representative depends on the summation order, the group
element does not).  No JAX MSM is compiled."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.ops import msm as jax_msm
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch.convert import tensor_from_planes
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import msm as port_msm
from snark_challenge_prover_tpu_torch.ops.limbs import from_planes16
from snark_challenge_prover_tpu_torch.proof_systems.groth16 import (
    _g1_proj_to_host, _g2_proj_to_host)
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)


def _scalars(n, rng, r):
    return [0, 1, r - 1] + [rng.randrange(r) for _ in range(n - 3)]


@pytest.mark.parametrize("c", [4, 5, 16])
def test_window_digits_match_jax_and_ints(c):
    r = orc.ORACLES["MNT4753"]().fr_spec.p
    vals = _scalars(24, random.Random(c), r)
    planes = ints_to_limbs(vals).reshape(48, 2, 12)
    want = np.asarray(jax_msm.window_digits(jnp.asarray(planes), c))
    got = port_msm.window_digits(from_planes16(planes), c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    W = (753 + c - 1) // c
    ints = [[(v >> (w * c)) & ((1 << c) - 1) for v in vals] for w in range(W)]
    assert got.reshape(W, 24).tolist() == ints
    # a subset of windows, out of order, with one past the top
    sel = port_msm.window_digits(from_planes16(planes), c, windows=[W, 3, 0])
    assert not sel[0].any()
    assert torch.equal(sel[1:], got[[3, 0]])


def test_default_window_bits():
    assert [port_msm.default_window_bits(n) for n in (1, 8, 1 << 12, 1 << 20, 1 << 24)] == [
        jax_msm.default_window_bits(n) for n in (1, 8, 1 << 12, 1 << 20, 1 << 24)]


def _setup(grp, n, rng, curve="MNT4753"):
    ocur = orc.ORACLES[curve]()
    og, gen = (ocur.g1, ocur.g1_gen) if grp == "g1" else (ocur.g2, ocur.g2_gen)
    P = og.mul(rng.randrange(2, 1 << 30), gen)
    step = og.mul(rng.randrange(2, 1 << 30), gen)
    pts = []
    for _ in range(n):
        pts.append(P)
        P = og.add(P, step)
    return ocur, og, pts


def _affine_planes(fqs, pts, coord, deg):
    zero = 0 if deg == 1 else (0,) * deg
    vals = [(zero, zero) if P is None else P for P in pts]
    if deg == 1:
        return ints_to_limbs([fqs.to_mont(v[coord]) for v in vals])
    return np.stack([ints_to_limbs([fqs.to_mont(v[coord][k]) for v in vals]) for k in range(deg)])


def _g1_inputs(pts, ocur):
    model = mnt4753.get("cpu")
    x = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 0, 1), "cpu")
    y = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 1, 1), "cpu")
    return model, model.G1.from_affine(x, y)


def test_msm_multi_staged_g1_matches_oracle():
    rng = random.Random(35)
    N, M = 20, 4
    ocur, og, pts = _setup("g1", N, rng)
    pts[4] = None      # an identity point in the middle (y == 0 on the wire)
    pts[7] = pts[6]    # a repeated point: the scan meets P + P
    r = ocur.fr_spec.p
    model, proj = _g1_inputs(pts, ocur)
    G1 = model.G1
    # four MSMs of different lengths over the same points, as the prover stacks them
    lengths = [N, N, N - 1, N - 2]
    scal = [_scalars(n, rng, r) for n in lengths]
    scal[1][5] = scal[1][6] = 9      # two points in one bucket of every window
    scal[3] = [0] * lengths[3]       # all-zero scalars: the identity
    coords, S = port_msm.pad_and_stack(
        G1, [tuple(t[..., :n] for t in proj) for n in lengths],
        [from_planes16(ints_to_limbs(s)) for s in scal])
    assert tuple(coords[0].shape) == (24, M, N) and tuple(S.shape) == (24, M, N)
    out = port_msm.msm_multi_staged(G1, coords, S, c=4)
    got = [_g1_proj_to_host(model, tuple(t[..., i] for t in out)) for i in range(M)]
    assert got[:3] == [og.msm(scal[i], pts[: lengths[i]]) for i in range(3)]
    assert got[3] is None


def test_msm_staged_window_groups_and_odd_window():
    """83-bit scalars, c = 5, 7 windows per group: 17 windows padded to 21,
    the top one holding 3 bits."""
    rng = random.Random(36)
    N = 6
    ocur, og, pts = _setup("g1", N, rng)
    model, proj = _g1_inputs(pts, ocur)
    scal = _scalars(N, rng, 1 << 83)
    out = port_msm.msm_staged(model.G1, proj, from_planes16(ints_to_limbs(scal)), c=5,
                              window_group=7, scalar_bits=83)
    assert _g1_proj_to_host(model, out) == og.msm(scal, pts)


def test_msm_staged_g2_matches_oracle():
    rng = random.Random(5)
    N = 6
    ocur, og, pts = _setup("g2", N, rng)
    pts[2] = None
    model = mnt4753.get("cpu")
    G2 = model.G2
    x = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 0, 2), "cpu")
    y = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 1, 2), "cpu")
    scal = _scalars(N, rng, 1 << 64)  # short scalars: 16 windows instead of 189
    out = port_msm.msm_staged(G2, G2.from_affine(x, y), from_planes16(ints_to_limbs(scal)), c=4,
                              scalar_bits=64)
    assert _g2_proj_to_host(model, out) == og.msm(scal, pts)


def test_mnt6753_msm_staged_g2_matches_oracle():
    """The Fq3 G2, with an identity point, a repeated point and a zero scalar."""
    rng = random.Random(6)
    N = 6
    ocur, og, pts = _setup("g2", N, rng, "MNT6753")
    pts[2] = None
    pts[4] = pts[3]
    model = mnt6753.get("cpu")
    G2 = model.G2
    x = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 0, 3), "cpu")
    y = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 1, 3), "cpu")
    assert tuple(x.shape) == (3, 24, N)
    scal = _scalars(N, rng, 1 << 64)  # short scalars: 16 windows instead of 189
    out = port_msm.msm_staged(G2, G2.from_affine(x, y), from_planes16(ints_to_limbs(scal)), c=4,
                              scalar_bits=64)
    assert _g2_proj_to_host(model, out) == og.msm(scal, pts)


def test_mnt6753_msm_multi_staged_g1_matches_oracle():
    """G1 of MNT6753 (a = 11, the other modulus), two MSMs stacked."""
    rng = random.Random(7)
    N = 6
    ocur, og, pts = _setup("g1", N, rng, "MNT6753")
    model = mnt6753.get("cpu")
    G1 = model.G1
    x = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 0, 1), "cpu")
    y = tensor_from_planes(_affine_planes(ocur.fq_spec, pts, 1, 1), "cpu")
    proj = G1.from_affine(x, y)
    scal = [_scalars(N, rng, 1 << 64), _scalars(N - 1, rng, 1 << 64)]
    coords, S = port_msm.pad_and_stack(
        G1, [proj, tuple(t[..., : N - 1] for t in proj)],
        [from_planes16(ints_to_limbs(s)) for s in scal])
    out = port_msm.msm_multi_staged(G1, coords, S, c=4, scalar_bits=64)
    got = [_g1_proj_to_host(model, tuple(t[..., i] for t in out)) for i in range(2)]
    assert got == [og.msm(scal[0], pts), og.msm(scal[1], pts[: N - 1])]


def test_scan_and_reduce_against_sequential_sums():
    rng = random.Random(8)
    n = 7  # odd: exercises the tail handling
    ocur, og, pts = _setup("g1", n, rng)
    model, proj = _g1_inputs(pts, ocur)
    G1 = model.G1
    host = lambda T, i: _g1_proj_to_host(model, tuple(t[..., i] for t in T))
    run, prefix = None, []
    for P in pts:
        run = og.add(run, P)
        prefix.append(run)
    scan = port_msm._ec_scan(G1, proj)
    assert [host(scan, i) for i in range(n)] == prefix
    run, suffix = None, []
    for P in reversed(pts):
        run = og.add(run, P)
        suffix.append(run)
    rscan = port_msm._ec_scan(G1, proj, reverse=True)
    assert [host(rscan, i) for i in range(n)] == suffix[::-1]
    total = port_msm._ec_reduce(G1, proj)
    assert _g1_proj_to_host(model, total) == prefix[-1]


def test_horner_doubles_once_a_window():
    """The Horner step makes its c doublings in one call (one kernel launch
    on the card) a window: W calls of times = c, and the sum is still the
    oracle's."""
    rng = random.Random(37)
    N = 5
    ocur, og, pts = _setup("g1", N, rng)
    model, proj = _g1_inputs(pts, ocur)
    G1 = model.G1
    calls = []
    double = G1.double
    G1.double = lambda P, times=1: (calls.append(times), double(P, times))[1]
    scal = _scalars(N, rng, 1 << 83)
    out = port_msm.msm_staged(G1, proj, from_planes16(ints_to_limbs(scal)), c=6, scalar_bits=83)
    assert calls == [6] * 14  # W = ceil(83 / 6)
    assert _g1_proj_to_host(model, out) == og.msm(scal, pts)
