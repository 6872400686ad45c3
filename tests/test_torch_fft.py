"""The port's evaluation domains and compute_h on device="cpu".

Radix2Domain against the JAX package's, under jax.jit, at n = 8 and 16;
MixedRadixDomain (MNT6753's Fr) against the JAX package's at n = 10, a
split by 2 over one by 5, run op by op (compiling its unrolled recursion
takes minutes); both new domains at n = 10, 20, 40, 50 (the 5 over 5
splits) and, the extended one, at its only size 2^16, against
exact-integer evaluation of the polynomial at sampled domain points.
StepRadix2Domain at n = 12 (MNT4753's Fr) and 24 (MNT6753's Fr) and the
geometric and arithmetic sequence domains at n = 7 and 6 against the JAX
package's classes, each JAX operation under its own jax.jit (the JAX
compute_h runs over those); the domain selection against the JAX
package's over a grid of sizes for both fields.  Exact limb equality
throughout."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.ops import fft as jax_fft
from snark_challenge_prover_tpu.ops import sequence_domains as jax_seq
from snark_challenge_prover_tpu.proof_systems import groth16 as jax_groth16
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs, limbs_to_ints
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import fft as port_fft
from snark_challenge_prover_tpu_torch.ops import sequence_domains as port_seq
from snark_challenge_prover_tpu_torch.ops.limbs import from_planes16, to_planes16
from snark_challenge_prover_tpu_torch.proof_systems import groth16 as port_groth16

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

OPS = ["fft", "ifft", "coset_fft", "icoset_fft", "divide_by_z_on_coset"]


def _case(n, mj, mt):
    p = mt.Fr.p
    rng = random.Random(n)
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(3)]
    vals[0][0], vals[0][1] = 0, p - 1
    planes = [ints_to_limbs([mt.Fr.spec.to_mont(v) for v in col]) for col in vals]
    dj = jax_fft.get_evaluation_domain(mj.Fr, n)
    dt = port_fft.get_evaluation_domain(mt.Fr, n)

    def run_jax(a, b, c):
        out = {op: getattr(dj, op)(a) for op in OPS}
        out["compute_h"] = jax_groth16.compute_h(mj, dj, a, b, c)
        return out

    want = jax.jit(run_jax)(*(jnp.asarray(t) for t in planes))
    a, b, c = (from_planes16(t) for t in planes)
    got = {op: getattr(dt, op)(a) for op in OPS}
    got["compute_h"] = port_groth16.compute_h(mt, dt, a, b, c)
    return n, mt.Fr.spec, vals, got, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module", params=[8, 16])
def case(request):
    return _case(request.param, jax_mnt4753.get(), mnt4753.get("cpu"))


@pytest.fixture(scope="module", params=[10])
def mixed_case(request):
    n = request.param
    mj, mt = jax_mnt6753.get(), mnt6753.get("cpu")
    rng = random.Random(n)
    vals = [0, mt.Fr.p - 1] + [rng.randrange(mt.Fr.p) for _ in range(n - 2)]
    planes = ints_to_limbs([mt.Fr.spec.to_mont(v) for v in vals])
    dj = jax_fft.get_evaluation_domain(mj.Fr, n)
    dt = port_fft.get_evaluation_domain(mt.Fr, n)
    assert type(dj).__name__ == type(dt).__name__ == "MixedRadixDomain"
    a = from_planes16(planes)
    want = {op: np.asarray(getattr(dj, op)(jnp.asarray(planes))) for op in OPS}
    return n, mt.Fr.spec, [vals], {op: getattr(dt, op)(a) for op in OPS}, want


@pytest.mark.parametrize("op", OPS + ["compute_h"])
def test_matches_jax_limb_for_limb(case, op):
    _, _, _, got, want = case
    np.testing.assert_array_equal(to_planes16(got[op]), want[op])


def test_fft_is_the_dft(case):
    n, spec, vals, got, _ = case
    p = spec.p
    omega = spec.get_root_of_unity(n)
    want = [sum(c * pow(omega, i * k, p) for k, c in enumerate(vals[0])) % p for i in range(n)]
    assert [spec.from_mont(v) for v in limbs_to_ints(to_planes16(got["fft"]))] == want


def test_power_table_and_domain_selection():
    F = mnt4753.get("cpu").Fr
    t = port_fft.power_table(F, 17, 11)
    assert [F.spec.from_mont(v) for v in limbs_to_ints(to_planes16(t))] == [
        pow(17, i, F.p) for i in range(11)]
    assert isinstance(port_fft.get_evaluation_domain(F, 12), port_fft.StepRadix2Domain)
    with pytest.raises(ValueError):
        port_fft.Radix2Domain(F, 6)


# ---- MNT6753's Fr: mixed-radix 2^a * 5^b and extended radix-2 domains ---------
@pytest.mark.parametrize("op", OPS)
def test_mixed_matches_jax_limb_for_limb(mixed_case, op):
    _, _, _, got, want = mixed_case
    np.testing.assert_array_equal(to_planes16(got[op]), want[op])


def test_mixed_fft_is_the_dft(mixed_case):
    test_fft_is_the_dft(mixed_case)


def _ints(spec, t):
    return [spec.from_mont(v) for v in limbs_to_ints(to_planes16(t))]


@pytest.mark.parametrize("n", [10, 20, 40, 50, 1 << 16])
def test_new_domains_against_exact_integers(n):
    """fft and coset_fft are the polynomial's values at the domain's and
    the coset's points; the inverses undo them; divide_by_z_on_coset
    divides by the vanishing polynomial's value at each coset point."""
    F = mnt6753.get("cpu").Fr
    spec, p = F.spec, F.p
    dom = port_fft.get_evaluation_domain(F, n)
    rng = random.Random(n)
    vals = [rng.randrange(p) for _ in range(n)]
    a = from_planes16(ints_to_limbs([spec.to_mont(v) for v in vals]))
    if n == 1 << 16:
        assert isinstance(dom, port_fft.ExtendedRadix2Domain)
        half = n // 2

        def point(i):
            return pow(dom.omega, i, p) if i < half else dom.shift * pow(dom.omega, i - half, p) % p

        def vanishing(x):
            xm = pow(x, half, p)
            return (xm - 1) * (xm - dom.shift_to_small_m) % p

        sample = [0, 1, half - 1, half, half + 1, n - 1, rng.randrange(n)]
    else:
        assert isinstance(dom, port_fft.MixedRadixDomain)
        point = lambda i: pow(dom.omega, i, p)
        vanishing = lambda x: (pow(x, n, p) - 1) % p
        sample = range(n)

    def poly(x):
        acc = 0
        for c in reversed(vals):
            acc = (acc * x + c) % p
        return acc

    cev = dom.coset_fft(a)
    cev_i, div_i = _ints(spec, cev), _ints(spec, dom.divide_by_z_on_coset(a))
    g = spec.multiplicative_generator
    for i in sample:
        assert cev_i[i] == poly(g * point(i) % p), i
        assert div_i[i] * vanishing(g * point(i) % p) % p == vals[i], i
    assert torch.equal(dom.icoset_fft(cev), a)
    if n < 1 << 16:  # at 2^16 the coset pair above, which runs fft and ifft inside, is enough
        ev = dom.fft(a)
        ev_i = _ints(spec, ev)
        assert all(ev_i[i] == poly(point(i)) for i in sample)
        assert torch.equal(dom.ifft(ev), a)


def test_domain_selection_for_a_field_with_a_small_subgroup():
    F = mnt6753.get("cpu").Fr
    kinds = {n: type(port_fft.get_evaluation_domain(F, n)).__name__
             for n in (8, 1 << 15, 1 << 16, 10, 25, 25 << 15)}
    assert kinds == {8: "Radix2Domain", 1 << 15: "Radix2Domain", 1 << 16: "ExtendedRadix2Domain",
                     10: "MixedRadixDomain", 25: "MixedRadixDomain", 25 << 15: "MixedRadixDomain"}
    assert port_fft.get_evaluation_domain(F, 25 << 15).n == 819200
    for n, kind in ((12, "StepRadix2Domain"), (1 << 17, "GeometricSequenceDomain"),
                    (3 << 10, "StepRadix2Domain")):  # no 2^a 5^b fits these
        assert type(port_fft.get_evaluation_domain(F, n)).__name__ == kind
    for n in (125, 5 << 16):  # beyond the field's 5^2 and 2^15, as in the JAX package
        with pytest.raises(ValueError):
            port_fft.get_evaluation_domain(F, n)
    with pytest.raises(ValueError):
        port_fft.MixedRadixDomain(F, 16)
    with pytest.raises(ValueError):
        port_fft.ExtendedRadix2Domain(F, 1 << 15)


# ---- step radix-2 and sequence domains against the JAX package's --------------
def _jit_transforms(dom):
    """The JAX domain with its fft, ifft and divide_by_z_on_coset each under
    its own jax.jit, compiled once: its coset_fft and icoset_fft (one product
    with the coset's powers around those) and the JAX compute_h then reuse
    them (the whole compute_h under one jit compiles for minutes here).  A
    sequence domain's matrices are built first, so that no trace keeps them."""
    if hasattr(dom, "_eval_matrix"):
        dom._eval_matrix(), dom._interp_matrix()
    for op in ("fft", "ifft", "divide_by_z_on_coset"):
        setattr(dom, op, jax.jit(getattr(dom, op)))
    return dom


NEW_DOMAINS = {
    "step12": (jax_mnt4753, mnt4753, 12, "StepRadix2Domain"),
    "step24": (jax_mnt6753, mnt6753, 24, "StepRadix2Domain"),
    "geometric7": (jax_mnt4753, mnt4753, 7, "GeometricSequenceDomain"),
    "arithmetic6": (jax_mnt4753, mnt4753, 6, "ArithmeticSequenceDomain"),
}


@pytest.fixture(scope="module", params=sorted(NEW_DOMAINS))
def new_case(request):
    """Both packages' results of the five operations and compute_h; an
    operation that raises gives its exception type."""
    jmod, tmod, n, kind = NEW_DOMAINS[request.param]
    mj, mt = jmod.get(), tmod.get("cpu")
    if kind == "ArithmeticSequenceDomain":  # the selection never picks it: built directly
        dj = jax_seq.ArithmeticSequenceDomain(mj.Fr, n)
        dt = port_seq.ArithmeticSequenceDomain(mt.Fr, n)
    else:
        dj = jax_fft.get_evaluation_domain(mj.Fr, n)
        dt = port_fft.get_evaluation_domain(mt.Fr, n)
    assert type(dj).__name__ == type(dt).__name__ == kind
    rng = random.Random(n)
    vals = [[rng.randrange(mt.Fr.p) for _ in range(n)] for _ in range(3)]
    vals[0][0], vals[0][1] = 0, mt.Fr.p - 1
    planes = [ints_to_limbs([mt.Fr.spec.to_mont(v) for v in col]) for col in vals]

    def results(run):
        out = {}
        for op in OPS + ["compute_h"]:
            try:
                out[op] = run(op)
            except ValueError as e:  # the arithmetic domain's coset meets it at 0
                out[op] = type(e)
        return out

    jd, ja = _jit_transforms(dj), [jnp.asarray(t) for t in planes]
    want = results(lambda op: np.asarray(
        jax_groth16.compute_h(mj, jd, *ja) if op == "compute_h" else getattr(jd, op)(ja[0])))
    ta = [from_planes16(t) for t in planes]
    got = results(lambda op: to_planes16(
        port_groth16.compute_h(mt, dt, *ta) if op == "compute_h" else getattr(dt, op)(ta[0])))
    return kind, got, want


@pytest.mark.parametrize("op", OPS + ["compute_h"])
def test_new_domains_match_jax_limb_for_limb(new_case, op):
    kind, got, want = new_case
    if kind == "ArithmeticSequenceDomain" and op in ("divide_by_z_on_coset", "compute_h"):
        assert got[op] is want[op] is ValueError  # x_0 = 0 lies on every coset
        return
    np.testing.assert_array_equal(got[op], want[op])


def _picked(select, F, n):
    try:
        d = select(F, n)
    except ValueError:
        return "ValueError"
    return type(d).__name__, d.m if hasattr(d, "m") else d.n


GRIDS = {
    # MNT4753's Fr: 2-adicity 30, no small subgroup
    "MNT4753": [2, 3, 5, 6, 7, 8, 12, 100, 1000, 1023, 1024, 1025, 3 << 13, 5 << 14,
                (1 << 20) + 1, (1 << 20) + 3, 3 << 19, 1 << 30, 1 << 31],
    # MNT6753's Fr: 2-adicity 15 and the subgroup 5^2
    "MNT6753": [2, 3, 7, 10, 12, 24, 25, 100, 125, 1000, 3 << 13, 1 << 15, (1 << 15) + 1,
                1 << 16, 25 << 15, 5 << 16, 1 << 17],
}


@pytest.mark.parametrize("curve", sorted(GRIDS))
def test_domain_selection_matches_jax(curve):
    """get_evaluation_domain and get_domain_of_min_size pick the JAX
    package's class and size (or both raise), and best_mixed_domain_size
    agrees, over a grid that reaches every branch of the selection."""
    jmod, tmod = {"MNT4753": (jax_mnt4753, mnt4753), "MNT6753": (jax_mnt6753, mnt6753)}[curve]
    Fj, Ft = jmod.get().Fr, tmod.get("cpu").Fr
    for n in GRIDS[curve]:
        assert _picked(port_fft.get_evaluation_domain, Ft, n) == _picked(
            jax_fft.get_evaluation_domain, Fj, n), n
        assert _picked(port_fft.get_domain_of_min_size, Ft, n) == _picked(
            jax_fft.get_domain_of_min_size, Fj, n), n
        assert port_fft.best_mixed_domain_size(Ft, n) == jax_fft.best_mixed_domain_size(Fj, n), n
    with pytest.raises(ValueError):
        port_fft.get_evaluation_domain(Ft, 1)


# ---- the key generator's host helpers against the JAX package's ---------------
HELPER_DOMAINS = {
    "radix2-8": (jax_mnt4753, mnt4753, 8, "Radix2Domain"),
    "mixed-10": (jax_mnt6753, mnt6753, 10, "MixedRadixDomain"),
    "extended-65536": (jax_mnt6753, mnt6753, 1 << 16, "ExtendedRadix2Domain"),
    "step-12": (jax_mnt4753, mnt4753, 12, "StepRadix2Domain"),
    "step-24": (jax_mnt6753, mnt6753, 24, "StepRadix2Domain"),
    "geometric-7": (jax_mnt4753, mnt4753, 7, "GeometricSequenceDomain"),
    "arithmetic-6": (jax_mnt4753, mnt4753, 6, "ArithmeticSequenceDomain"),
}


@pytest.mark.parametrize("key", sorted(HELPER_DOMAINS))
def test_keygen_helpers_match_jax(key):
    """get_domain_element, compute_vanishing_polynomial, add_poly_Z and
    evaluate_all_lagrange_polynomials equal the JAX package's host methods,
    at t outside the domain and at domain points (in each part)."""
    jmod, tmod, n, kind = HELPER_DOMAINS[key]
    Fj, Ft = jmod.get().Fr, tmod.get("cpu").Fr
    if kind == "ArithmeticSequenceDomain":
        dj, dt = jax_seq.ArithmeticSequenceDomain(Fj, n), port_seq.ArithmeticSequenceDomain(Ft, n)
    else:
        dj, dt = jax_fft.get_evaluation_domain(Fj, n), port_fft.get_evaluation_domain(Ft, n)
    assert type(dj).__name__ == type(dt).__name__ == kind
    p = Ft.p
    rng = random.Random(n)
    idx = sorted({0, 1, n // 2 - 1, n // 2, n - 1, rng.randrange(n)})
    assert [dt.get_domain_element(i) for i in idx] == [dj.get_domain_element(i) for i in idx]
    H = [rng.randrange(p) for _ in range(n + 1)]
    Hj, Ht = list(H), list(H)
    dj.add_poly_Z(12345, Hj)
    dt.add_poly_Z(12345, Ht)
    assert Ht == Hj
    ts = [rng.randrange(p), 0] + [dt.get_domain_element(i) for i in idx[1::2]]
    if n == 1 << 16:  # the JAX basis takes one inverse an element: two points only
        ts = [ts[0], dt.get_domain_element(n // 2 + 1)]
    for t in ts:
        assert dt.compute_vanishing_polynomial(t) == dj.compute_vanishing_polynomial(t), t
        got = dt.evaluate_all_lagrange_polynomials(t)
        assert got == [int(v) for v in dj.evaluate_all_lagrange_polynomials(t)], t


@pytest.mark.parametrize("n", [9, 17])
def test_step_domain_with_a_small_part_of_one(n):
    """m = 2^k + 1: the small part is the single point omega.  The JAX
    package raises there (it builds Radix2Domain(F, 1), fft.py:587); the
    port's basis is held to exact interpolation on the domain's points, at
    t outside and at both parts' points, and sums to 1."""
    F = mnt4753.get("cpu").Fr
    p = F.p
    dom = port_fft.get_evaluation_domain(F, n)
    assert isinstance(dom, port_fft.StepRadix2Domain) and dom.small_m == 1
    xs = [dom.get_domain_element(i) for i in range(n)]
    assert len(set(xs)) == n
    for t in (random.Random(n).randrange(p), xs[3], xs[-1]):
        want = []
        for i, xi in enumerate(xs):
            num = den = 1
            for j, xj in enumerate(xs):
                if j != i:
                    num, den = num * (t - xj) % p, den * (xi - xj) % p
            want.append(num * pow(den, -1, p) % p)
        got = dom.evaluate_all_lagrange_polynomials(t)
        assert got == want and sum(got) % p == 1
        z = 1
        for x in xs:
            z = z * (t - x) % p
        assert dom.compute_vanishing_polynomial(t) == z
    H = [0] * (n + 1)
    dom.add_poly_Z(1, H)
    assert sum(c * pow(xs[5], k, p) for k, c in enumerate(H)) % p == 0
