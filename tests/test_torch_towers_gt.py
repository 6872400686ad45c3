"""The port's GT towers (Fq4 on MNT4753, Fq6 on MNT6753) on device="cpu",
with their Frobenius maps and unitary inverse, against the JAX package's
host GT arithmetic (``proof_systems/ate_pairing.HostGT``) and a quadratic
extension over tools/oracle.py's ``ExtSpec``; the Fq2 / Fq3 Frobenius maps
and powers against exact integers; the Frobenius coefficients against the
JAX package's; ``g2_mul_by_q`` against multiplication by q on the
r-torsion; and the tower arrays through ``convert`` and back.  The JAX
towers are not run here (their jitted programs take minutes to compile):
the JAX side is its host arithmetic and its coefficient functions."""

import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.host.curves import HostExt as JaxHostExt
from snark_challenge_prover_tpu.ops import frobenius as jax_frob
from snark_challenge_prover_tpu.proof_systems.ate_pairing import HostGT as JaxHostGT
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch.convert import planes_from_port, tensor_from_planes
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import frobenius
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words, words_to_ints
from tools.oracle import ExtSpec

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

N = 4
CURVES = {"MNT4753": mnt4753, "MNT6753": mnt6753}


class HostQuad:
    """E[v] / (v^2 - u) over tools/oracle.py's ExtSpec E (the reference of
    the JAX package's tests/test_towers_gt.py)."""

    def __init__(self, base: ExtSpec, nr: int):
        self.base, self.nr = base, nr

    def mul_u(self, x):
        return (x[-1] * self.nr % self.base.p,) + tuple(x[:-1])

    def mul(self, a, b):
        B = self.base
        v0, v1 = B.mul(a[0], b[0]), B.mul(a[1], b[1])
        c1 = B.sub(B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), v0), v1)
        return (B.add(v0, self.mul_u(v1)), c1)

    def pow(self, a, e: int):
        out = (self.base.one, self.base.zero)
        for bit in bin(e)[2:]:
            out = self.mul(out, out)
            if bit == "1":
                out = self.mul(out, a)
        return out

    def inv(self, a):
        B = self.base
        ni = B.inv(B.sub(B.mul(a[0], a[0]), self.mul_u(B.mul(a[1], a[1]))))
        return (B.mul(a[0], ni), tuple(-c % B.p for c in B.mul(a[1], ni)))


def _ext_tensor(F, vals):
    """Ext elements (tuples of e ints) -> (e, 24, n) Montgomery words."""
    spec = F.spec
    return torch.stack([torch.from_numpy(ints_to_words([spec.to_mont(v[c]) for v in vals]))
                        for c in range(len(vals[0]))])


def _ext_values(F, t):
    spec = F.spec
    comps = [[spec.from_mont(x) for x in words_to_ints(c.numpy())] for c in t]
    return [tuple(c[j] for c in comps) for j in range(t.shape[-1])]


def _gt_tensor(F, vals):
    return torch.stack([_ext_tensor(F, [v[k] for v in vals]) for k in range(2)])


def _gt_values(F, t):
    return list(zip(_ext_values(F, t[0]), _ext_values(F, t[1])))


@pytest.fixture(scope="module", params=list(CURVES))
def gt_case(request):
    """The model, random GT elements a and b, and the three host references."""
    name = request.param
    model = CURVES[name].get("cpu")
    E = host_curve(name).g2.F
    rng = random.Random(len(name) + E.deg)
    p, e = E.p, E.deg
    mk = lambda: tuple(tuple(rng.randrange(p) for _ in range(e)) for _ in range(2))
    a, b = [mk() for _ in range(N)], [mk() for _ in range(N)]
    refs = {"jax_host_gt": JaxHostGT(JaxHostExt(p, e, E.nr)),
            "oracle_quad": HostQuad(ExtSpec(p, e, E.nr), E.nr)}
    return model, a, b, refs


@pytest.mark.parametrize("op", ["mul", "sqr", "inv"])
def test_gt_ring_ops_equal_host_references(gt_case, op):
    model, a, b, refs = gt_case
    GT, Fq = model.GT, model.Fq
    A, B = _gt_tensor(Fq, a), _gt_tensor(Fq, b)
    got = _gt_values(Fq, {"mul": lambda: GT.mul(A, B), "sqr": lambda: GT.sqr(A),
                          "inv": lambda: GT.inv(A)}[op]())
    for ref in refs.values():
        want = {"mul": lambda: [ref.mul(x, y) for x, y in zip(a, b)],
                "sqr": lambda: [ref.mul(x, x) for x in a],
                "inv": lambda: [ref.inv(x) for x in a]}[op]()
        assert got == want, type(ref).__name__


def test_gt_frobenius_every_power(gt_case):
    """frobenius_map(power) for every power below the degree equals the JAX
    host map, and power 1 is x -> x^q exactly."""
    model, a, _, refs = gt_case
    GT, Fq = model.GT, model.Fq
    A = _gt_tensor(Fq, a)
    for power in range(2 * GT.base.deg):
        got = _gt_values(Fq, GT.frobenius_map(A, power))
        assert got == [refs["jax_host_gt"].frobenius_map(x, power) for x in a], power
    assert _gt_values(Fq, GT.frobenius_map(A, 1)) == [refs["oracle_quad"].pow(x, Fq.p) for x in a]


def test_gt_unitary_inverse(gt_case):
    """The conjugation on any element; on norm-1 elements (x^(q^e - 1), where
    reduced pairing values live) it is the inverse."""
    model, a, _, refs = gt_case
    GT, Fq = model.GT, model.Fq
    jg = refs["jax_host_gt"]
    A = _gt_tensor(Fq, a)
    assert _gt_values(Fq, GT.unitary_inverse(A)) == [jg.unitary_inverse(x) for x in a]
    e = GT.base.deg
    unit = [jg.mul(jg.frobenius_map(x, e), jg.inv(x)) for x in a]
    U = _gt_tensor(Fq, unit)
    got = _gt_values(Fq, GT.unitary_inverse(U))
    assert got == [jg.inv(x) for x in unit]
    assert _gt_values(Fq, GT.mul(U, GT.unitary_inverse(U))) == [jg.one] * N


@pytest.mark.parametrize("name", list(CURVES))
def test_base_ext_frobenius_and_pow(name):
    """Fq2 / Fq3: frobenius_map(power) is x -> x^(q^power) and pow_int is the
    exact power (tools/oracle.py's ExtSpec)."""
    model = CURVES[name].get("cpu")
    E = model.G2.F
    spec = ExtSpec(E.base.p, E.deg, E.nr)
    rng = random.Random(E.deg)
    vals = [tuple(rng.randrange(spec.p) for _ in range(E.deg)) for _ in range(N)]
    vals[0] = (0,) * E.deg
    X = _ext_tensor(model.Fq, vals)

    def power(x, k):
        out = spec.one
        for bit in bin(k)[2:]:
            out = spec.mul(out, out)
            if bit == "1":
                out = spec.mul(out, x)
        return out

    for pw in range(E.deg + 1):
        assert _ext_values(model.Fq, E.frobenius_map(X, pw)) == [power(v, spec.p ** pw)
                                                                  for v in vals], pw
    k = rng.getrandbits(40) | 1
    assert _ext_values(model.Fq, E.pow_int(X, k)) == [power(v, k) for v in vals]
    assert _ext_values(model.Fq, E.pow_int(X, 0)) == [spec.one] * N


@pytest.mark.parametrize("fn,args", [
    ("ext_frobenius_coeffs", ("q4", 13, 4)), ("fq2_frobenius_coeffs_c1", ("q4", 13)),
    ("fq4_frobenius_coeffs_c1", ("q4", 13)), ("fq3_frobenius_coeffs_c1", ("q6", 11)),
    ("fq3_frobenius_coeffs_c2", ("q6", 11)), ("fq6_frobenius_coeffs_c1", ("q6", 11)),
    ("mnt4753_twist_mul_by_q", ()), ("mnt6753_twist_mul_by_q", ())])
def test_frobenius_coefficients_equal_jax(fn, args):
    q = {"q4": mnt4753.get("cpu").Fq.p, "q6": mnt6753.get("cpu").Fq.p}
    args = tuple(q.get(a, a) if isinstance(a, str) else a for a in args)
    assert getattr(frobenius, fn)(*args) == getattr(jax_frob, fn)(*args)


@pytest.mark.parametrize("name", list(CURVES))
def test_g2_mul_by_q_is_multiplication_by_q(name):
    model = CURVES[name].get("cpu")
    hc = host_curve(name)
    E, F = model.G2.F, hc.g2.F
    rng = random.Random(5)
    pts = [hc.g2.mul(rng.getrandbits(64) | 1, hc.g2_gen) for _ in range(2)]
    X, Y = _ext_tensor(model.Fq, [P[0] for P in pts]), _ext_tensor(model.Fq, [P[1] for P in pts])
    Z = E.ones((len(pts),))
    Xq, Yq, Zq = (_ext_values(model.Fq, t) for t in model.g2_mul_by_q((X, Y, Z)))
    q, r = model.Fq.p, model.Fr.p
    for P, x, y, z in zip(pts, Xq, Yq, Zq):
        zi = F.inv(z)
        assert (F.mul(x, zi), F.mul(y, zi)) == hc.g2.mul(q % r, P)


@pytest.mark.parametrize("name", list(CURVES))
def test_gt_arrays_convert_to_jax_layout_and_back(name):
    """A port GT tensor (2, e, 24, n) -> the JAX package's planes (2, e, 48,
    n), equal to the JAX test's own packing, and back unchanged."""
    model = CURVES[name].get("cpu")
    Fq, e = model.Fq, model.GT.base.deg
    rng = random.Random(11)
    vals = [tuple(tuple(rng.randrange(Fq.p) for _ in range(e)) for _ in range(2))
            for _ in range(N)]
    T = _gt_tensor(Fq, vals)
    planes = planes_from_port(T)
    jax_planes = np.stack([np.stack([ints_to_limbs([Fq.spec.to_mont(v[k][c]) for v in vals])
                                     for c in range(e)]) for k in range(2)])
    assert planes.shape == (2, e, 48, N)
    np.testing.assert_array_equal(planes, jax_planes)
    assert torch.equal(tensor_from_planes(planes, "cpu"), T)
