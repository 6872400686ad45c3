"""The port's blinded Groth16 prover, its witness map and its verifiers on
device="cpu" at d + 1 = 8, against the JAX package and exact integers.

The proving key is built here cheaply: the JAX package's host functions
(``relations.examples``, ``swap_AB_if_beneficial``,
``r1cs_to_qap.instance_map_with_evaluation``) give the QAP at t, and
tools/oracle.py's exact group law multiplies the points; a JAX
``ProvingKey`` of those points is carried over with
``convert.proving_key_from_jax``.  The JAX generator and prover are never
run (their fixed-base and MSM programs compile for minutes).

  * witness map: the port's ``witness_map`` equals the JAX ``witness_map``
    limb for limb, patched (d1, d2, d3) on MNT4753 and plain on MNT6753
    (each JAX call, a jitted FFT, once a test session for all workers); the
    plain map equals tools/oracle.py's quotient; the patched map on a step
    and a mixed-radix domain satisfies (A + d1 Z)(B + d2 Z) - (C + d3 Z) =
    H Z at a random point, Z from the domain's points;
  * prover: the proof bytes equal bytes replayed from the JAX package's
    ``assemble_abc_evaluations``, tools/oracle.py's quotient and MSMs and
    the JAX host assembly with r and s drawn in the JAX order (one CPU
    prove a curve, once a session); a wrong witness raises;
  * verifiers: every case of tests/test_groth16_full.py, decided alike by
    the port's and the JAX package's verifiers on the same key and proof.

The key format, the knowledge commitment and BG are in
tests/test_torch_keys_kc_bg.py.  Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.host.curves import host_curve as jax_host_curve
from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.ops import fft as jax_fft
from snark_challenge_prover_tpu.proof_systems import groth16_full as jax_g16
from snark_challenge_prover_tpu.proof_systems.ate_pairing import AtePairing as JaxAtePairing
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import examples as jax_examples
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as port_g16
from snark_challenge_prover_tpu_torch.reductions import r1cs_to_qap as port_qap
from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints
from test_torch_keygen import _once
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

CURVES = ("MNT4753", "MNT6753")
JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
LOG2D, KEY_SEED, PROVE_SEED = 3, 5, 17
PATCH = (11, 22, 33)  # the zero-knowledge patch d1, d2, d3 of the MNT4753 case


def example(name: str, num_constraints: int, seed: int):
    """A satisfiable JAX constraint system of ``num_constraints`` constraints
    and one input, with the generator's A/B swap, and its assignment."""
    p = JAX_MODELS[name].get().Fr.p
    ex = jax_examples.generate_r1cs_example_with_field_input(p, num_constraints, 1,
                                                             random.Random(seed))
    ex.constraint_system.swap_AB_if_beneficial()
    return ex


def build_keys(name: str, seed: int = KEY_SEED):
    """A JAX key pair for d + 1 = 8 built from host points (see the module
    docstring) and the port's copies, with the example and its secrets."""
    cur = orc.ORACLES[name]()
    Fr = JAX_MODELS[name].get().Fr
    spec = JAX_MODELS[name].get().Fq.spec
    p = Fr.p
    ex = example(name, (1 << LOG2D) - 2, seed)
    cs = ex.constraint_system
    rng = random.Random(seed + 1)
    t, alpha, beta, delta, g1s = (rng.randrange(1, p) for _ in range(5))
    dinv = pow(delta, -1, p)
    inst = jax_qap.instance_map_with_evaluation(cs, t, Fr)
    n, nin = inst.domain_size, inst.num_inputs
    abc = [(beta * a + alpha * b + c) % p for a, b, c in zip(inst.At, inst.Bt, inst.Ct)]
    g1b = cur.g1.mul(g1s, cur.g1_gen)
    g1 = lambda scalars: [cur.g1.mul(v, g1b) for v in scalars]

    def planes(values):
        return ints_to_limbs([spec.to_mont(v) for v in values])

    def g1_pair(pts):
        return (planes([0 if P is None else P[0] for P in pts]),
                planes([0 if P is None else P[1] for P in pts]))

    def g2_pair(pts):
        comps = lambda k: np.stack([planes([0 if P is None else P[k][c] for P in pts])
                                    for c in range(cur.ext_deg)])
        return comps(0), comps(1)

    points = {"A": g1(inst.At), "B1": g1(inst.Bt),
              "B2": [cur.g2.mul(v, cur.g2_gen) for v in inst.Bt],
              "H": g1([inst.Zt * dinv * h % p for h in inst.Ht[: n - 1]]),
              "L": g1([v * dinv % p for v in abc[nin + 1 :]])}
    alpha_g1, beta_g2 = cur.g1.mul(alpha, g1b), cur.g2.mul(beta, cur.g2_gen)
    jpk = jax_g16.ProvingKey(
        curve=name, alpha_g1=alpha_g1, beta_g1=cur.g1.mul(beta, g1b), beta_g2=beta_g2,
        delta_g1=cur.g1.mul(delta, g1b), delta_g2=cur.g2.mul(delta, cur.g2_gen),
        A_query=g1_pair(points["A"]), B_query_g2=g2_pair(points["B2"]),
        B_query_g1=g1_pair(points["B1"]), H_query=g1_pair(points["H"]),
        L_query=g1_pair(points["L"]), constraint_system=cs)
    jvk = jax_g16.VerificationKey(
        curve=name,
        alpha_g1_beta_g2=JaxAtePairing(jax_host_curve(name)).reduced_pairing(alpha_g1, beta_g2),
        delta_g2=jpk.delta_g2, ABC_g1=g1(abc[: nin + 1]))
    return {"ex": ex, "jpk": jpk, "jvk": jvk, "points": points, "cur": cur,
            "pk": convert.proving_key_from_jax(jpk, "cpu"),
            "vk": convert.verification_key_from_jax(jvk)}


_KEYS = {}


def keys(name: str):
    if name not in _KEYS:
        _KEYS[name] = build_keys(name)
    return _KEYS[name]


def _prove(name: str, _dir):
    """The prove, and what its MSM stage (``groth16_msms``) was given and
    gave: (w, h, num_inputs, results)."""
    k = keys(name)
    ex = k["ex"]
    real, seen = port_g16.groth16_msms, []

    def spy(model, *args):
        seen.append((*args[5:8], real(model, *args)))
        return seen[-1][-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_g16, "groth16_msms", spy)
        proof = port_g16.prover(PORT_MODELS[name].get("cpu"), k["pk"], ex.primary_input,
                                ex.auxiliary_input, random.Random(PROVE_SEED))
    (msms,) = seen
    return proof, msms


_PROOFS = {}


def _proved(tmp_path_factory, name: str):
    if name not in _PROOFS:
        _PROOFS[name] = _once(tmp_path_factory, f"groth16-prove-{name}",
                              lambda d: _prove(name, d))[1]
    return _PROOFS[name]


def proof_of(tmp_path_factory, name: str) -> port_g16.Proof:
    """The port's CPU prove of the curve's key, once a test session."""
    return _proved(tmp_path_factory, name)[0]


def recorded_msms(tmp_path_factory, name: str):
    """A stand-in for ``groth16_msms`` that gives that prove's MSM results
    back when called on the same key's queries with the same scalars (as a
    prove of the same witness on the same key, such as BG's, calls it), and
    computes them otherwise.  Each MSM on the CPU is a few hundred
    sequential plain doublings; this spares a second run of them."""
    w0, h0, nin0, out = _proved(tmp_path_factory, name)[1]
    pk, real = keys(name)["pk"], port_g16.groth16_msms

    def msms(model, A, B1, B2, H, L, w_can, h_can, num_inputs, *rest):
        same_key = all(a is b for a, b in zip((A, B1, B2, H, L), (
            pk.A_query, pk.B_query_g1, pk.B_query_g2, pk.H_query, pk.L_query)))
        if (same_key and num_inputs == nin0 and torch.equal(w_can, w0)
                and torch.equal(h_can, h0)):
            return out
        return real(model, A, B1, B2, H, L, w_can, h_can, num_inputs, *rest)

    return msms


def replay_proof(name: str):
    """The proof by the JAX package's host functions and exact integers:
    A, B, C on the domain, the quotient and the five MSMs by
    tools/oracle.py, and the JAX prover's host assembly, r then s drawn
    from the same seed."""
    k = keys(name)
    cur, pts, jpk, ex = k["cur"], k["points"], k["jpk"], k["ex"]
    model = JAX_MODELS[name].get()
    p = model.Fr.p
    cs = ex.constraint_system
    aA, aB, aC = jax_qap.assemble_abc_evaluations(cs, ex.primary_input, ex.auxiliary_input,
                                                  model.Fr)
    n = len(aA)
    h = orc.compute_h(n - 1, aA, aB, aC, cur.fr_spec)
    rng = random.Random(PROVE_SEED)
    r, s = rng.randrange(p), rng.randrange(p)
    w = [1] + [v % p for v in ex.primary_input + ex.auxiliary_input]
    At, Bt1 = cur.g1.msm(w, pts["A"]), cur.g1.msm(w, pts["B1"])
    Bt2 = cur.g2.msm(w, pts["B2"])
    HtLt = cur.g1.add(cur.g1.msm(h[: n - 1], pts["H"]),
                      cur.g1.msm(w[cs.primary_input_size + 1 :], pts["L"]))
    g1, g2 = cur.g1, cur.g2
    A = g1.add(g1.add(jpk.alpha_g1, At), g1.mul(r, jpk.delta_g1))
    B1 = g1.add(g1.add(jpk.beta_g1, Bt1), g1.mul(s, jpk.delta_g1))
    B = g2.add(g2.add(jpk.beta_g2, Bt2), g2.mul(s, jpk.delta_g2))
    C = g1.add(g1.add(HtLt, g1.mul(s, A)),
               g1.add(g1.mul(r, B1), g1.neg(g1.mul(r * s % p, jpk.delta_g1))))
    return jax_g16.Proof(g_A=A, g_B=B, g_C=C), (HtLt, r, s, A, B1, jpk.delta_g1)


# ---------------------------------------------------------------------------
# witness map
# ---------------------------------------------------------------------------

def _jax_witness_map(name: str, patch, _dir):
    k = keys(name)
    ex = k["ex"]
    _, H = jax_qap.witness_map(JAX_MODELS[name].get(), ex.constraint_system, ex.primary_input,
                               ex.auxiliary_input, *patch)
    return np.asarray(H)


@pytest.mark.parametrize("name,patch", [("MNT4753", PATCH), ("MNT6753", (0, 0, 0))])
def test_witness_map_is_the_jax_packages(tmp_path_factory, name, patch):
    _, want = _once(tmp_path_factory, f"jax-witness-map-{name}",
                    lambda d: _jax_witness_map(name, patch, d))
    ex = keys(name)["ex"]
    full, H = port_qap.witness_map(PORT_MODELS[name].get("cpu"),
                                   convert.r1cs_from_reference(ex.constraint_system),
                                   ex.primary_input, ex.auxiliary_input, *patch)
    assert full == ex.primary_input + ex.auxiliary_input
    assert H.shape == (24, (1 << LOG2D) + 1) and H.dtype == torch.int32
    assert torch.equal(H, convert.tensor_from_planes(want, "cpu"))


@pytest.mark.parametrize("name", CURVES)
def test_plain_witness_map_is_the_oracles_quotient(name):
    """Without the patch: H's first n coefficients are tools/oracle.py's
    quotient (A B - C) / (x^n - 1), the top one is zero."""
    model = PORT_MODELS[name].get("cpu")
    ex = keys(name)["ex"]
    cs = convert.r1cs_from_reference(ex.constraint_system)
    _, H = port_qap.witness_map(model, cs, ex.primary_input, ex.auxiliary_input)
    aA, aB, aC = port_qap.assemble_abc_evaluations(cs, ex.primary_input, ex.auxiliary_input,
                                                   model.Fr)
    n = len(aA)
    want = orc.compute_h(n - 1, aA, aB, aC, orc.ORACLES[name]().fr_spec)  # n + 1, the top 0
    assert words_to_ints(model.Fr.to_canonical(H).numpy()) == want


@pytest.mark.parametrize("name,n,kind", [("MNT4753", 12, "StepRadix2Domain"),
                                         ("MNT6753", 10, "MixedRadixDomain")])
def test_patched_witness_map_on_other_domains(name, n, kind):
    """(A(tau) + d1 Z(tau))(B(tau) + d2 Z(tau)) - (C(tau) + d3 Z(tau)) =
    H(tau) Z(tau), A, B, C interpolated exactly through the JAX domain's
    points and Z their product: the patch adds the domain's own Z."""
    model = PORT_MODELS[name].get("cpu")
    p = model.Fr.p
    ex = example(name, n - 2, 9)
    cs = convert.r1cs_from_reference(ex.constraint_system)
    rng = random.Random(n)
    ds = tuple(rng.randrange(1, p) for _ in range(3))
    _, H = port_qap.witness_map(model, cs, ex.primary_input, ex.auxiliary_input, *ds)
    assert H.shape == (24, n + 1)
    domain = jax_fft.get_evaluation_domain(JAX_MODELS[name].get().Fr, n)
    assert type(domain).__name__ == kind
    xs = [domain.get_domain_element(i) for i in range(n)]
    tau = rng.randrange(p)
    z = 1
    for x in xs:
        z = z * (tau - x) % p

    def at_tau(vals):  # Lagrange interpolation through (x_i, vals_i), exact
        out = 0
        for i, (xi, v) in enumerate(zip(xs, vals)):
            num = den = 1
            for j, xj in enumerate(xs):
                if j != i:
                    num, den = num * (tau - xj) % p, den * (xi - xj) % p
            out += v * num * pow(den, -1, p)
        return out % p

    A, B, C = (at_tau(v) for v in port_qap.assemble_abc_evaluations(
        cs, ex.primary_input, ex.auxiliary_input, model.Fr))
    h = 0
    for coeff in reversed(words_to_ints(model.Fr.to_canonical(H).numpy())):
        h = (h * tau + coeff) % p
    d1, d2, d3 = ds
    assert h * z % p == ((A + d1 * z) * (B + d2 * z) - (C + d3 * z)) % p


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CURVES)
def test_proof_bytes_are_the_jax_replay(tmp_path_factory, name):
    got = proof_of(tmp_path_factory, name)
    want, extras = replay_proof(name)
    assert (got.g_A, got.g_B, got.g_C) == (want.g_A, want.g_B, want.g_C)
    assert got.extras == extras
    data = got.to_bytes(PORT_MODELS[name].get("cpu"))
    assert data == want.to_bytes(JAX_MODELS[name].get())
    assert len(data) == (4 + 2 * len(keys(name)["cur"].g2_gen[0])) * 96


def test_wrong_witness_raises():
    k = keys("MNT4753")
    ex = k["ex"]
    bad = list(ex.auxiliary_input)
    bad[-1] += 1
    with pytest.raises(ValueError, match="does not satisfy"):
        port_g16.prover(mnt4753.get("cpu"), k["pk"], ex.primary_input, bad, random.Random(1))


# ---------------------------------------------------------------------------
# verifiers: each case decided alike by the port's and the JAX package's
# ---------------------------------------------------------------------------

def _verdicts(name, proof, primary, strong=True):
    """(the port's verdict, the JAX package's) on the same key and proof."""
    k = keys(name)
    jproof = jax_g16.Proof(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C)
    port_proof = convert.proof_from_jax(jproof)
    if strong:
        return (port_g16.verifier_strong_IC(k["vk"], primary, port_proof),
                jax_g16.verifier_strong_IC(k["jvk"], primary, jproof))
    return (port_g16.verifier_weak_IC(k["vk"], primary, port_proof),
            jax_g16.verifier_weak_IC(k["jvk"], primary, jproof))


@pytest.mark.parametrize("name", CURVES)
def test_proof_verifies(tmp_path_factory, name):
    proof = proof_of(tmp_path_factory, name)
    primary = keys(name)["ex"].primary_input
    assert _verdicts(name, proof, primary) == (True, True)
    assert _verdicts(name, proof, primary, strong=False) == (True, True)
    assert port_g16.affine_verifier_strong_IC(keys(name)["vk"], primary, proof)


@pytest.mark.parametrize("name", CURVES)
def test_wrong_input_rejected(tmp_path_factory, name):
    proof = proof_of(tmp_path_factory, name)
    bad = list(keys(name)["ex"].primary_input)
    bad[0] = (bad[0] + 1) % PORT_MODELS[name].get("cpu").Fr.p
    assert _verdicts(name, proof, bad) == (False, False)


@pytest.mark.parametrize("name", CURVES)
def test_strong_ic_length_check(tmp_path_factory, name):
    """Strong IC refuses a short input outright; weak IC takes it as a
    prefix with zeros after, which this proof does not satisfy."""
    proof = proof_of(tmp_path_factory, name)
    primary = keys(name)["ex"].primary_input
    assert _verdicts(name, proof, primary[:0]) == (False, False)
    assert _verdicts(name, proof, primary[:0], strong=False) == (False, False)
    with pytest.raises(ValueError):
        port_g16.verifier_weak_IC(keys(name)["vk"], primary + [1], proof)


@pytest.mark.parametrize("name", CURVES)
def test_tampered_proof_rejected(tmp_path_factory, name):
    proof = proof_of(tmp_path_factory, name)
    cur = keys(name)["cur"]
    bad = port_g16.Proof(g_A=cur.g1.add(proof.g_A, cur.g1_gen), g_B=proof.g_B, g_C=proof.g_C)
    assert _verdicts(name, bad, keys(name)["ex"].primary_input) == (False, False)


@pytest.mark.parametrize("name", CURVES)
def test_proof_elements_on_curve(tmp_path_factory, name):
    """The proof's points are on the curve, and a point off it is refused
    before any pairing."""
    proof = proof_of(tmp_path_factory, name)
    cur = keys(name)["cur"]
    assert cur.g1.is_on_curve(proof.g_A) and cur.g2.is_on_curve(proof.g_B)
    assert cur.g1.is_on_curve(proof.g_C)
    x, y = proof.g_C
    off = port_g16.Proof(g_A=proof.g_A, g_B=proof.g_B, g_C=(x, (y + 1) % cur.fq_spec.p))
    assert _verdicts(name, off, keys(name)["ex"].primary_input) == (False, False)
