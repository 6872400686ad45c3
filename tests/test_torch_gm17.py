"""The port's R1CS -> SAP reduction and GM17 (r1cs_se_ppzksnark) on
device="cpu", against the JAX package and exact integers.

  * SAP host functions: ``sap_min_size``, ``sap_domain_size``,
    ``sap_num_variables``, the instance map at t, ``extended_assignment``
    and ``assemble_ac_evaluations`` equal the JAX package's on examples with
    two inputs and square-flagged constraints, on both curves;
  * SAP witness map: equal to the JAX ``witness_map`` limb for limb at a
    radix-2 size, patched with the prove's d1, d2 and plain (one jitted JAX
    map, once a test session for all workers); patched, on a step domain
    (small part of size 1 too) and a mixed-radix one, (A(tau) + d1 Z(tau))^2
    - (C(tau) + d2 Z(tau)) = H(tau) Z(tau) at a random point, A and C
    interpolated through the JAX domain's points;
  * generator: the port's keys on MNT4753 at d + 1 = 8 (a SAP domain of 16)
    equal keys made from the same draws by the JAX instance map's scalars and
    tools/oracle.py's exact multiplication (``convert.gm17_*_from_jax``);
  * prover: the proof equals a replay of the JAX assembly with the JAX
    witness map's H, tools/oracle.py's MSMs and the JAX order of draws; a
    wrong witness raises;
  * verifiers: accept, wrong input, the strong IC's length check, a
    tampered and an off-curve proof, decided alike by the port's and the JAX
    package's verifiers.

The JAX generator and prover are never run (their fixed-base and MSM
programs compile for minutes); the port's generator and prover run once a
test session (about a minute and half a minute).  Every comparison is
exact."""

import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.ops import fft as jax_fft
from snark_challenge_prover_tpu.proof_systems import gm17 as jax_gm17
from snark_challenge_prover_tpu.reductions import r1cs_to_sap as jax_sap
from snark_challenge_prover_tpu.relations import examples as jax_examples
from snark_challenge_prover_tpu.relations import r1cs as jax_r1cs
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops.fft import power_table
from snark_challenge_prover_tpu_torch.proof_systems import gm17 as port_gm17
from snark_challenge_prover_tpu_torch.reductions import r1cs_to_sap as port_sap
from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints
from test_torch_keygen import _once
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

CURVES = ("MNT4753", "MNT6753")
JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
NAME, KEY_SEED, PROVE_SEED = "MNT4753", 5, 17  # the key pair's curve and seeds


def square_example(name: str, num_constraints: int, num_inputs: int, squares: int, seed: int):
    """A satisfiable JAX field example whose closing constraint (a sum
    squared) is flagged square, with ``squares`` more square constraints
    x_j * x_j = v over new auxiliary variables v."""
    p = JAX_MODELS[name].get().Fr.p
    rng = random.Random(seed)
    ex = jax_examples.generate_r1cs_example_with_field_input(p, num_constraints, num_inputs, rng)
    cs = ex.constraint_system
    if squares:
        cs.constraints[-1].is_square = True
    LC = jax_r1cs.LinearCombination
    for _ in range(max(0, squares - 1)):
        j = rng.randrange(1, cs.num_variables + 1)
        value = (ex.primary_input + ex.auxiliary_input)[j - 1]
        cs.auxiliary_input_size += 1
        cs.add_constraint(jax_r1cs.R1CSConstraint(LC.of_var(j), LC.of_var(j),
                                                  LC.of_var(cs.num_variables), is_square=True))
        ex.auxiliary_input.append(value * value % p)
    assert cs.is_satisfied(ex.primary_input, ex.auxiliary_input)
    assert cs.num_square_constraints == squares
    return ex


# (num_constraints, inputs, square constraints) -> SAP domains: MNT4753 step 18,
# 24 and 20, radix-2 32 and 16; MNT6753 step 18 and 24, mixed 20 and 25, radix-2 16
HOST_CASES = [(6, 2, 3), (9, 2, 1), (8, 2, 1), (10, 2, 2), (5, 2, 2)]


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("nc,nin,squares", HOST_CASES)
def test_sap_host_functions_match_jax(name, nc, nin, squares):
    ex = square_example(name, nc, nin, squares, nc * 31 + squares)
    jcs = ex.constraint_system
    cs = convert.r1cs_from_reference(jcs)
    jF, F = JAX_MODELS[name].get().Fr, PORT_MODELS[name].get("cpu").Fr
    assert cs.num_square_constraints == jcs.num_square_constraints == squares
    assert port_sap.sap_min_size(cs) == jax_sap.sap_min_size(jcs)
    assert port_sap.sap_num_variables(cs) == jax_sap.sap_num_variables(jcs)
    n = port_sap.sap_domain_size(cs, F)
    assert n == jax_sap.sap_domain_size(jcs, jF)

    t = random.Random(nc).randrange(1, F.p)
    got, want = port_sap.instance_map_with_evaluation(cs, t, F), \
        jax_sap.instance_map_with_evaluation(jcs, t, jF)
    for key in ("domain_size", "num_variables", "num_inputs", "t", "At", "Ct", "Zt"):
        assert getattr(got, key) == getattr(want, key), key
    assert words_to_ints(F.to_canonical(power_table(F, t, n + 1)).numpy()) == want.Ht

    full = port_sap.extended_assignment(cs, ex.primary_input, ex.auxiliary_input)
    assert full == jax_sap.extended_assignment(jcs, ex.primary_input, ex.auxiliary_input)
    assert len(full) == got.num_variables
    assert port_sap.assemble_ac_evaluations(cs, full, F) == \
        jax_sap.assemble_ac_evaluations(jcs, full, jF)


# ---------------------------------------------------------------------------
# the key pair: example, draws, expected keys
# ---------------------------------------------------------------------------

def key_example(name: str = NAME):
    """The GM17 key's example: d + 1 = 8 (six constraints, one input)."""
    p = JAX_MODELS[name].get().Fr.p
    return jax_examples.generate_r1cs_example_with_field_input(p, 6, 1, random.Random(KEY_SEED))


def _planes(spec, values):
    return ints_to_limbs([spec.to_mont(v) for v in values])


def expected_keys(name: str = NAME):
    """The JAX generator's keys for the key example and ``KEY_SEED``, by the
    JAX instance map's scalars and tools/oracle.py's exact group law (the
    identity stored as (0, 0)), as JAX ``ProvingKey`` / ``VerificationKey``."""
    cur = orc.ORACLES[name]()
    Fr = JAX_MODELS[name].get().Fr
    spec = JAX_MODELS[name].get().Fq.spec
    p = Fr.p
    ex = key_example(name)
    cs = ex.constraint_system
    rng = random.Random(KEY_SEED + 1)
    while True:  # the JAX generator's loop (gm17.py:107-113)
        t = rng.randrange(1, p)
        inst = jax_sap.instance_map_with_evaluation(cs, t, Fr)
        if inst.Zt % p:
            break
    m, n, l = inst.num_variables, inst.domain_size, inst.num_inputs
    alpha, beta, gamma, g_scalar, h_scalar = (rng.randrange(1, p) for _ in range(5))
    G, H = cur.g1.mul(g_scalar, cur.g1_gen), cur.g2.mul(h_scalar, cur.g2_gen)
    H_gamma = cur.g2.mul(gamma, H)
    ab, Zt = (alpha + beta) % p, inst.Zt
    vq = [(gamma * c + ab * a) % p for a, c in zip(inst.At, inst.Ct)]
    g2z = gamma * gamma * Zt % p

    def g1_pair(scalars):
        pts = [cur.g1.mul(s, G) for s in scalars]
        return (_planes(spec, [0 if P is None else P[0] for P in pts]),
                _planes(spec, [0 if P is None else P[1] for P in pts]))

    def g2_pair(scalars):
        pts = [cur.g2.mul(s, H_gamma) for s in scalars]
        comp = lambda k: np.stack([_planes(spec, [0 if P is None else P[k][c] for P in pts])
                                   for c in range(cur.ext_deg)])
        return comp(0), comp(1)

    jpk = jax_gm17.ProvingKey(
        curve=name, A_query=g1_pair([gamma * a % p for a in inst.At]),
        B_query=g2_pair(inst.At), C_query_1=g1_pair([gamma * v % p for v in vq[l + 1 :]]),
        C_query_2=g1_pair([2 * g2z * a % p for a in inst.At]),
        G_gamma_Z=cur.g1.mul(gamma * Zt % p, G), H_gamma_Z=cur.g2.mul(gamma * Zt % p, H),
        G_ab_gamma_Z=cur.g1.mul(ab * gamma * Zt % p, G), G_gamma2_Z2=cur.g1.mul(g2z * Zt % p, G),
        G_gamma2_Z_t=g1_pair([g2z * h % p for h in inst.Ht[: n + 1]]), constraint_system=cs)
    jvk = jax_gm17.VerificationKey(
        curve=name, H=H, G_alpha=cur.g1.mul(alpha, G), H_beta=cur.g2.mul(beta, H),
        G_gamma=cur.g1.mul(gamma, G), H_gamma=cur.g2.mul(gamma, H),
        query=[cur.g1.mul(v, G) for v in vq[: l + 1]])
    secrets = {"t": t, "alpha": alpha, "beta": beta, "gamma": gamma, "G": G, "H": H, "inst": inst}
    return ex, jpk, jvk, secrets


_EXPECTED = {}


def expected(name: str = NAME):
    if name not in _EXPECTED:
        _EXPECTED[name] = expected_keys(name)
    return _EXPECTED[name]


def _generate(name: str):
    ex = key_example(name)
    return port_gm17.generator(PORT_MODELS[name].get("cpu"),
                               convert.r1cs_from_reference(ex.constraint_system),
                               random.Random(KEY_SEED + 1))


def _prove(name: str, kp):
    ex = key_example(name)
    return port_gm17.prover(PORT_MODELS[name].get("cpu"), kp.pk, ex.primary_input,
                            ex.auxiliary_input, random.Random(PROVE_SEED))


def keypair(tmp_path_factory, name: str = NAME):
    """The port's GM17 key pair on the CPU, once a test session."""
    return _once(tmp_path_factory, f"gm17-keygen-{name}", lambda d: _generate(name))[1]


def proof_of(tmp_path_factory, name: str = NAME):
    """The port's CPU prove on that key pair, once a test session."""
    kp = keypair(tmp_path_factory, name)
    return _once(tmp_path_factory, f"gm17-prove-{name}", lambda d: _prove(name, kp))[1]


def prove_draws(name: str = NAME):
    """The prover's d1, d2, r, in the JAX order."""
    rng = random.Random(PROVE_SEED)
    p = JAX_MODELS[name].get().Fr.p
    return tuple(rng.randrange(p) for _ in range(3))


def _jax_witness_maps(name: str):
    """The JAX SAP witness map of the key example, patched with the prove's
    d1, d2 and plain: (full assignment, H planes) each."""
    ex = key_example(name)
    d1, d2, _ = prove_draws(name)
    out = []
    for ds in ((d1, d2), (0, 0)):
        wit = jax_sap.witness_map(JAX_MODELS[name].get(), ex.constraint_system, ex.primary_input,
                                  ex.auxiliary_input, *ds)
        out.append((wit.full_assignment, np.asarray(wit.H_planes)))
    return out


def jax_witness_maps(tmp_path_factory, name: str = NAME):
    return _once(tmp_path_factory, f"jax-sap-witness-map-{name}",
                 lambda d: _jax_witness_maps(name))[1]


# ---------------------------------------------------------------------------
# witness map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patched", [True, False])
def test_witness_map_is_the_jax_packages(tmp_path_factory, patched):
    want_full, want_H = jax_witness_maps(tmp_path_factory)[0 if patched else 1]
    ex = key_example()
    d1, d2, _ = prove_draws() if patched else (0, 0, 0)
    wit = port_sap.witness_map(mnt4753.get("cpu"), convert.r1cs_from_reference(ex.constraint_system),
                               ex.primary_input, ex.auxiliary_input, d1, d2)
    assert (wit.degree, wit.num_inputs, wit.d1, wit.d2) == (16, 1, d1, d2)
    assert wit.full_assignment == want_full and len(want_full) == wit.num_variables
    assert wit.H.shape == (24, 17) and wit.H.dtype == torch.int32
    assert torch.equal(wit.H, convert.tensor_from_planes(want_H, "cpu"))


def _interpolator(xs, p, tau):
    """vals -> the polynomial through (x_i, vals_i) at tau, exactly."""
    weights = []
    for i, xi in enumerate(xs):
        num = den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num, den = num * (tau - xj) % p, den * (xi - xj) % p
        weights.append(num * pow(den, -1, p) % p)
    return lambda vals: sum(v * w for v, w in zip(vals, weights)) % p


@pytest.mark.parametrize("name,nc,squares,kind,n", [
    ("MNT4753", 7, 0, "StepRadix2Domain", 17),  # the step domain with a small part of size 1
    ("MNT4753", 8, 1, "StepRadix2Domain", 18),
    ("MNT6753", 4, 1, "MixedRadixDomain", 10)])
def test_patched_witness_map_on_other_domains(name, nc, squares, kind, n):
    """H(tau) Z(tau) = (A(tau) + d1 Z(tau))^2 - (C(tau) + d2 Z(tau)), A and C
    through the JAX domain's points, Z their product: the patch adds the
    domain's own Z, and the top coefficient is d1^2."""
    model = PORT_MODELS[name].get("cpu")
    p = model.Fr.p
    ex = square_example(name, nc, 1, squares, n)
    cs = convert.r1cs_from_reference(ex.constraint_system)
    assert port_sap.sap_min_size(cs) == n
    rng = random.Random(n)
    d1, d2 = rng.randrange(1, p), rng.randrange(1, p)
    wit = port_sap.witness_map(model, cs, ex.primary_input, ex.auxiliary_input, d1, d2)
    assert wit.H.shape == (24, n + 1)
    domain = jax_fft.get_evaluation_domain(JAX_MODELS[name].get().Fr, n)
    assert type(domain).__name__ == kind
    xs = [domain.get_domain_element(i) for i in range(n)]
    tau = rng.randrange(p)
    z = 1
    for x in xs:
        z = z * (tau - x) % p
    at_tau = _interpolator(xs, p, tau)
    A, C = (at_tau(v) for v in port_sap.assemble_ac_evaluations(cs, wit.full_assignment, model.Fr))
    coeffs = words_to_ints(model.Fr.to_canonical(wit.H).numpy())
    assert coeffs[n] == d1 * d1 % p
    h = 0
    for coeff in reversed(coeffs):
        h = (h * tau + coeff) % p
    assert h * z % p == ((A + d1 * z) ** 2 - (C + d2 * z)) % p


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

QUERIES = ("A_query", "B_query", "C_query_1", "C_query_2", "G_gamma2_Z_t")
SINGLES = ("G_gamma_Z", "H_gamma_Z", "G_ab_gamma_Z", "G_gamma2_Z2")


def test_proving_key_is_the_jax_replay(tmp_path_factory):
    kp = keypair(tmp_path_factory)
    _, jpk, _, _ = expected()
    want = convert.gm17_proving_key_from_jax(jpk, "cpu")
    assert kp.pk.curve == want.curve == NAME
    for key in QUERIES:
        for got_c, want_c in zip(getattr(kp.pk, key), getattr(want, key)):
            assert got_c.dtype == torch.int32 and torch.equal(got_c, want_c), key
    for key in SINGLES:
        assert getattr(kp.pk, key) == getattr(want, key), key
    m = port_sap.sap_num_variables(kp.pk.constraint_system)
    assert [kp.pk.A_query[0].shape[-1], kp.pk.B_query[0].shape, kp.pk.C_query_1[0].shape[-1],
            kp.pk.G_gamma2_Z_t[0].shape[-1]] == [m + 1, (2, 24, m + 1), m - 1, 17]
    # the SAP's x' variables appear in C only: their A and B entries are identities
    assert not kp.pk.B_query[1][..., -1].any() and not kp.pk.A_query[1][:, -1].any()


def test_verification_key_is_the_jax_replay(tmp_path_factory):
    kp = keypair(tmp_path_factory)
    _, _, jvk, _ = expected()
    assert kp.vk == convert.gm17_verification_key_from_jax(jvk)
    assert len(kp.vk.query) == 2


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def replay_proof(tmp_path_factory):
    """The proof by the JAX assembly (gm17.py:309-349) over tools/oracle.py's
    MSMs of the expected key's points, H from the JAX witness map, d1, d2, r
    in the JAX order."""
    ex, jpk, _, sec = expected()
    cur = orc.ORACLES[NAME]()
    p = cur.fr_spec.p
    full, H = jax_witness_maps(tmp_path_factory)[0]
    h = words_to_ints(mnt4753.get("cpu").Fr.to_canonical(
        convert.tensor_from_planes(H, "cpu")).numpy())
    d1, d2, r = prove_draws()
    inst, gamma, G, Hb = sec["inst"], sec["gamma"], sec["G"], sec["H"]
    l = inst.num_inputs
    Zt, ab = inst.Zt, (sec["alpha"] + sec["beta"]) % p
    g1 = lambda s: cur.g1.mul(s % p, G)
    w = [1] + full
    A_t = sum(wi * a for wi, a in zip(w, inst.At)) % p
    vq = [(gamma * c + ab * a) % p for a, c in zip(inst.At, inst.Ct)]
    At_sum = cur.g1.msm(full, [g1(gamma * a) for a in inst.At[1:]])
    Bt_sum = cur.g2.msm(full, [cur.g2.mul(gamma * a % p, Hb) for a in inst.At[1:]])
    C1 = cur.g1.msm(full[l:], [g1(gamma * v) for v in vq[l + 1 :]])
    C2 = cur.g1.msm(full, [g1(2 * gamma * gamma * Zt * a) for a in inst.At[1:]])
    Hm = cur.g1.msm(h, [g1(gamma * gamma * Zt * pow(sec["t"], i, p)) for i in range(len(h))])
    rd1 = (r + d1) % p
    A = cur.g1.add(cur.g1.add(cur.g1.mul(rd1, jpk.G_gamma_Z), g1(gamma * inst.At[0])), At_sum)
    B = cur.g2.add(cur.g2.add(cur.g2.mul(rd1, jpk.H_gamma_Z), cur.g2.mul(gamma * inst.At[0] % p, Hb)),
                   Bt_sum)
    C = C1
    for k, P in ((r * r, jpk.G_gamma2_Z2), (rd1, jpk.G_ab_gamma_Z),
                 (r, g1(2 * gamma * gamma * Zt * inst.At[0])), (2 * r * d1, jpk.G_gamma2_Z2),
                 (r, C2), (d2, g1(gamma * gamma * Zt))):
        C = cur.g1.add(C, cur.g1.mul(k % p, P))
    C = cur.g1.add(C, Hm)
    # and the scalars of the docstring (gm17.py:25-29), with no MSM
    h_t = ((A_t + d1 * Zt) ** 2 - (sum(wi * c for wi, c in zip(w, inst.Ct)) + d2 * Zt)) \
        * pow(Zt, -1, p) % p
    c = (gamma * sum(wi * v for wi, v in zip(w[l + 1 :], vq[l + 1 :]))
         + (r * r + 2 * r * d1) * gamma * gamma * Zt * Zt + rd1 * ab * gamma * Zt
         + 2 * r * gamma * gamma * Zt * A_t + gamma * gamma * Zt * (h_t + d2))
    a = gamma * (A_t + rd1 * Zt)
    assert (A, B, C) == (g1(a), cur.g2.mul(a % p, Hb), g1(c))
    return jax_gm17.Proof(A=A, B=B, C=C)


def test_proof_is_the_jax_replay(tmp_path_factory):
    got = proof_of(tmp_path_factory)
    want = replay_proof(tmp_path_factory)
    assert got == convert.gm17_proof_from_jax(want)


def test_wrong_witness_raises(tmp_path_factory):
    kp = keypair(tmp_path_factory)
    ex = key_example()
    bad = list(ex.auxiliary_input)
    bad[-1] += 1
    with pytest.raises(ValueError, match="does not satisfy"):
        port_gm17.prover(mnt4753.get("cpu"), kp.pk, ex.primary_input, bad, random.Random(1))


# ---------------------------------------------------------------------------
# verifiers: each case decided alike by the port's and the JAX package's
# ---------------------------------------------------------------------------

def _verdicts(tmp_path_factory, proof, primary, strong=True):
    kp = keypair(tmp_path_factory)
    jvk = expected()[2]
    jproof = jax_gm17.Proof(A=proof.A, B=proof.B, C=proof.C)
    if strong:
        return (port_gm17.verifier_strong_IC(kp.vk, primary, proof),
                jax_gm17.verifier_strong_IC(jvk, primary, jproof))
    return (port_gm17.verifier_weak_IC(kp.vk, primary, proof),
            jax_gm17.verifier_weak_IC(jvk, primary, jproof))


def test_proof_verifies(tmp_path_factory):
    proof = proof_of(tmp_path_factory)
    primary = key_example().primary_input
    assert _verdicts(tmp_path_factory, proof, primary) == (True, True)
    assert _verdicts(tmp_path_factory, proof, primary, strong=False) == (True, True)


def test_wrong_input_rejected(tmp_path_factory):
    proof = proof_of(tmp_path_factory)
    bad = [(key_example().primary_input[0] + 1) % mnt4753.get("cpu").Fr.p]
    assert _verdicts(tmp_path_factory, proof, bad) == (False, False)


def test_strong_ic_length_check(tmp_path_factory):
    """Strong IC refuses a short input outright; weak IC takes it as a
    prefix, which this proof does not satisfy; a longer input raises."""
    proof = proof_of(tmp_path_factory)
    primary = key_example().primary_input
    assert _verdicts(tmp_path_factory, proof, primary[:0]) == (False, False)
    assert _verdicts(tmp_path_factory, proof, primary[:0], strong=False) == (False, False)
    assert _verdicts(tmp_path_factory, proof, primary + [1]) == (False, False)
    with pytest.raises(ValueError):
        port_gm17.verifier_weak_IC(keypair(tmp_path_factory).vk, primary + [1], proof)


@pytest.mark.parametrize("part", ["A", "B", "C"])
def test_tampered_proof_rejected(tmp_path_factory, part):
    proof = proof_of(tmp_path_factory)
    cur = orc.ORACLES[NAME]()
    group, gen = (cur.g2, cur.g2_gen) if part == "B" else (cur.g1, cur.g1_gen)
    bad = port_gm17.Proof(**{**vars(proof), part: group.add(getattr(proof, part), gen)})
    assert _verdicts(tmp_path_factory, bad, key_example().primary_input) == (False, False)


def test_proof_off_curve_rejected(tmp_path_factory):
    """The proof's points are on the curve, and a point off it is refused
    before any pairing."""
    proof = proof_of(tmp_path_factory)
    cur = orc.ORACLES[NAME]()
    assert cur.g1.is_on_curve(proof.A) and cur.g2.is_on_curve(proof.B)
    assert cur.g1.is_on_curve(proof.C)
    x, y = proof.C
    off = port_gm17.Proof(A=proof.A, B=proof.B, C=(x, (y + 1) % cur.fq_spec.p))
    assert _verdicts(tmp_path_factory, off, key_example().primary_input) == (False, False)
