"""The port's ADSNARK (r1cs_ppzkadsnark), on device="cpu", against the JAX
package and exact integers.

  * the authentication layer: with the same seed, ``auth_generator``,
    ``auth_sign``, ``_prf``, ``_sig_hash`` and the Schnorr signatures equal
    the JAX package's on both curves, and ``auth_verify_sym`` / ``_pub``
    decide alike on the JAX package's cases (a changed value, a wrong
    label, a forged signature);
  * one key pair and proof on MNT6753 at d + 1 = 8 with two authenticated
    inputs (once a test session): the keys equal keys made from the same
    draws by the JAX QAP instance map's scalars and tools/oracle.py's exact
    multiplication (the JAX generator's formulas, adsnark.py:252-366, A's
    input rows kept); the proof equals a replay of the JAX assembly
    (adsnark.py:470-527) over the oracle's MSMs, H the oracle's quotient
    plus the zero-knowledge patch, d1, d2, d3, dauth in the JAX order, with
    one term as libsnark has it: K's row m + 1 times d1 + dauth, the
    witness map's shift (libsnark's qap_wit.d1), where the JAX package takes
    d1, whose proofs both packages' verifiers then reject;
  * the verifiers: the port's and the JAX package's ``verifier_sym`` and
    ``verifier_pub`` decide alike on the port's keys and proof: accept,
    wrong labels, each proof element tampered, a point off the curve; an
    unsatisfied witness raises.

The JAX generator and prover are never run (their fixed-base and MSM
programs compile for minutes), and the JAX authentication layer runs with
tools/oracle.py's G2 group law (its own takes 36-98 s a G2 multiplication).
The verdicts of both packages run with their host scalar multiplication and
reduced pairing memoised: a tampered proof repeats most of the products and
pairings of the untampered one, and the memo returns the values the
functions compute.  Every comparison is exact."""

import random
from dataclasses import replace

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.proof_systems import adsnark as jax_ads
from snark_challenge_prover_tpu.host import curves as jax_curves
from snark_challenge_prover_tpu.proof_systems import ate_pairing as jax_ate
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import r1cs as jax_r1cs_mod
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import adsnark as port_ads
from snark_challenge_prover_tpu_torch.host import curves as port_curves
from snark_challenge_prover_tpu_torch.proof_systems import ate_pairing as port_ate
from snark_challenge_prover_tpu_torch.relations.examples import (
    generate_r1cs_example_with_field_input)
from test_torch_keygen import _once
from test_torch_pghr13_bacs import patched_h
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
CURVE = "MNT6753"  # the key pair's curve
EXAMPLE_SEED, AUTH_SEED, KEY_SEED, PROVE_SEED = 4, 11, 8, 23
NUM_INPUTS = 2  # five constraints and two inputs: a QAP domain of 8


# ---------------------------------------------------------------------------
# the authentication layer
# ---------------------------------------------------------------------------

def labels_for(count: int) -> list:
    return [f"label-{i}".encode() for i in range(count)]


def jax_auth(fn, name: str, *args):
    """A JAX authentication-layer function on ``name``'s JAX model, run with
    tools/oracle.py's G2 group law in the JAX host curve: the JAX package's
    own takes 36 s (MNT4753) and 98 s (MNT6753) a G2 multiplication, its
    extension inverse an exponentiation.  The draws, the hashes, the
    formulas and G1 stay the JAX package's."""
    real = jax_ads.host_curve
    jax_ads.host_curve = lambda n: replace(real(n), g2=orc.ORACLES[n]().g2)
    try:
        return fn(JAX_MODELS[name].get(), *args)
    finally:
        jax_ads.host_curve = real


_AUTH = {}


def auth_case(name: str):
    """(values, JAX keys, JAX auth data, port keys, port auth data): two
    values drawn from the curve's name, each package drawing its keys and
    signatures from its own Random(AUTH_SEED); once a process."""
    if name not in _AUTH:
        pm = PORT_MODELS[name].get("cpu")
        values = [random.Random(name).randrange(pm.Fr.p) for _ in range(2)]
        labels = labels_for(len(values))
        jrng, prng = random.Random(AUTH_SEED), random.Random(AUTH_SEED)
        jk = jax_auth(jax_ads.auth_generator, name, jrng)
        pk = port_ads.auth_generator(pm, prng)
        _AUTH[name] = (values, jk, jax_auth(jax_ads.auth_sign, name, values, jk.sak, labels, jrng),
                       pk, port_ads.auth_sign(pm, values, pk.sak, labels, prng))
    return _AUTH[name]


@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_auth_generator_and_sign_equal_jax(name):
    _, jk, jdata, pk, pdata = auth_case(name)
    assert convert.auth_keys_from_jax(jk) == pk
    assert convert.auth_data_from_jax(jdata) == pdata
    assert len(pk.sak.prf_seed) == 32 and len(pdata) == 2


@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_prf_sig_hash_and_schnorr_equal_jax(name):
    hc, jhc = port_ads.host_curve(name), jax_ads.host_curve(name)
    r = hc.fr_spec.p
    rng = random.Random(name)
    seed = bytes(rng.randrange(256) for _ in range(32))
    for label in (b"", b"a", b"label-0", bytes(range(200))):
        assert port_ads._prf(seed, label, r) == jax_ads._prf(seed, label, r)
    Lambda = auth_case(name)[4][0].Lambda
    R = hc.g1.mul(rng.randrange(1, r), hc.g1_gen)
    assert port_ads._sig_hash(b"x", Lambda, R, r) == jax_ads._sig_hash(b"x", Lambda, R, r)
    assert port_ads._sig_hash(b"x", None, R, r) == jax_ads._sig_hash(b"x", None, R, r)
    ps, js = port_ads._Schnorr(hc), jax_ads._Schnorr(jhc)
    prng, jrng = random.Random(5), random.Random(5)
    (psk, pvk), (jsk, jvk) = ps.keygen(prng), js.keygen(jrng)
    assert (psk, pvk) == (jsk, jvk)
    sig = ps.sign(psk, b"m", Lambda, prng)
    assert sig == js.sign(jsk, b"m", Lambda, jrng)
    assert ps.verify(pvk, b"m", Lambda, sig) and js.verify(jvk, b"m", Lambda, sig)
    bad = (sig[0] + 1, sig[1])
    assert not ps.verify(pvk, b"m", Lambda, bad) and not js.verify(jvk, b"m", Lambda, bad)


@pytest.mark.parametrize("case,want", [
    ("accept", (True, True)), ("changed value", (False, False)), ("wrong label", (False, False)),
    ("forged signature", (True, False))])
def test_auth_verifiers_decide_as_jax(memo, case, want):
    """The JAX package's cases (tests/test_adsnark.py, on MNT4753): (sym,
    pub) of both packages; a forged signature leaves the MAC right, so only
    the public check sees it."""
    name = "MNT4753"
    values, jk, jdata, pk, pdata = auth_case(name)
    p = PORT_MODELS[name].get("cpu").Fr.p
    labels = labels_for(len(values))
    if case == "changed value":
        values = values[:1] + [(values[1] + 1) % p]
    elif case == "wrong label":
        labels = [b"other-0"] + labels[1:]
    elif case == "forged signature":
        forge = lambda data: [replace(data[0], sigma=(data[0].sigma[0] + 1, data[0].sigma[1]))] + \
            data[1:]
        pdata, jdata = forge(pdata), forge(jdata)
    pm = PORT_MODELS[name].get("cpu")
    got = (port_ads.auth_verify_sym(pm, values, pdata, pk.sak, labels),
           port_ads.auth_verify_pub(pm, values, pdata, pk.pak, labels))
    assert got == want
    assert (jax_auth(jax_ads.auth_verify_sym, name, values, jdata, jk.sak, labels),
            jax_auth(jax_ads.auth_verify_pub, name, values, jdata, jk.pak, labels)) == want


# ---------------------------------------------------------------------------
# the replay: keys and proof by the JAX instance map, the oracle and the
# JAX formulas
# ---------------------------------------------------------------------------

def example(name: str = CURVE):
    """The key pair's example: five constraints, two inputs (d + 1 = 8)."""
    p = PORT_MODELS[name].get("cpu").Fr.p
    return generate_r1cs_example_with_field_input(p, 5, NUM_INPUTS, random.Random(EXAMPLE_SEED))


class Comb:
    """s P for many s and one base P by tools/oracle.py's group law: the
    table d 16^j P (0 < d < 16) once, then one addition a nonzero 4-bit
    digit, about a sixth of the additions of double-and-add."""

    def __init__(self, group, P, bits: int = 753):
        self.group, self.rows = group, []
        for _ in range((bits + 3) // 4):
            row = [None, P]
            for _ in range(14):
                row.append(group.add(row[-1], P))
            self.rows.append(row)
            P = group.add(row[8], row[8])  # 16 P

    def mul(self, s: int):
        acc, j = None, 0
        while s:
            if s & 15:
                acc = self.group.add(acc, self.rows[j][s & 15])
            s >>= 4
            j += 1
        return acc


_COMBS = {}


def combs(name: str):
    """(G1 comb, G2 comb) on the curve's generators, once a process."""
    if name not in _COMBS:
        cur = orc.ORACLES[name]()
        _COMBS[name] = (Comb(cur.g1, cur.g1_gen), Comb(cur.g2, cur.g2_gen))
    return _COMBS[name]


def expected_keys(name: str, cs, prms_I1, rng):
    """The JAX generator's keys (adsnark.py:252-366) for ``cs`` and the draws
    of ``rng``, by the JAX instance map's scalars and tools/oracle.py's exact
    group law, as JAX ``ProvingKey`` / ``VerificationKey`` (the identity
    stored as (0, 0)), with the secrets."""
    cur = orc.ORACLES[name]()
    Fr = JAX_MODELS[name].get().Fr
    spec = JAX_MODELS[name].get().Fq.spec
    p = Fr.p
    t = rng.randrange(1, p)
    inst = jax_qap.instance_map_with_evaluation(cs, t, Fr)
    m, n, l, Zt = inst.num_variables, inst.domain_size, inst.num_inputs, inst.Zt
    At, Bt, Ct = (list(v) + [Zt] for v in (inst.At, inst.Bt, inst.Ct))
    alphaA, alphaB, alphaC, rA, rB, beta, gamma = (rng.randrange(1, p) for _ in range(7))
    rC = rA * rB % p
    K = [beta * (rA * At[i] + rB * Bt[i] + rC * Ct[i]) % p for i in range(m + 1)]
    K += [beta * rX % p * Zt % p for rX in (rA, rB, rC)]
    cG, cH = combs(name)
    g1s = lambda scalars: [cG.mul(v % p) for v in scalars]
    pts = {"A_g": g1s([rA * v for v in At]), "A_h": g1s([rA * alphaA * v for v in At]),
           "B_g": [cH.mul(rB * v % p) for v in Bt], "B_h": g1s([rB * alphaB * v for v in Bt]),
           "C_g": g1s([rC * v for v in Ct]), "C_h": g1s([rC * alphaC * v for v in Ct]),
           "H": g1s(inst.Ht[: n + 1]), "K": g1s(K)}

    def planes(values):
        return ints_to_limbs([spec.to_mont(v) for v in values])

    def g1_pair(points):
        return (planes([0 if P is None else P[0] for P in points]),
                planes([0 if P is None else P[1] for P in points]))

    def g2_pair(points):
        comp = lambda k: np.stack([planes([0 if P is None else P[k][c] for P in points])
                                   for c in range(cur.ext_deg)])
        return comp(0), comp(1)

    jpk = jax_ads.ProvingKey(
        curve=name, A_query_g=g1_pair(pts["A_g"]), A_query_h=g1_pair(pts["A_h"]),
        B_query_g=g2_pair(pts["B_g"]), B_query_h=g1_pair(pts["B_h"]),
        C_query_g=g1_pair(pts["C_g"]), C_query_h=g1_pair(pts["C_h"]), H_query=g1_pair(pts["H"]),
        K_query=g1_pair(pts["K"]), rA_i_Z_g1=cur.g1.mul(rA * Zt % p, prms_I1),
        constraint_system=cs)
    gb = gamma * beta % p
    jvk = jax_ads.VerificationKey(
        curve=name, alphaA_g2=cH.mul(alphaA), alphaB_g1=cG.mul(alphaB), alphaC_g2=cH.mul(alphaC),
        gamma_g2=cH.mul(gamma), gamma_beta_g1=cG.mul(gb), gamma_beta_g2=cH.mul(gb),
        rC_Z_g2=cH.mul(rC * Zt % p), A0=pts["A_g"][0], Ain=pts["A_g"][1 : l + 1])
    secrets = {"t": t, "At": At, "Bt": Bt, "Ct": Ct, "K": K, "rA": rA, "rB": rB, "rC": rC,
               "beta": beta, "n": n, "points": pts}
    return jpk, jvk, secrets


def replay_proof(name: str, cs, primary, auxiliary, auth_data, rA_i_Z_g1, sec, rng):
    """The JAX assembly (adsnark.py:470-527) over tools/oracle.py's MSMs of
    the expected key's points, d1, d2, d3, dauth drawn from ``rng``, K's row
    m + 1 times d1 + dauth (libsnark); checked on the way against the
    scalars A(t), B(t), C(t), H(t), K(t) with no MSM.  Returns the proof and
    the JAX package's g_K, which takes d1 alone there."""
    cur = orc.ORACLES[name]()
    p = cur.fr_spec.p
    d1, d2, d3, dauth = (rng.randrange(p) for _ in range(4))
    h = patched_h(name, cs, primary, auxiliary, (d1 + dauth) % p, d2, d3)
    w = [v % p for v in list(primary) + list(auxiliary)]
    m, l = len(w), len(primary)
    cG, cH = combs(name)
    g1 = lambda s: cG.mul(s % p)
    At, Bt, Ct, rA, rB, rC = (sec[k] for k in ("At", "Bt", "Ct", "rA", "rB", "rC"))

    def kc(group, pts, d):
        """pts[0] + d pts[m + 1] + <pts[1..m], w>."""
        return group.add(group.add(pts[0], group.mul(d, pts[m + 1])), group.msm(w, pts[1 : m + 1]))

    def aux_in(pts, ww, d):
        """d pts[m + 1] + <pts[1..m], ww>."""
        return cur.g1.add(cur.g1.mul(d, pts[m + 1]), cur.g1.msm(ww, pts[1 : m + 1]))

    P = sec["points"]
    w_aux, w_in = [0] * l + w[l:], w[:l] + [0] * (m - l)
    g_A = (aux_in(P["A_g"], w_aux, d1), aux_in(P["A_h"], w_aux, d1))
    g_Aau = (aux_in(P["A_g"], w_in, dauth), aux_in(P["A_h"], w_in, dauth))
    g_B = (kc(cur.g2, P["B_g"], d2), kc(cur.g1, P["B_h"], d2))
    g_C = (kc(cur.g1, P["C_g"], d3), kc(cur.g1, P["C_h"], d3))
    g_H = cur.g1.msm(h, P["H"])
    K = P["K"]
    g_K_rest = cur.g1.add(cur.g1.msm(w, K[1 : m + 1]), K[0])
    for d, row in ((d2, m + 2), (d3, m + 3)):
        g_K_rest = cur.g1.add(g_K_rest, cur.g1.mul(d, K[row]))
    g_K, jax_g_K = (cur.g1.add(g_K_rest, cur.g1.mul(d % p, K[m + 1])) for d in (d1 + dauth, d1))
    muA = cur.g1.mul(dauth, rA_i_Z_g1)
    for ad, Ain_i in zip(auth_data, P["A_g"][1 : l + 1]):
        muA = cur.g1.add(muA, cur.g1.mul(ad.mu, Ain_i))
    # the same points from the scalars at t (Z(t) = row m + 1)
    one = [1] + w
    X = {k: sum(a * b for a, b in zip(one, sec[k][: m + 1])) % p for k in ("At", "Bt", "Ct")}
    Zt = Bt[m + 1]
    a_in = sum(a * b for a, b in zip(one[1 : l + 1], At[1 : l + 1])) % p
    a, b, c = X["At"] + (d1 + dauth) * Zt, X["Bt"] + d2 * Zt, X["Ct"] + d3 * Zt
    assert (g_A[0], g_Aau[0], g_B[0], g_C[0], g_H) == (
        g1(rA * (X["At"] - At[0] - a_in + d1 * Zt)), g1(rA * (a_in + dauth * Zt)),
        cH.mul(rB * b % p), g1(rC * c), g1((a * b - c) * pow(Zt, -1, p)))
    assert g_K == g1(sec["beta"] * (rA * a + rB * b + rC * c))  # beta (rA A' + rB B' + rC C')
    return (jax_ads.Proof(g_A=g_A, g_B=g_B, g_C=g_C, g_H=g_H, g_K=g_K, g_Aau=g_Aau, muA=muA),
            jax_g_K)


# ---------------------------------------------------------------------------
# the key pair and the proof on MNT6753
# ---------------------------------------------------------------------------

def _prove():
    model = PORT_MODELS[CURVE].get("cpu")
    ex = example()
    keys = port_ads.auth_generator(model, random.Random(AUTH_SEED))
    data = port_ads.auth_sign(model, ex.primary_input, keys.sak, labels_for(NUM_INPUTS),
                              random.Random(AUTH_SEED + 1))
    kp = port_ads.generator(model, ex.constraint_system, keys.pap, random.Random(KEY_SEED))
    proof = port_ads.prover(model, kp.pk, ex.primary_input, ex.auxiliary_input, data,
                            random.Random(PROVE_SEED))
    return keys, data, kp, proof


def proved(tmp_path_factory):
    """The port's auth keys, auth data, key pair and proof on the CPU, once
    a test session."""
    return _once(tmp_path_factory, f"adsnark-prove-{CURVE}", lambda d: _prove())[1]


_EXPECTED = {}


def jax_r1cs(cs):
    """The port's constraint system -> the JAX package's (the same terms)."""
    out = jax_r1cs_mod.R1CSConstraintSystem(cs.p, cs.primary_input_size, cs.auxiliary_input_size)
    LC = jax_r1cs_mod.LinearCombination
    for c in cs.constraints:
        out.add_constraint(jax_r1cs_mod.R1CSConstraint(LC(c.a.terms), LC(c.b.terms),
                                                       LC(c.c.terms), c.is_square))
    return out


def expected(keys):
    """(JAX R1CS, expected JAX keys, secrets) of the replay."""
    if "keys" not in _EXPECTED:
        jcs = jax_r1cs(example().constraint_system)
        _EXPECTED["keys"] = (jcs, *expected_keys(CURVE, jcs, keys.pap.I1, random.Random(KEY_SEED)))
    return _EXPECTED["keys"]


QUERIES = ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g", "C_query_h",
           "H_query", "K_query")


def test_keys_are_the_oracle_replay(tmp_path_factory):
    keys, _, kp, _ = proved(tmp_path_factory)
    _, jpk, jvk, sec = expected(keys)
    pk, want = kp.pk, convert.adsnark_proving_key_from_jax(jpk, "cpu")
    for key in QUERIES:
        for got_c, want_c in zip(getattr(pk, key), getattr(want, key)):
            assert got_c.dtype == torch.int32 and torch.equal(got_c, want_c), key
    m = pk.constraint_system.num_variables
    assert pk.B_query_g[0].shape == (3, 24, m + 2) and pk.K_query[0].shape == (24, m + 4)
    assert pk.H_query[0].shape == (24, sec["n"] + 1) and sec["n"] == 8
    # A keeps its input rows (no IC split)
    assert pk.A_query_g[1][:, 1 : NUM_INPUTS + 1].any(dim=0).all()
    assert pk.rA_i_Z_g1 == want.rA_i_Z_g1
    assert kp.vk == convert.adsnark_verification_key_from_jax(jvk)
    assert len(kp.vk.Ain) == NUM_INPUTS


def replayed(tmp_path_factory):
    """The replay's proof and the JAX package's g_K, once a process."""
    if "proof" not in _EXPECTED:
        keys, data, _, _ = proved(tmp_path_factory)
        jcs, jpk, _, sec = expected(keys)
        ex = example()
        _EXPECTED["proof"] = replay_proof(CURVE, jcs, ex.primary_input, ex.auxiliary_input, data,
                                          jpk.rA_i_Z_g1, sec, random.Random(PROVE_SEED))
    return _EXPECTED["proof"]


def test_proof_is_the_oracle_replay(tmp_path_factory):
    _, _, _, proof = proved(tmp_path_factory)
    assert proof == convert.adsnark_proof_from_jax(replayed(tmp_path_factory)[0])


def _jax_objects(keys, data, kp, proof):
    jm = JAX_MODELS[CURVE].get()
    jvk = jax_ads.VerificationKey(**vars(kp.vk))
    jkeys = jax_ads.AuthKeys(pap=jax_ads.PubAuthPrms(**vars(keys.pap)),
                             pak=jax_ads.PubAuthKey(**vars(keys.pak)),
                             sak=jax_ads.SecAuthKey(**vars(keys.sak)))
    jdata = [jax_ads.AuthData(**vars(ad)) for ad in data]
    return jm, jvk, jkeys, jdata


_MEMO = {}


@pytest.fixture
def memo(monkeypatch):
    """Both packages' host scalar multiplication (on (field, k, P)) and
    reduced pairing (on (curve, P, Q)) memoised: pure functions, which the
    verdicts below call again and again on the same points."""
    for mod in (jax_curves, port_curves):
        real_mul = mod.HostGroup.mul

        def mul(self, k, P, real=real_mul, tag=mod.__name__):
            key = (tag, self.F.p, self.F.deg, k, P)
            if key not in _MEMO:
                _MEMO[key] = real(self, k, P)
            return _MEMO[key]

        monkeypatch.setattr(mod.HostGroup, "mul", mul)
    for mod in (jax_ate, port_ate):
        real_pairing = mod.AtePairing.reduced_pairing

        def pairing(self, P, Q, real=real_pairing, tag=mod.__name__):
            key = (tag, self.hc.name, P, Q)
            if key not in _MEMO:
                _MEMO[key] = real(self, P, Q)
            return _MEMO[key]

        monkeypatch.setattr(mod.AtePairing, "reduced_pairing", pairing)


def verdicts(tmp_path_factory, proof, labels=None, data=None):
    """(port sym, port pub, JAX sym, JAX pub) on ``proof``, the port's keys."""
    keys, real_data, kp, _ = proved(tmp_path_factory)
    labels = labels_for(NUM_INPUTS) if labels is None else labels
    data = real_data if data is None else data
    jm, jvk, jkeys, jdata = _jax_objects(keys, data, kp, proof)
    jproof = jax_ads.Proof(**vars(proof))
    pm = PORT_MODELS[CURVE].get("cpu")
    return (port_ads.verifier_sym(pm, kp.vk, proof, keys.sak, labels),
            port_ads.verifier_pub(pm, kp.vk, proof, data, keys.pak, labels),
            jax_ads.verifier_sym(jm, jvk, jproof, jkeys.sak, labels),
            jax_ads.verifier_pub(jm, jvk, jproof, jdata, jkeys.pak, labels))


def test_proof_verifies(tmp_path_factory, memo):
    _, _, _, proof = proved(tmp_path_factory)
    assert verdicts(tmp_path_factory, proof) == (True,) * 4


def test_jax_k_term_fails_the_verifiers(tmp_path_factory, memo):
    """The JAX assembly's g_K (d1 alone at K's row m + 1, adsnark.py:520)
    is the port's minus dauth K[m + 1]; every verifier rejects that proof."""
    keys, _, kp, proof = proved(tmp_path_factory)
    sec = expected(keys)[3]
    jax_g_K = replayed(tmp_path_factory)[1]
    cur = orc.ORACLES[CURVE]()
    draws = random.Random(PROVE_SEED)
    dauth = [draws.randrange(cur.fr_spec.p) for _ in range(4)][3]
    k_row = sec["points"]["K"][kp.pk.constraint_system.num_variables + 1]
    assert cur.g1.add(jax_g_K, cur.g1.mul(dauth, k_row)) == proof.g_K
    assert verdicts(tmp_path_factory, replace(proof, g_K=jax_g_K)) == (False,) * 4


def test_wrong_labels_rejected(tmp_path_factory, memo):
    _, _, _, proof = proved(tmp_path_factory)
    wrong = [b"x-0", b"x-1"]
    assert verdicts(tmp_path_factory, proof, labels=wrong) == (False,) * 4
    swapped = labels_for(NUM_INPUTS)[::-1]
    assert verdicts(tmp_path_factory, proof, labels=swapped) == (False,) * 4


def test_forged_label_signature_rejected(tmp_path_factory, memo):
    """Only the public verifier reads the signatures; the MAC still holds."""
    _, data, _, proof = proved(tmp_path_factory)
    forged = [replace(data[0], sigma=(data[0].sigma[0] + 1, data[0].sigma[1]))] + data[1:]
    assert verdicts(tmp_path_factory, proof, data=forged) == (True, False, True, False)


PARTS = ["g_A.g", "g_A.h", "g_B.g", "g_B.h", "g_C.g", "g_C.h", "g_H", "g_K", "g_Aau.g",
         "g_Aau.h", "muA"]


@pytest.mark.parametrize("part", PARTS)
def test_tampered_proof_rejected(tmp_path_factory, memo, part):
    """Each element moved by a generator: the MAC, the pairing aggregation
    or one of the five checks sees it."""
    _, _, _, proof = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    field, _, half = part.partition(".")
    value = getattr(proof, field)
    if half:
        k = "gh".index(half)
        group, gen = (cur.g2, cur.g2_gen) if part == "g_B.g" else (cur.g1, cur.g1_gen)
        value = tuple(group.add(v, gen) if i == k else v for i, v in enumerate(value))
    else:
        value = cur.g1.add(value, cur.g1_gen)
    assert verdicts(tmp_path_factory, replace(proof, **{field: value})) == (False,) * 4


def test_proof_off_curve_rejected(tmp_path_factory, memo):
    _, _, _, proof = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    assert all(cur.g1.is_on_curve(P) for P in (*proof.g_A, proof.g_B[1], *proof.g_C, proof.g_H,
                                               proof.g_K, *proof.g_Aau, proof.muA))
    assert cur.g2.is_on_curve(proof.g_B[0])
    x, y = proof.g_K
    assert verdicts(tmp_path_factory, replace(proof, g_K=(x, (y + 1) % cur.fq_spec.p))) == \
        (False,) * 4


def test_unsatisfied_witness_raises(tmp_path_factory):
    keys, data, kp, _ = proved(tmp_path_factory)
    ex = example()
    bad = list(ex.auxiliary_input)
    bad[-1] += 1
    with pytest.raises(ValueError, match="does not satisfy"):
        port_ads.prover(mnt6753.get("cpu"), kp.pk, ex.primary_input, bad, data, random.Random(1))
