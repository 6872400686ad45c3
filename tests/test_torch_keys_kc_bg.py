"""The port's key format, knowledge commitment and BG prover on
device="cpu", against the JAX package and exact integers (MNT4753, the
d + 1 = 8 key of tests/test_torch_groth16_full.py).

  * key format: ``io.keys`` writes the JAX ``io.keys``'s bytes for the same
    proving key, verification key and proof, and reads them back to equal
    objects;
  * knowledge commitment: ``kc_multi_exp_fused`` equals ``kc_multi_exp``
    equals exact sums at N = 8 (64-bit scalars), and ``kc_batch_exp`` equals
    exact multiplication;
  * BG: ``bg.prover`` with d != 1 (its MSM stage given back from the
    Groth16 tests' prove of the same witness on the same key) gives the bytes
    replayed by exact integers and verifies under the port's and the JAX package's BG
    verifiers; the fork's literal QAP check closes only for d = 1 (the d = 1
    proof is the Groth16 proof with delta' = delta, as ``bg.prover`` makes
    it); component verification with a populated (y_s, z).

Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.io import keys as jax_keys
from snark_challenge_prover_tpu.proof_systems import bg as jax_bg
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.io import keys as port_keys
from snark_challenge_prover_tpu_torch.models import mnt4753
from snark_challenge_prover_tpu_torch.ops import fixed_base
from snark_challenge_prover_tpu_torch.ops.fft import host_table
from snark_challenge_prover_tpu_torch.ops.field import canonical_words
from snark_challenge_prover_tpu_torch.proof_systems import bg as port_bg
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as port_g16
from snark_challenge_prover_tpu_torch.proof_systems.groth16 import (_g1_proj_to_host,
                                                                    _g2_proj_to_host)
from snark_challenge_prover_tpu_torch.proof_systems.knowledge_commitment import (
    KCVector, kc_batch_exp, kc_multi_exp, kc_multi_exp_fused)
from test_torch_groth16_full import PROVE_SEED, keys, proof_of, recorded_msms, replay_proof
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

NAME = "MNT4753"
BG_D = 12345


# ---------------------------------------------------------------------------
# key format
# ---------------------------------------------------------------------------

def test_proving_key_bytes_are_the_jax_packages():
    k = keys(NAME)
    data = port_keys.write_proving_key(k["pk"])
    assert data == jax_keys.write_proving_key(k["jpk"])
    back = port_keys.read_proving_key(data, "cpu")
    for key in ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query"):
        for got, want in zip(getattr(back, key), getattr(k["pk"], key)):
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            assert torch.equal(got, want), key
    assert [back.alpha_g1, back.beta_g1, back.beta_g2, back.delta_g1, back.delta_g2] == [
        k["jpk"].alpha_g1, k["jpk"].beta_g1, k["jpk"].beta_g2, k["jpk"].delta_g1,
        k["jpk"].delta_g2]
    ex = k["ex"]
    assert back.constraint_system.is_satisfied(ex.primary_input, ex.auxiliary_input)
    assert port_keys.write_proving_key(back) == data
    with pytest.raises(ValueError, match="trailing"):
        port_keys.read_proving_key(data + b"\0", "cpu")


def test_read_proving_key_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_keys.read_proving_key(port_keys.write_proving_key(keys(NAME)["pk"]))


def test_verification_key_bytes_are_the_jax_packages():
    k = keys(NAME)
    data = port_keys.write_verification_key(k["vk"])
    assert data == jax_keys.write_verification_key(k["jvk"])
    back = port_keys.read_verification_key(data)
    assert back == k["vk"]
    assert port_keys.write_verification_key(back) == data


def test_proof_bytes_read_back(tmp_path_factory):
    proof = proof_of(tmp_path_factory, NAME)
    data = proof.to_bytes(mnt4753.get("cpu"))
    back = port_keys.read_proof(data, NAME)
    assert back == proof
    want = jax_keys.read_proof(data, NAME)
    assert (back.g_A, back.g_B, back.g_C) == (want.g_A, want.g_B, want.g_C)


# ---------------------------------------------------------------------------
# knowledge commitment
# ---------------------------------------------------------------------------

def _kc_points(model, cur, N):
    g2 = [cur.g2.mul(3 + i, cur.g2_gen) for i in range(N)]
    g1 = [cur.g1.mul(5 + 7 * i, cur.g1_gen) for i in range(N)]
    fq = model.Fq

    def affine(pts, deg):
        if deg == 1:
            return tuple(host_table(fq, [P[k] for P in pts]) for k in (0, 1))
        return tuple(torch.stack([host_table(fq, [P[k][c] for P in pts]) for c in range(deg)])
                     for k in (0, 1))

    return g2, g1, KCVector(g=model.G2.from_affine(*affine(g2, 2)),
                            h=model.G1.from_affine(*affine(g1, 1)))


def test_kc_multi_exp_fused_is_kc_multi_exp_is_exact():
    model = mnt4753.get("cpu")
    cur = orc.ORACLES[NAME]()
    N = 8
    g2, g1, kc = _kc_points(model, cur, N)
    rng = random.Random(4)
    scalars = [0, 1, (1 << 64) - 1] + [rng.randrange(1 << 64) for _ in range(N - 3)]
    s = canonical_words(model.Fr, scalars)
    fused = kc_multi_exp_fused(model.G2, model.G1, kc, s, scalar_bits=64)
    separate = kc_multi_exp(model.G2, model.G1, kc, s, scalar_bits=64)
    want = (cur.g2.msm(scalars, g2), cur.g1.msm(scalars, g1))
    for got in (fused, separate):
        assert (_g2_proj_to_host(model, got[0]), _g1_proj_to_host(model, got[1])) == want


def test_kc_batch_exp_is_exact_multiplication():
    model = mnt4753.get("cpu")
    cur = orc.ORACLES[NAME]()
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    bits, w1, w2 = 64, 3, 4
    t1 = fixed_base.get_window_table(G2, w1, model.g2_generator(), bits)
    t2 = fixed_base.get_window_table(G1, w2, model.g1_generator(), bits)
    scalars = [0, 1, 2, (1 << 62) - 1, 987654321]
    coeff = Fr.const(3)
    s_mont = Fr.from_canonical(canonical_words(Fr, scalars))
    kc = kc_batch_exp(G2, G1, w1, w2, t1, t2, coeff, coeff, s_mont, Fr, bits)
    # scalar_bits bounds the product coeff * s, which must fit the tables' windows
    assert all(3 * v < 1 << bits for v in scalars)
    for i, v in enumerate(scalars):
        assert _g2_proj_to_host(model, tuple(t[..., i] for t in kc.g)) == cur.g2.mul(3 * v, cur.g2_gen)
        assert _g1_proj_to_host(model, tuple(t[..., i] for t in kc.h)) == cur.g1.mul(3 * v, cur.g1_gen)


# ---------------------------------------------------------------------------
# BG
# ---------------------------------------------------------------------------

def bg_proof(tmp_path_factory):
    """``bg.prover`` with d = BG_D on the Groth16 tests' key, witness and seed,
    its MSM stage given back from their prove (the same queries and scalars,
    ``recorded_msms``)."""
    if not _BG:
        k = keys(NAME)
        ex = k["ex"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_g16, "groth16_msms", recorded_msms(tmp_path_factory, NAME))
            _BG.append(port_bg.prover(mnt4753.get("cpu"), k["pk"], BG_D, ex.primary_input,
                                      ex.auxiliary_input, random.Random(PROVE_SEED)))
    return _BG[0]


_BG = []


def _jax_bg(proof):
    return jax_bg.BGProof(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C,
                          delta_prime=proof.delta_prime, z=proof.z, y_s=proof.y_s)


def test_bg_proof_is_the_exact_replay(tmp_path_factory):
    """The same r and s as the Groth16 replay (the same seed), over
    delta' = d delta: A and B gain (r d) delta and (s d) delta, C =
    d^-1 (Ht + Lt) + s A + r B - r s d delta."""
    k = keys(NAME)
    cur, jpk = k["cur"], k["jpk"]
    g1, g2 = cur.g1, cur.g2
    p = cur.fr_spec.p
    gg, (HtLt, r, s, A0, B0, _) = replay_proof(NAME)
    got = bg_proof(tmp_path_factory)
    dg1, dg2 = g1.mul(BG_D, jpk.delta_g1), g2.mul(BG_D, jpk.delta_g2)
    # A0 = alpha + At + r delta: move its r delta to r delta'
    A = g1.add(A0, g1.mul(r * (BG_D - 1) % p, jpk.delta_g1))
    B1 = g1.add(B0, g1.mul(s * (BG_D - 1) % p, jpk.delta_g1))
    C = g1.add(g1.add(g1.mul(pow(BG_D, -1, p), HtLt), g1.mul(s, A)),
               g1.add(g1.mul(r, B1), g1.neg(g1.mul(r * s % p, dg1))))
    B = g2.add(gg.g_B, g2.mul(s * (BG_D - 1) % p, jpk.delta_g2))
    assert (got.g_A, got.g_B, got.g_C, got.delta_prime) == (A, B, C, dg2)
    assert got.delta_prime == g2.mul(BG_D, k["pk"].delta_g2)
    assert (got.z, got.y_s) == (None, None)


def test_bg_proof_verifies(tmp_path_factory):
    k = keys(NAME)
    proof = bg_proof(tmp_path_factory)
    primary = k["ex"].primary_input
    assert port_bg.verifier_strong_IC(k["vk"], primary, proof)
    assert port_bg.verifier_weak_IC(k["vk"], primary, proof)
    assert jax_bg.verifier_strong_IC(k["jvk"], primary, _jax_bg(proof))
    bad = [(primary[0] + 1) % k["cur"].fr_spec.p]
    assert not port_bg.verifier_strong_IC(k["vk"], bad, proof)
    assert not jax_bg.verifier_strong_IC(k["jvk"], bad, _jax_bg(proof))
    forged = port_bg.BGProof(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C,
                             delta_prime=k["vk"].delta_g2)
    assert not port_bg.verifier_strong_IC(k["vk"], primary, forged)
    assert not jax_bg.verifier_strong_IC(k["jvk"], primary, _jax_bg(forged))


def test_reference_literal_check_only_closes_for_d_one(tmp_path_factory):
    """The fork's online verifier pairs C with vk.delta_g2 (tcc:564-566):
    it closes for the d = 1 proof, which is the Groth16 proof with
    delta' = delta, and not for d != 1."""
    k = keys(NAME)
    primary = k["ex"].primary_input
    gg = proof_of(tmp_path_factory, NAME)
    p1 = port_bg.BGProof(g_A=gg.g_A, g_B=gg.g_B, g_C=gg.g_C, delta_prime=k["pk"].delta_g2)
    pd = bg_proof(tmp_path_factory)
    for proof, closes in ((p1, True), (pd, False)):
        assert port_bg.verifier_strong_IC(k["vk"], primary, proof)
        assert port_bg.verifier_strong_IC(k["vk"], primary, proof,
                                          reference_literal_qap_check=True) == closes
        assert jax_bg.verifier_strong_IC(k["jvk"], primary, _jax_bg(proof),
                                         reference_literal_qap_check=True) == closes


def test_bg_prover_refuses_d_zero():
    k = keys(NAME)
    ex = k["ex"]
    with pytest.raises(ValueError, match="nonzero"):
        port_bg.prover(mnt4753.get("cpu"), k["pk"], k["cur"].fr_spec.p, ex.primary_input,
                       ex.auxiliary_input, random.Random(1))


def test_verify_components(tmp_path_factory):
    """A caller-populated (y_s, z = d y_s) satisfies e(y_s, delta')
    e(-z, delta) = 1; z off by a point does not."""
    k = keys(NAME)
    cur = k["cur"]
    proof = bg_proof(tmp_path_factory)
    y_s = cur.g1.mul(987, cur.g1_gen)
    z = cur.g1.mul(BG_D, y_s)
    args = (proof.g_A, proof.g_B, proof.g_C, proof.delta_prime)
    primary = k["ex"].primary_input
    assert port_bg.verify_components(*args, z, y_s, k["vk"], primary)
    assert jax_bg.verify_components(*args, z, y_s, k["jvk"], primary)
    bad_z = cur.g1.add(z, cur.g1_gen)
    assert not port_bg.verify_components(*args, bad_z, y_s, k["vk"], primary)
    assert not jax_bg.verify_components(*args, bad_z, y_s, k["jvk"], primary)


def test_convert_carries_proofs_and_keys_unchanged():
    k = keys(NAME)
    vk = convert.verification_key_from_jax(k["jvk"])
    assert (vk.curve, vk.alpha_g1_beta_g2, vk.delta_g2, vk.ABC_g1) == (
        k["jvk"].curve, k["jvk"].alpha_g1_beta_g2, k["jvk"].delta_g2, k["jvk"].ABC_g1)
    assert isinstance(vk, port_g16.VerificationKey)
    assert np.array_equal(convert.planes_from_port(k["pk"].A_query[0]), k["jpk"].A_query[0])
