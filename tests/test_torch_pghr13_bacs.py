"""The port's PGHR13 (r1cs_ppzksnark) and the BACS adapter on it, on
device="cpu", against the JAX package and exact integers.

  * BACS relation and reduction: the circuit's wires, outputs and
    satisfiability, and the R1CS and witness of ``bacs_to_r1cs``, equal the
    JAX package's;
  * one key pair and proof on MNT6753 (once a test session): the BACS
    generator and prover on a five-gate circuit, which are PGHR13's on the
    circuit's R1CS (six constraints, one input, d + 1 = 8).  PGHR13's keys
    equal keys made from the same draws by the JAX QAP instance map's
    scalars and tools/oracle.py's exact multiplication, the reference's
    quirks included (K's row m + 1 skipped, A's input rows zeroed after K is
    formed); the BACS key carries the circuit as the JAX package's does; the
    proof equals a replay of the JAX PGHR13 assembly (pghr13.py:310-373)
    over tools/oracle.py's MSMs, H the oracle's quotient plus the
    zero-knowledge patch, d1, d2, d3 in the JAX order; a wrong witness
    raises;
  * verifiers: accept, wrong input, the strong IC's length check, each
    proof element tampered and a point off the curve, decided alike by the
    port's and the JAX package's PGHR13 verifiers (and the BACS aliases).

The JAX generator and prover are never run (their fixed-base and MSM
programs compile for minutes); the port's generator and prover run once a
test session (about a minute each).  Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.proof_systems import bacs_ppzksnark as jax_bacs_snark
from snark_challenge_prover_tpu.proof_systems import pghr13 as jax_pghr13
from snark_challenge_prover_tpu.reductions import bacs_to_r1cs as jax_bacs_to_r1cs
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import bacs as jax_bacs
from snark_challenge_prover_tpu.relations import r1cs as jax_r1cs
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import bacs_ppzksnark as port_bacs_snark
from snark_challenge_prover_tpu_torch.proof_systems import pghr13 as port_pghr13
from snark_challenge_prover_tpu_torch.reductions import bacs_to_r1cs as port_bacs_to_r1cs
from snark_challenge_prover_tpu_torch.relations import bacs as port_bacs
from snark_challenge_prover_tpu_torch.relations import r1cs as port_r1cs
from test_torch_keygen import _once
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
CURVE = "MNT6753"  # the key pair's curve
KEY_SEED, PROVE_SEED = 8, 23


# ---------------------------------------------------------------------------
# the replay: keys and proofs by the JAX instance map, the oracle and the
# JAX assembly
# ---------------------------------------------------------------------------

def expected_keys(name: str, cs, rng):
    """The JAX generator's keys (pghr13.py:112-227) for ``cs`` and the draws
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
    # K: rows 0..m, row m + 1 skipped, then the three Z rows; the IC before
    # A loses its input rows
    K = [beta * (rA * At[i] + rB * Bt[i] + rC * Ct[i]) % p for i in range(m + 1)]
    K += [beta * rX % p * Zt % p for rX in (rA, rB, rC)]
    IC = At[: l + 1]
    A0 = [0] * (l + 1) + At[l + 1 :]
    G, H = cur.g1_gen, cur.g2_gen

    def planes(values):
        return ints_to_limbs([spec.to_mont(v) for v in values])

    def g1_pair(scalars):
        pts = [cur.g1.mul(s % p, G) for s in scalars]
        return (planes([0 if P is None else P[0] for P in pts]),
                planes([0 if P is None else P[1] for P in pts]))

    def g2_pair(scalars):
        pts = [cur.g2.mul(s % p, H) for s in scalars]
        comp = lambda k: np.stack([planes([0 if P is None else P[k][c] for P in pts])
                                   for c in range(cur.ext_deg)])
        return comp(0), comp(1)

    jpk = jax_pghr13.ProvingKey(
        curve=name, A_query_g=g1_pair([rA * v for v in A0]),
        A_query_h=g1_pair([rA * alphaA * v for v in A0]),
        B_query_g=g2_pair([rB * v for v in Bt]), B_query_h=g1_pair([rB * alphaB * v for v in Bt]),
        C_query_g=g1_pair([rC * v for v in Ct]), C_query_h=g1_pair([rC * alphaC * v for v in Ct]),
        H_query=g1_pair(inst.Ht[: n + 1]), K_query=g1_pair(K), constraint_system=cs)
    ic = [cur.g1.mul(rA * v % p, G) for v in IC]
    jvk = jax_pghr13.VerificationKey(
        curve=name, alphaA_g2=cur.g2.mul(alphaA, H), alphaB_g1=cur.g1.mul(alphaB, G),
        alphaC_g2=cur.g2.mul(alphaC, H), gamma_g2=cur.g2.mul(gamma, H),
        gamma_beta_g1=cur.g1.mul(gamma * beta % p, G), gamma_beta_g2=cur.g2.mul(gamma * beta % p, H),
        rC_Z_g2=cur.g2.mul(rC * Zt % p, H), encoded_IC_base=ic[0], encoded_IC_values=ic[1:])
    secrets = {"t": t, "A0": A0, "At": At, "Bt": Bt, "Ct": Ct, "K": K, "rA": rA, "rB": rB,
               "rC": rC, "alphaA": alphaA, "alphaB": alphaB, "alphaC": alphaC, "n": n}
    return jpk, jvk, secrets


def patched_h(name: str, cs, primary, auxiliary, d1, d2, d3):
    """H's n + 1 coefficients by tools/oracle.py: the quotient (A B - C) /
    (x^n - 1), plus d2 A + d1 B - d3 + d1 d2 (x^n - 1) in coefficient form."""
    cur = orc.ORACLES[name]()
    fr = cur.fr_spec
    p = fr.p
    aA, aB, aC = jax_qap.assemble_abc_evaluations(cs, primary, auxiliary,
                                                  JAX_MODELS[name].get().Fr)
    n = len(aA)
    h = orc.compute_h(n - 1, aA, aB, aC, fr)
    omega = fr.get_root_of_unity(n)
    A, B = orc.ifft(aA, omega, p), orc.ifft(aB, omega, p)
    h = [(h[k] + d2 * A[k] + d1 * B[k]) % p for k in range(n)] + [d1 * d2 % p]
    h[0] = (h[0] - d3 - d1 * d2) % p
    return h


def replay_proof(name: str, cs, primary, auxiliary, sec, rng):
    """The JAX assembly (pghr13.py:310-373) over tools/oracle.py's MSMs of
    the expected key's points, d1, d2, d3 drawn from ``rng``; checked on
    the way against the scalars A(t), B(t), C(t), H(t) with no MSM."""
    cur = orc.ORACLES[name]()
    p = cur.fr_spec.p
    d1, d2, d3 = (rng.randrange(p) for _ in range(3))
    h = patched_h(name, cs, primary, auxiliary, d1, d2, d3)
    w = [v % p for v in list(primary) + list(auxiliary)]
    m = len(w)
    G, H = cur.g1_gen, cur.g2_gen
    g1 = lambda s: cur.g1.mul(s % p, G)

    def kc(group, base, scalars, d):
        """query[0] + d query[m + 1] + <query[1..m], w>, the query scalars * base."""
        pts = [group.mul(s % p, base) for s in scalars]
        return group.add(group.add(pts[0], group.mul(d, pts[m + 1])), group.msm(w, pts[1 : m + 1]))

    A0, Bt, Ct, rA, rB, rC = (sec[k] for k in ("A0", "Bt", "Ct", "rA", "rB", "rC"))
    g_A = (kc(cur.g1, G, [rA * v for v in A0], d1),
           kc(cur.g1, G, [rA * sec["alphaA"] * v for v in A0], d1))
    g_B = (kc(cur.g2, H, [rB * v for v in Bt], d2),
           kc(cur.g1, G, [rB * sec["alphaB"] * v for v in Bt], d2))
    g_C = (kc(cur.g1, G, [rC * v for v in Ct], d3),
           kc(cur.g1, G, [rC * sec["alphaC"] * v for v in Ct], d3))
    t = sec["t"]
    g_H = cur.g1.msm(h, [g1(pow(t, i, p)) for i in range(len(h))])
    K = sec["K"]
    g_K = cur.g1.msm(w, [g1(v) for v in K[1 : m + 1]])
    for d, row in ((d1, m + 1), (d2, m + 2), (d3, m + 3)):
        g_K = cur.g1.add(g_K, cur.g1.mul(d, g1(K[row])))
    g_K = cur.g1.add(g_K, g1(K[0]))
    # the same points from the scalars at t (Z(t) = row m + 1 of A, B and C)
    one = [1] + w
    X = {k: sum(a * b for a, b in zip(one, sec[k][: m + 1])) % p for k in ("A0", "Bt", "Ct")}
    Zt = Bt[m + 1]
    a, b, c = X["A0"] + d1 * Zt, X["Bt"] + d2 * Zt, X["Ct"] + d3 * Zt
    at = (X["A0"] + sum(wi * v for wi, v in zip(one[: len(primary) + 1], sec["At"]))) % p
    h_t = ((at + d1 * Zt) * b - c) * pow(Zt, -1, p)
    assert (g_A[0], g_B[0], g_C[0], g_H) == (g1(rA * a), cur.g2.mul(rB * b % p, H), g1(rC * c),
                                             g1(h_t))
    return jax_pghr13.Proof(g_A=g_A, g_B=g_B, g_C=g_C, g_H=g_H, g_K=g_K)


# ---------------------------------------------------------------------------
# the circuit
# ---------------------------------------------------------------------------

def circuit_spec(p: int, num_gates: int, seed: int):
    """A random satisfiable circuit over one primary and two auxiliary
    inputs, as plain data: each gate's (lhs terms, rhs terms, output,
    is_circuit_output) over earlier wires (index 0 the constant), the lhs
    always holding the wire just before; the last gate (w - value) * 1 = 0
    a circuit output; and its inputs."""
    rng = random.Random(seed)
    primary, auxiliary = [rng.randrange(p)], [rng.randrange(p) for _ in range(2)]
    wires = primary + auxiliary
    gates = []

    def terms():
        return [(rng.randrange(len(wires) + 1), rng.randrange(1, p)) for _ in range(rng.randrange(1, 3))]

    for _ in range(num_gates - 1):
        lhs, rhs = [(len(wires), rng.randrange(1, p))] + terms(), terms()
        value = 1
        for lc in (lhs, rhs):
            value = value * sum(c * (1 if i == 0 else wires[i - 1]) for i, c in lc) % p
        gates.append((lhs, rhs, len(wires) + 1, False))
        wires.append(value)
    gates.append(([(len(wires), 1), (0, p - wires[-1])], [(0, 1)], len(wires) + 1, True))
    return gates, primary, auxiliary


def build_circuit(bacs_mod, r1cs_mod, p: int, gates):
    circuit = bacs_mod.BACSCircuit(p, primary_input_size=1, auxiliary_input_size=2)
    LC = r1cs_mod.LinearCombination
    for lhs, rhs, out, is_out in gates:
        circuit.add_gate(bacs_mod.BACSGate(LC(lhs), LC(rhs), out, is_out))
    return circuit


def bacs_case(num_gates: int = 5, name: str = CURVE):
    """(JAX circuit, port circuit, primary, auxiliary); with five gates the
    R1CS has six constraints and one input, a QAP domain of 8."""
    p = JAX_MODELS[name].get().Fr.p
    gates, primary, auxiliary = circuit_spec(p, num_gates, KEY_SEED)
    return (build_circuit(jax_bacs, jax_r1cs, p, gates), build_circuit(port_bacs, port_r1cs, p, gates),
            primary, auxiliary)


def _terms(cs):
    return [(c.a.terms, c.b.terms, c.c.terms, c.is_square) for c in cs.constraints]


@pytest.mark.parametrize("num_gates", [1, 5, 12])
def test_bacs_relation_and_reduction_match_jax(num_gates):
    jc, pc, primary, auxiliary = bacs_case(num_gates)
    assert (pc.num_inputs, pc.num_gates, pc.num_wires) == (jc.num_inputs, jc.num_gates, jc.num_wires)
    assert pc.is_valid() and jc.is_valid()
    assert pc.get_all_wires(primary, auxiliary) == jc.get_all_wires(primary, auxiliary)
    assert pc.get_all_outputs(primary, auxiliary) == jc.get_all_outputs(primary, auxiliary) == [0]
    assert pc.is_satisfied(primary, auxiliary) and jc.is_satisfied(primary, auxiliary)
    bad = auxiliary[:-1] + [(auxiliary[-1] + 1) % pc.p]  # the gates chain through the last input
    assert not pc.is_satisfied(primary, bad) and not jc.is_satisfied(primary, bad)
    cs, jcs = port_bacs_to_r1cs.instance_map(pc), jax_bacs_to_r1cs.instance_map(jc)
    assert _terms(cs) == _terms(jcs) and cs.num_constraints == num_gates + 1
    assert (cs.primary_input_size, cs.auxiliary_input_size) == (jcs.primary_input_size,
                                                                jcs.auxiliary_input_size)
    wires = port_bacs_to_r1cs.witness_map(pc, primary, auxiliary)
    assert wires == jax_bacs_to_r1cs.witness_map(jc, primary, auxiliary)
    assert cs.is_satisfied(primary, wires[1:])
    bad_wires = port_bacs_to_r1cs.witness_map(pc, primary, bad)
    assert not cs.is_satisfied(primary, bad_wires[1:])
    assert convert.bacs_circuit_from_reference(jc).get_all_wires(primary, auxiliary) == wires


def test_bacs_invalid_circuit_refused():
    _, pc, _, _ = bacs_case()
    with pytest.raises(ValueError, match="topologically"):
        pc.add_gate(port_bacs.BACSGate(port_r1cs.LinearCombination.of_var(1),
                                       port_r1cs.LinearCombination.of_var(1), pc.num_wires + 2))
    pc.gates[0].lhs = port_r1cs.LinearCombination.of_var(pc.num_wires)  # a wire not yet assigned
    assert not pc.is_valid()
    with pytest.raises(ValueError):
        port_bacs_to_r1cs.instance_map(pc)


# ---------------------------------------------------------------------------
# the key pair and the proof: BACS on MNT6753, which is PGHR13 on the
# circuit's R1CS
# ---------------------------------------------------------------------------

_EXPECTED = {}


def expected():
    """(JAX R1CS, expected JAX keys, secrets) of the PGHR13 replay on the
    circuit's R1CS."""
    if not _EXPECTED:
        jcs = jax_bacs_to_r1cs.instance_map(bacs_case()[0])
        _EXPECTED["keys"] = (jcs, *expected_keys(CURVE, jcs, random.Random(KEY_SEED + 1)))
    return _EXPECTED["keys"]


def _prove():
    _, pc, primary, auxiliary = bacs_case()
    model = PORT_MODELS[CURVE].get("cpu")
    kp = port_bacs_snark.generator(model, pc, random.Random(KEY_SEED + 1))
    return kp, port_bacs_snark.prover(model, kp.pk, primary, auxiliary, random.Random(PROVE_SEED))


def proved(tmp_path_factory):
    """The port's BACS key pair and proof on the CPU, once a test session."""
    return _once(tmp_path_factory, f"bacs-pghr13-prove-{CURVE}", lambda d: _prove())[1]


QUERIES = ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g", "C_query_h",
           "H_query", "K_query")


def test_keys_are_the_jax_replay(tmp_path_factory):
    """PGHR13's keys (the BACS generator's) against the replay, the K and IC
    quirks included."""
    kp, _ = proved(tmp_path_factory)
    _, jpk, jvk, sec = expected()
    pk, want = kp.pk.r1cs_pk, convert.pghr13_proving_key_from_jax(jpk, "cpu")
    for key in QUERIES:
        for got_c, want_c in zip(getattr(pk, key), getattr(want, key)):
            assert got_c.dtype == torch.int32 and torch.equal(got_c, want_c), key
    m = pk.constraint_system.num_variables
    assert pk.B_query_g[0].shape == (3, 24, m + 2) and pk.K_query[0].shape == (24, m + 4)
    assert pk.H_query[0].shape == (24, sec["n"] + 1)
    # A's input rows are identities (moved to the IC)
    assert not pk.A_query_g[1][:, :2].any() and not pk.A_query_h[1][:, :2].any()
    assert kp.vk == convert.pghr13_verification_key_from_jax(jvk)
    assert len(kp.vk.encoded_IC_values) == 1


def test_bacs_key_is_the_jax_packages(tmp_path_factory):
    """The BACS proving key carries the circuit and PGHR13's key, as the JAX
    package's does (``convert.bacs_proving_key_from_jax``)."""
    kp, _ = proved(tmp_path_factory)
    jc, _, primary, auxiliary = bacs_case()
    _, jpk, _, _ = expected()
    want = convert.bacs_proving_key_from_jax(jax_bacs_snark.ProvingKey(circuit=jc, r1cs_pk=jpk),
                                             "cpu")
    assert _terms(want.r1cs_pk.constraint_system) == _terms(kp.pk.r1cs_pk.constraint_system)
    assert want.circuit.get_all_wires(primary, auxiliary) == \
        kp.pk.circuit.get_all_wires(primary, auxiliary)
    for key in QUERIES:
        assert all(torch.equal(a, b) for a, b in zip(getattr(want.r1cs_pk, key),
                                                     getattr(kp.pk.r1cs_pk, key)))


def test_proof_is_the_jax_replay(tmp_path_factory):
    """The BACS proof is PGHR13's on the circuit's R1CS: the JAX assembly's
    replay with the same seeds."""
    _, proof = proved(tmp_path_factory)
    jcs, _, _, sec = expected()
    jc, _, primary, auxiliary = bacs_case()
    wires = jax_bacs_to_r1cs.witness_map(jc, primary, auxiliary)
    want = replay_proof(CURVE, jcs, primary, wires[1:], sec, random.Random(PROVE_SEED))
    assert proof == convert.pghr13_proof_from_jax(want)


def test_wrong_witness_raises(tmp_path_factory):
    """An assignment that breaks a gate (PGHR13 directly), or inputs that
    leave the output nonzero (through the BACS prover), raise."""
    kp, _ = proved(tmp_path_factory)
    _, _, primary, auxiliary = bacs_case()
    model = mnt6753.get("cpu")
    wires = port_bacs_to_r1cs.witness_map(kp.pk.circuit, primary, auxiliary)
    bad = wires[1:]
    bad[-2] += 1
    with pytest.raises(ValueError, match="does not satisfy"):
        port_pghr13.prover(model, kp.pk.r1cs_pk, primary, bad, random.Random(1))
    with pytest.raises(ValueError, match="does not satisfy"):
        port_bacs_snark.prover(model, kp.pk, primary, auxiliary[:-1] + [auxiliary[-1] + 1],
                               random.Random(1))


def _verdicts(tmp_path_factory, proof, primary, strong=True):
    kp, _ = proved(tmp_path_factory)
    jvk = expected()[2]
    jproof = jax_pghr13.Proof(**vars(proof))
    if strong:
        return (port_pghr13.verifier_strong_IC(kp.vk, primary, proof),
                jax_pghr13.verifier_strong_IC(jvk, primary, jproof))
    return (port_pghr13.verifier_weak_IC(kp.vk, primary, proof),
            jax_pghr13.verifier_weak_IC(jvk, primary, jproof))


def test_proof_verifies(tmp_path_factory):
    kp, proof = proved(tmp_path_factory)
    primary = bacs_case()[2]
    assert _verdicts(tmp_path_factory, proof, primary) == (True, True)
    assert _verdicts(tmp_path_factory, proof, primary, strong=False) == (True, True)
    jproof = jax_pghr13.Proof(**vars(proof))
    assert port_bacs_snark.verifier_strong_IC(kp.vk, primary, proof)
    assert jax_bacs_snark.verifier_strong_IC(expected()[2], primary, jproof)


def test_wrong_input_rejected(tmp_path_factory):
    _, proof = proved(tmp_path_factory)
    bad = [(bacs_case()[2][0] + 1) % mnt6753.get("cpu").Fr.p]
    assert _verdicts(tmp_path_factory, proof, bad) == (False, False)


def test_strong_ic_length_check(tmp_path_factory):
    _, proof = proved(tmp_path_factory)
    primary = bacs_case()[2]
    assert _verdicts(tmp_path_factory, proof, primary[:0]) == (False, False)
    assert _verdicts(tmp_path_factory, proof, primary[:0], strong=False) == (False, False)
    assert _verdicts(tmp_path_factory, proof, primary + [1]) == (False, False)
    with pytest.raises(ValueError):
        port_pghr13.verifier_weak_IC(proved(tmp_path_factory)[0].vk, primary + [1], proof)


@pytest.mark.parametrize("part", ["g_A.g", "g_A.h", "g_B.g", "g_B.h", "g_C.g", "g_C.h", "g_H",
                                  "g_K"])
def test_tampered_proof_rejected(tmp_path_factory, part):
    """Each element moved by a generator: one of the five checks sees it."""
    _, proof = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    field, _, half = part.partition(".")
    value = getattr(proof, field)
    if half:
        k = "gh".index(half)
        group, gen = (cur.g2, cur.g2_gen) if part == "g_B.g" else (cur.g1, cur.g1_gen)
        value = tuple(group.add(v, gen) if i == k else v for i, v in enumerate(value))
    else:
        value = cur.g1.add(value, cur.g1_gen)
    bad = port_pghr13.Proof(**{**vars(proof), field: value})
    assert _verdicts(tmp_path_factory, bad, bacs_case()[2]) == (False, False)


def test_proof_off_curve_rejected(tmp_path_factory):
    _, proof = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    assert all(cur.g1.is_on_curve(P) for P in (*proof.g_A, proof.g_B[1], *proof.g_C, proof.g_H,
                                               proof.g_K))
    assert cur.g2.is_on_curve(proof.g_B[0])
    x, y = proof.g_K
    off = port_pghr13.Proof(**{**vars(proof), "g_K": (x, (y + 1) % cur.fq_spec.p)})
    assert _verdicts(tmp_path_factory, off, bacs_case()[2]) == (False, False)
