"""The port's in-circuit pairing and Groth16 verifier gadgets against the
JAX package's, on both inner curves: ``ReducedPairingGadget``,
``Groth16VerifierGadget`` (the verification key as constants) and
``Groth16VerifierGadgetVarVK`` (the key as wires, with its knapsack digest),
each filled from one verification key and valid proof made from host
scalars with the port's host code (alpha, beta, delta, the IC scalars, a
and b drawn, c solved from the verification equation).  Each circuit is
built with both packages' modules: equal constraint systems term for term
(a hash of each constraint's terms, with every annotation), equal witnesses
and result values.  The port's circuits are satisfied by the valid proof
and not by a forged one or a wrong public input.  The JAX side is built
first and dropped before the port's, to bound the memory.  The garbage
collector is paused through each case (``collector_paused``): its passes
over the circuits' millions of objects would take most of the time."""

import functools
import gc
import random

import pytest

from snark_challenge_prover_tpu.gadgets import field_ext_gadgets as jax_ext
from snark_challenge_prover_tpu.gadgets import pairing_gadgets as jax_pairing
from snark_challenge_prover_tpu.gadgets import protoboard as jax_pb
from snark_challenge_prover_tpu.gadgets import verifier_gadget as jax_verifier
from snark_challenge_prover_tpu.host.curves import host_curve as jax_host_curve
from snark_challenge_prover_tpu_torch.gadgets import field_ext_gadgets as ext
from snark_challenge_prover_tpu_torch.gadgets import pairing_gadgets as pairing
from snark_challenge_prover_tpu_torch.gadgets import protoboard as pbm
from snark_challenge_prover_tpu_torch.gadgets.protoboard import collector_paused
from snark_challenge_prover_tpu_torch.gadgets import verifier_gadget as verifier
from snark_challenge_prover_tpu_torch.gadgets.knapsack import knapsack_hash_fields
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as g16
from snark_challenge_prover_tpu_torch.proof_systems.ate_pairing import AtePairing

PORT = (pbm, ext, pairing, verifier, host_curve)
JAX = (jax_pb, jax_ext, jax_pairing, jax_verifier, jax_host_curve)


@functools.lru_cache(maxsize=None)
def vk_and_proof(name: str, num_inputs: int = 2, seed: int = 5, primary: tuple = None):
    """A verification key and a valid proof from host scalars: A = a G1,
    B = b G2, C = c G1 with a b = alpha beta + acc + c delta, acc the
    inputs' IC scalar sum; the inputs ``primary``, else drawn.  Returns
    (vk, proof, primary)."""
    hc = host_curve(name)
    r = hc.fr_spec.p
    rng = random.Random(seed)
    alpha, beta, delta, a, b = (rng.randrange(1, r) for _ in range(5))
    ic = [rng.randrange(1, r) for _ in range(num_inputs + 1)]
    drawn = [rng.randrange(r) for _ in range(num_inputs)]
    primary = drawn if primary is None else list(primary)
    acc = (ic[0] + sum(x * s for x, s in zip(primary, ic[1:]))) % r
    c = (a * b - alpha * beta - acc) * pow(delta, -1, r) % r
    G, H = hc.g1_gen, hc.g2_gen
    vk = g16.VerificationKey(
        curve=name, delta_g2=hc.g2.mul(delta, H), ABC_g1=[hc.g1.mul(s, G) for s in ic],
        alpha_g1_beta_g2=AtePairing(hc).reduced_pairing(hc.g1.mul(alpha, G), hc.g2.mul(beta, H)))
    proof = g16.Proof(g_A=hc.g1.mul(a, G), g_B=hc.g2.mul(b, H), g_C=hc.g1.mul(c, G))
    return vk, proof, tuple(primary)


def summary(pb) -> dict:
    """A protoboard compared without keeping it: a hash of each constraint's
    terms, every annotation and the assignment."""
    return {"p": pb.p, "inputs": pb._num_inputs,
            "terms": [hash((tuple(c.a.terms), tuple(c.b.terms), tuple(c.c.terms), c.is_square))
                      for c in pb.constraints],
            "annotations": list(pb.annotations), "values": list(pb._values)}


def build(pkg, name: str, kind: str, vk, proof, primary):
    """The gadget ``kind`` over inner curve ``name`` with one package's
    modules, filled from (vk, proof, primary): (protoboard, gadget)."""
    pbmod, extmod, pairmod, vermod, hcfn = pkg
    hc = hcfn(name)
    pb = pbmod.Protoboard(hc.g2.F.p)
    if kind == "pairing":
        deg = hc.g2.F.deg
        px, py = pb.allocate_var("px"), pb.allocate_var("py")
        pb.set_val(px, proof.g_A[0])
        pb.set_val(py, proof.g_A[1])
        qx, qy = (extmod.ExtVariable.allocate(pb, deg, n) for n in ("qx", "qy"))
        qx.set(pb, proof.g_B[0])
        qy.set(pb, proof.g_B[1])
        g = pairmod.ReducedPairingGadget(pb, hc, (px, py), (qx, qy))
        g.generate_r1cs_witness()
    elif kind == "hardcoded":
        g = vermod.Groth16VerifierGadget(pb, hc, vk, num_inputs=len(primary))
        g.generate_r1cs_witness(primary, proof)
    else:
        g = vermod.Groth16VerifierGadgetVarVK(pb, hc, num_inputs=len(primary))
        g.generate_r1cs_witness(vk, primary, proof)
    return pb, g


def result_values(kind, g):
    if kind == "pairing":
        return g.result_values()
    if kind == "hardcoded":
        return [g.pair_AB.result_values(), g.pair_acc.result_values(), g.pair_C.result_values()]
    return [g.pair_AB.result_values(), g.pair_C.result_values(), g.vk_digest.index]


CASES = [("MNT4753", "pairing"), ("MNT4753", "hardcoded"), ("MNT4753", "varvk"),
         ("MNT6753", "hardcoded"), ("MNT6753", "varvk")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def compared(request):
    """Both packages' circuits of one kind: the JAX one's summary and
    results (built first and dropped), the port's protoboard and gadget,
    and whether the port's is satisfied.  The collector stays paused while
    the case's tests run; the previous case's circuits, which hold
    reference cycles, are collected first."""
    name, kind = request.param
    vk, proof, primary = vk_and_proof(name)
    primary = list(primary)
    gc.collect()
    with collector_paused():
        pb, g = build(JAX, name, kind, vk, proof, primary)
        want = summary(pb), result_values(kind, g)
        del pb, g
        pb, g = build(PORT, name, kind, vk, proof, primary)
        yield name, kind, vk, proof, primary, want, pb, g, pb.is_satisfied()


def test_constraint_system_equals_jax(compared):
    name, kind, _, _, _, (want, _), pb, _, _ = compared
    got = summary(pb)
    assert (len(got["terms"]), len(got["values"])) == (len(want["terms"]), len(want["values"]))
    for key in ("p", "inputs", "annotations", "terms"):
        assert got[key] == want[key], key


def test_witness_and_results_equal_jax(compared):
    name, kind, _, _, _, (want, want_results), pb, g, satisfied = compared
    assert list(pb._values) == want["values"]
    assert result_values(kind, g) == want_results
    assert satisfied


def _pairing_equals_host(name, kind, proof, g):
    hc = host_curve(name)
    pair = g if kind == "pairing" else g.pair_AB
    want = AtePairing(hc).reduced_pairing(proof.g_A, proof.g_B)
    F = hc.g2.F
    return pair.result_values() == (tuple(F.components(want[0])), tuple(F.components(want[1])))


def _digest_is_knapsack(name, vk, primary, pb, g):
    elems = verifier.vk_field_elements(host_curve(name), vk, len(primary))
    return pb.val(g.vk_digest) == knapsack_hash_fields(pb.p, elems)


def test_pairing_and_digest_equal_host(compared):
    """The circuit's e(A, B) is the host ate pairing's; the variable-key
    gadget's digest wire is the knapsack hash of the key's flattening."""
    name, kind, vk, proof, primary, _, pb, g, _ = compared
    assert _pairing_equals_host(name, kind, proof, g)
    assert kind != "varvk" or _digest_is_knapsack(name, vk, primary, pb, g)


def violates_a_constraint(pb) -> bool:
    """Some constraint fails on the protoboard's assignment, that is, it is
    not satisfied: searched from the last constraint, where the verifiers'
    equality pins sit, so a failure there is found without the full pass."""
    vals, p = pb._values, pb.p
    return any(c.a.evaluate(vals, p) * c.b.evaluate(vals, p) % p != c.c.evaluate(vals, p)
               for c in reversed(pb.constraints))


def test_forged_proof_and_wrong_input_unsatisfied(compared):
    """A forged A (A + G1) leaves the verifier's equality pins broken, and
    so does a wrong first input, for both verifiers on both inner curves;
    for the pairing gadget alone, a nudged G1 x input breaks its chain.
    The valid assignment is put back after."""
    name, kind, vk, proof, primary, _, pb, g, _ = compared
    valid = list(pb._values)
    try:
        if kind == "pairing":  # px is the first wire
            pb.set_val(pbm.PBVariable(1), proof.g_A[0] + 1)
            assert violates_a_constraint(pb)
            return
        hc = host_curve(name)
        forged = g16.Proof(g_A=hc.g1.add(proof.g_A, hc.g1_gen), g_B=proof.g_B, g_C=proof.g_C)
        wrong = [(primary[0] + 1) % hc.fr_spec.p] + primary[1:]
        for inputs, prf in ((primary, forged), (wrong, proof)):
            if kind == "hardcoded":
                g.generate_r1cs_witness(inputs, prf)
            else:
                g.generate_r1cs_witness(vk, inputs, prf)
            assert violates_a_constraint(pb)
    finally:
        pb._values[:] = valid
