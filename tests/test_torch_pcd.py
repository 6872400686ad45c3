"""The port's single-predicate PCD (``proof_systems/pcd.py``) against the
JAX package's, on the counter predicate of the JAX package's
tests/test_pcd.py (out = in + local): predicate satisfaction; the
predicate and its messages through ``convert``; the base-case step circuit
and the arity-1 step circuit over MNT6753 (an in-circuit verifier of an
MNT4753 proof) equal to the JAX package's term for term, with equal
witnesses; ``fill`` true on the real predecessor proof and false on a
forged one or a wrong outgoing message.  The predecessor's key and proof
are made from host scalars with the port's host code, as in
tests/test_torch_verifier_gadget.py.  ``SPPCDProver`` runs on the card
unless asked for the CPU; its key generation and proofs at these sizes are
the smoke's ``pcd`` phase on the card (``chip_smoke.py``), not run here:
in plain PyTorch a key pair and a proof take minutes."""

import pytest
import torch

from snark_challenge_prover_tpu.proof_systems import pcd as jax_pcd
from snark_challenge_prover_tpu.relations import r1cs as jax_r1cs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as g16
from snark_challenge_prover_tpu_torch.proof_systems import pcd
from snark_challenge_prover_tpu_torch.relations import r1cs
from test_torch_verifier_gadget import summary, vk_and_proof

torch.set_num_threads(1)


def counter_predicate(p, mod=jax_pcd, rel=jax_r1cs):
    """out_value = in_value + inc over [1 | out_type, out_value | arity |
    in_type, in_value | inc]; primary = the outgoing message."""
    cs = rel.R1CSConstraintSystem(p, primary_input_size=2, auxiliary_input_size=4)
    LC = rel.LinearCombination
    cs.add_constraint(rel.R1CSConstraint(LC.of_var(5) + LC.of_var(6), LC.of_var(0), LC.of_var(2)))
    return mod.CompliancePredicate(
        name=1, type=1, constraint_system=cs, outgoing_message_payload_length=1, max_arity=1,
        incoming_message_payload_lengths=[1], local_data_length=1, witness_length=0)


def both_predicates(p):
    jax_pred = counter_predicate(p)
    return jax_pred, convert.compliance_predicate_from_jax(jax_pred)


def test_predicate_satisfaction():
    _, pred = both_predicates(host_curve("MNT6753").fq_spec.p)
    M, D = pcd.R1CSPCDMessage, pcd.R1CSPCDLocalData
    assert pred.is_satisfied(M(1, [8]), [M(1, [5])], D([3]), [])
    assert not pred.is_satisfied(M(1, [9]), [M(1, [5])], D([3]), [])


def test_predicate_and_messages_convert_from_jax():
    jax_pred, pred = both_predicates(host_curve("MNT4753").fq_spec.p)
    want = counter_predicate(jax_pred.constraint_system.p, pcd, r1cs)
    cs, want_cs = pred.constraint_system, want.constraint_system
    assert isinstance(pred, pcd.CompliancePredicate) and isinstance(cs, r1cs.R1CSConstraintSystem)
    assert {**vars(pred), "constraint_system": None} == {**vars(want), "constraint_system": None}
    assert (cs.p, cs.primary_input_size, cs.auxiliary_input_size) == (
        want_cs.p, want_cs.primary_input_size, want_cs.auxiliary_input_size)
    assert [(c.a.terms, c.b.terms, c.c.terms) for c in cs.constraints] == [
        (c.a.terms, c.b.terms, c.c.terms) for c in want_cs.constraints]
    msg = convert.pcd_message_from_jax(jax_pcd.R1CSPCDMessage(type=1, payload=[3]))
    ld = convert.pcd_local_data_from_jax(jax_pcd.R1CSPCDLocalData(payload=[7]))
    assert (msg, ld) == (pcd.R1CSPCDMessage(1, [3]), pcd.R1CSPCDLocalData([7]))
    for jm, pm in ((jax_pcd.R1CSPCDMessage(1, [3]), msg),
                   (jax_pcd.R1CSPCDLocalData([7]), ld)):
        assert jm.as_assignment() == pm.as_assignment()


def _messages(mod, value: int, local: int, p: int):
    return (mod.R1CSPCDMessage(1, [(value + local) % p]), [mod.R1CSPCDMessage(1, [value])],
            mod.R1CSPCDLocalData([local]))


def test_base_case_step_circuit_equals_jax():
    """Arity 0 over MNT4753: the predicate alone, with the zeroed incoming
    slot; fill true for (1, 3), false for (1, 4)."""
    p = host_curve("MNT6753").fq_spec.p
    jax_pred, pred = both_predicates(p)
    got = []
    for mod, pr in ((jax_pcd, jax_pred), (pcd, pred)):
        circ = mod.PCDStepCircuit("MNT4753", pr, arity=0)
        out, inc, ld = _messages(mod, 0, 3, p)
        ok = circ.fill(out, inc, ld, [])
        snap, primary = summary(circ.pb), circ.pb.primary_input()
        bad = circ.fill(mod.R1CSPCDMessage(1, [4]), inc, ld, [])
        got.append((snap, ok, bad, primary))
    assert got[1] == got[0]
    assert got[1][1:3] == (True, False) and got[1][3] == [1, 3]
    assert [c.a.terms for c in pcd.PCDStepCircuit("MNT4753", pred).pb.constraints] == [
        c.a.terms for c in pred.constraint_system.constraints]


@pytest.fixture(scope="module")
def recursive():
    """The arity-1 step circuit over MNT6753 verifying an MNT4753 proof
    whose public input (1, 3) is the incoming message, built and filled
    with both packages (the JAX one summarised and dropped)."""
    vk, proof, _ = vk_and_proof("MNT4753", 2, 7, (1, 3))
    p = host_curve("MNT4753").fq_spec.p
    jax_pred, pred = both_predicates(p)
    circ = jax_pcd.PCDStepCircuit("MNT6753", jax_pred, inner_vk=vk, arity=1)
    out, inc, ld = _messages(jax_pcd, 3, 7, p)
    jax_ok = circ.fill(out, inc, ld, [], inner_proofs=[proof])
    want = summary(circ.pb), jax_ok
    del circ
    circ = pcd.PCDStepCircuit("MNT6753", pred, inner_vk=vk, arity=1)
    out, inc, ld = _messages(pcd, 3, 7, p)
    ok = circ.fill(out, inc, ld, [], inner_proofs=[proof])
    return circ, want, ok, (vk, proof, out, inc, ld)


def test_recursive_step_circuit_equals_jax(recursive):
    circ, (want, jax_ok), ok, _ = recursive
    got = summary(circ.pb)
    assert (circ.pb.num_constraints, circ.pb.num_variables) == (len(want["terms"]),
                                                                len(want["values"]))
    assert got == want
    assert ok and jax_ok


def test_recursive_fill_rejects_forged_proof_and_wrong_message(recursive):
    circ, _, _, (vk, proof, out, inc, ld) = recursive
    hc = host_curve("MNT4753")
    assert g16.verifier_strong_IC(vk, [1, 3], proof)
    forged = g16.Proof(g_A=hc.g1.add(proof.g_A, hc.g1_gen), g_B=proof.g_B, g_C=proof.g_C)
    assert circ.fill(out, inc, ld, [], inner_proofs=[forged]) is False
    wrong = pcd.R1CSPCDMessage(1, [out.payload[0] + 1])
    assert circ.fill(wrong, inc, ld, [], inner_proofs=[proof]) is False


def test_prover_defaults_to_the_card():
    """SPPCDProver's model is the card's unless the caller asks for the CPU;
    without a card it raises, and a missing inner key raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcd.SPPCDProver("MNT4753")._model()
    assert pcd.SPPCDProver("MNT6753", "cpu")._model().name == "MNT6753"
    _, pred = both_predicates(host_curve("MNT4753").fq_spec.p)
    with pytest.raises(ValueError, match="inner vk"):
        pcd.PCDStepCircuit("MNT6753", pred, arity=1)
