"""The port's ``MPPCDProver`` on the CPU (``device="cpu"``): the arity-0
round trip over two predicates of different payload lengths on MNT4753,
the counter predicate of tests/test_torch_pcd.py (payload 1) and a
two-word one (out = (in0 + local, in1), payload 2).  About 140 s serially:
two key generations and a prove in plain PyTorch (753 sequential doublings
a window table or a Horner chain).

  * the keys' commitment and leaves are the JAX package's ``vk_set_commitment``
    over the same keys with the one global ``num_inputs`` of its keygen (the
    largest 1 + payload, here 3), not with each predicate's own;
  * the proof under the counter's key verifies on the statement the step
    circuit makes public (the outgoing message and the arity wire), and not
    on a wrong message, under the other key, or on [message, commitment],
    the statement the JAX package's ``verify`` checks."""

import random

import pytest
import torch

from snark_challenge_prover_tpu.host.curves import host_curve as jax_host_curve
from snark_challenge_prover_tpu.proof_systems import mp_pcd as jax_mp
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as g16
from snark_challenge_prover_tpu_torch.proof_systems import mp_pcd, pcd
from snark_challenge_prover_tpu_torch.relations import r1cs
from test_torch_pcd import counter_predicate

torch.set_num_threads(1)


def pair_predicate(p):
    """out = (in0 + local, in1) over [1 | out type, out0, out1 | arity | in
    type, in0, in1 | local]; primary = the outgoing message."""
    cs = r1cs.R1CSConstraintSystem(p, primary_input_size=3, auxiliary_input_size=5)
    LC = r1cs.LinearCombination
    cs.add_constraint(r1cs.R1CSConstraint(LC.of_var(6) + LC.of_var(8), LC.of_var(0), LC.of_var(2)))
    cs.add_constraint(r1cs.R1CSConstraint(LC.of_var(7), LC.of_var(0), LC.of_var(3)))
    return pcd.CompliancePredicate(
        name=2, type=1, constraint_system=cs, outgoing_message_payload_length=2, max_arity=1,
        incoming_message_payload_lengths=[2], local_data_length=1, witness_length=0)


@pytest.fixture(scope="module")
def round_trip():
    p = host_curve("MNT6753").fq_spec.p
    preds = [counter_predicate(p, pcd, r1cs), pair_predicate(p)]
    prover = mp_pcd.MPPCDProver("MNT4753", "cpu")
    kp = prover.keygen(preds, random.Random(9))
    out = pcd.R1CSPCDMessage(1, [3])
    incoming, ld = [pcd.R1CSPCDMessage(1, [0])], pcd.R1CSPCDLocalData([3])
    proof = prover.prove(kp, 0, out, incoming, ld, [], random.Random(10))
    return prover, kp, out, proof


def test_commitment_uses_one_global_num_inputs(round_trip):
    _, kp, _, _ = round_trip
    jhc = jax_host_curve("MNT6753")
    assert [len(vk.ABC_g1) for vk in kp.vks] == [4, 5]
    assert (kp.commitment, kp.leaves) == jax_mp.vk_set_commitment(jhc, kp.vks, 3)
    assert kp.leaves[0] != jax_mp.vk_digest(jhc, kp.vks[0], 2)  # the counter's own 1 + payload


def test_round_trip_verifies(round_trip):
    prover, kp, out, proof = round_trip
    assert kp.circuits[0].pb.primary_input() == [1, 3, 1]
    assert prover.verify(kp, 0, out, proof, 1)
    assert not prover.verify(kp, 0, pcd.R1CSPCDMessage(1, [4]), proof, 1)
    assert not prover.verify(kp, 1, out, proof, 1)
    assert not g16.verifier_strong_IC(kp.vks[0], [1, 3, kp.commitment], proof)


def test_noncompliant_step_raises(round_trip):
    prover, kp, _, _ = round_trip
    with pytest.raises(ValueError, match="unsatisfied"):
        prover.prove(kp, 0, pcd.R1CSPCDMessage(1, [4]), [pcd.R1CSPCDMessage(1, [0])],
                     pcd.R1CSPCDLocalData([3]), [], random.Random(10))


def test_prover_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp_pcd.MPPCDProver("MNT4753")._model()
    assert mp_pcd.MPPCDProver("MNT6753", "cpu")._model().name == "MNT6753"
