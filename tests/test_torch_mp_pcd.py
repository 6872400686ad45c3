"""The port's multi-predicate PCD circuits (``proof_systems/mp_pcd.py``)
against the JAX package's, on the two-key set of the JAX package's
tests/test_mp_pcd.py: two MNT4753 verification keys and a proof under the
first, made from host scalars with the port's host code
(``test_torch_verifier_gadget.vk_and_proof``), with the counter predicate
of tests/test_torch_pcd.py.

  * ``vk_digest`` and ``vk_set_commitment`` equal the JAX package's on the
    same keys, and the commitment depends on the keys' order;
  * the MNT6753 ``MPPCDStepCircuit`` at arity 1 (a variable-key verifier of
    an MNT4753 proof, its key's digest authenticated against a depth-1 set
    commitment: 213295 constraints), built and filled by both packages,
    equal term for term with every annotation and witness value;
  * both packages' fill verdicts: the right key at slot 0 satisfies; key 1
    at slot 1, key 0 at slot 1 and a forged proof (A + G1) do not.

The round trip through ``MPPCDProver`` on the CPU is
tests/test_torch_mp_pcd_prover.py; on the card it is the smoke's ``mp_pcd``
phase."""

import gc

import pytest
import torch

from snark_challenge_prover_tpu.host.curves import host_curve as jax_host_curve
from snark_challenge_prover_tpu.proof_systems import mp_pcd as jax_mp
from snark_challenge_prover_tpu.proof_systems import pcd as jax_pcd
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.gadgets.protoboard import collector_paused
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as g16
from snark_challenge_prover_tpu_torch.proof_systems import mp_pcd, pcd
from test_torch_pcd import counter_predicate
from test_torch_verifier_gadget import summary, vk_and_proof

torch.set_num_threads(1)

PRIMARY = (1, 3)  # the inner proof's input: the incoming message (type 1, value 3)


def key_set():
    """(vk0, vk1, proof under vk0), all over MNT4753 with input PRIMARY."""
    vk0, proof, _ = vk_and_proof("MNT4753", 2, 42, PRIMARY)
    vk1, _, _ = vk_and_proof("MNT4753", 2, 77, PRIMARY)
    return vk0, vk1, proof


def test_vk_digest_and_commitment_equal_jax():
    vk0, vk1, _ = key_set()
    hc, jhc = host_curve("MNT4753"), jax_host_curve("MNT4753")
    for n in (1, 2):
        assert mp_pcd.vk_digest(hc, vk0, n) == jax_mp.vk_digest(jhc, vk0, n)
    got = mp_pcd.vk_set_commitment(hc, [vk0, vk1], 2)
    assert got == jax_mp.vk_set_commitment(jhc, [vk0, vk1], 2)
    root, leaves = got
    assert leaves == [mp_pcd.vk_digest(hc, vk, 2) for vk in (vk0, vk1)] and leaves[0] != leaves[1]
    swapped = mp_pcd.vk_set_commitment(hc, [vk1, vk0], 2)
    assert swapped == jax_mp.vk_set_commitment(jhc, [vk1, vk0], 2)
    assert swapped[0] != root  # order-sensitive
    three = mp_pcd.vk_set_commitment(hc, [vk0, vk1, vk0], 2)
    assert three == jax_mp.vk_set_commitment(jhc, [vk0, vk1, vk0], 2)
    assert three[1][3] == 0  # padded to four leaves


def fill_verdicts(circ, mod, root, leaves, vk0, vk1, proof):
    """The right fill (then the circuit's summary) and the three wrong ones."""
    hc = host_curve("MNT4753")
    inc, ld = mod.R1CSPCDMessage(1, [PRIMARY[1]]), mod.R1CSPCDLocalData([7])
    out = mod.R1CSPCDMessage(1, [PRIMARY[1] + 7])
    forged = g16.Proof(g_A=hc.g1.add(proof.g_A, hc.g1_gen), g_B=proof.g_B, g_C=proof.g_C)
    right = circ.fill(out, [inc], ld, [], root, inner=[(vk0, proof, 0, leaves)])
    snap = summary(circ.pb)
    wrong = [circ.fill(out, [inc], ld, [], root, inner=[edge]) for edge in (
        (vk1, proof, 1, leaves), (vk0, proof, 1, leaves), (vk0, forged, 0, leaves))]
    return snap, [right] + wrong


@pytest.fixture(scope="module")
def compared():
    """Both packages' step circuits, built and filled (the JAX one
    summarised and dropped first): (JAX summary and verdicts, the port's
    circuit, summary and verdicts)."""
    vk0, vk1, proof = key_set()
    p = host_curve("MNT4753").fq_spec.p
    jax_pred = counter_predicate(p)
    root, leaves = mp_pcd.vk_set_commitment(host_curve("MNT4753"), [vk0, vk1], 2)
    gc.collect()
    with collector_paused():
        circ = jax_mp.MPPCDStepCircuit("MNT6753", jax_pred, set_depth=1, arity=1)
        want = fill_verdicts(circ, jax_pcd, root, leaves, vk0, vk1, proof)
        del circ
        circ = mp_pcd.MPPCDStepCircuit("MNT6753", convert.compliance_predicate_from_jax(jax_pred),
                                       set_depth=1, arity=1)
        got = fill_verdicts(circ, pcd, root, leaves, vk0, vk1, proof)
        yield want, circ, got
    gc.collect()


def test_step_circuit_equals_jax(compared):
    (want, _), circ, (got, _) = compared
    assert circ.pb.num_constraints == len(want["terms"]) == 213295
    assert len(circ.verifiers) == len(circ.set_gadgets) == 1
    assert got == want


def test_fill_verdicts_equal_jax(compared):
    (_, want), _, (_, got) = compared
    assert got == want == [True, False, False, False]


def test_public_wires_are_the_message_and_the_arity(compared):
    """The circuit's n + 1 public wires are the outgoing message and the
    arity wire after it, not the commitment (allocated last)."""
    _, circ, _ = compared
    circ.fill(pcd.R1CSPCDMessage(1, [10]), [pcd.R1CSPCDMessage(1, [3])],
              pcd.R1CSPCDLocalData([7]), [], 12345, inner=[(*key_set()[::2], 0, [0, 0])])
    assert circ.pb.primary_input() == [1, 10, 1]
    assert circ.pb.val(circ.commitment) == 12345


def test_wrong_witness_length_raises(compared):
    _, circ, _ = compared
    with pytest.raises(ValueError, match="predicate wires"):
        circ.fill(pcd.R1CSPCDMessage(1, [10]), [pcd.R1CSPCDMessage(1, [3])],
                  pcd.R1CSPCDLocalData([7]), [0], 0, inner=[(*key_set()[::2], 0, [0, 0])])
