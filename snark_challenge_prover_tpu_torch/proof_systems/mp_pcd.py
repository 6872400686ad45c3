"""Multi-predicate proof-carrying data (r1cs_mp_ppzkpcd structure).

Counterpart of the JAX package's ``proof_systems/mp_pcd.py`` (libsnark
r1cs_mp_ppzkpcd.{hpp,tcc} and mp_pcd_circuits.{hpp,tcc}): PCD over a SET of
compliance predicates.  Its differences from the single-predicate system
(``proof_systems/pcd.py``) are the reference's:

  * each predicate gets its own step circuit and key pair (keygen loops
    over the predicates);
  * inside a step circuit the verification key that checks an incoming
    proof is a WITNESS (the prover supplies whichever predicate made the
    predecessor), so the verifier gadget is the variable-key one
    (``gadgets/verifier_gadget.Groth16VerifierGadgetVarVK``);
  * that key is authenticated against a COMMITMENT to the key set: its
    knapsack digest must have a Merkle membership path to the commitment
    (``gadgets/knapsack.SetCommitmentGadget``);
  * the commitment is meant as a public input, not a constant, which breaks
    the circularity of key generation (the keys exist only after it).

Three properties of the JAX package are kept as they are, so that the
constraints, keys and proofs equal its own term for term:

  * ``MPPCDProver.keygen`` digests every key with one ``num_inputs``, the
    largest over the predicates, where the step circuits take one per edge;
  * the commitment that ``keygen`` makes is over the outer curve's own step
    keys, while a step circuit at arity >= 1 authenticates a key of the
    partner curve against it, and an mp proof has 1 + payload + 1 public
    inputs where the variable-key verifier takes 1 + payload.  A recursive
    step is driven as the JAX package's tests drive it: ``MPPCDStepCircuit``
    with a commitment over a set of plain Groth16 keys of the partner curve;
  * the commitment wire is allocated after every predicate wire, so the
    step circuit's ``set_input_sizes(n + 1)`` makes public the wire after
    the outgoing message, the arity, and leaves the commitment auxiliary.

The JAX package's ``verify`` checks a proof on [outgoing message,
commitment], which is not what the circuit makes public, so it rejects
every proof its ``prove`` makes.  The port's ``verify`` checks the statement
the circuit makes public, [outgoing message, number of incoming messages];
the keys and proofs are unchanged.

``MPPCDProver`` keys, proves and verifies through ``groth16_full`` on the
outer curve's model, on the card unless the caller asks for the CPU.  The
step circuits are built and filled on the host ("mp step circuit",
"mp fill"); the generator's and the prover's own blocks follow.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gadgets.knapsack import (
    SetCommitmentGadget,
    knapsack_hash_fields,
    merkle_knapsack_path,
    merkle_knapsack_root,
)
from ..gadgets.protoboard import Protoboard, collector_paused
from ..gadgets.verifier_gadget import Groth16VerifierGadgetVarVK, vk_field_elements
from ..host.curves import host_curve
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from ..utils.profiling import Profiler
from . import groth16_full as g16
from .pcd import CompliancePredicate, R1CSPCDMessage


def partner(curve: str) -> str:
    """The other curve of the MNT cycle."""
    return "MNT6753" if curve == "MNT4753" else "MNT4753"


def vk_digest(hc, vk, num_inputs: int) -> int:
    """Knapsack digest of the canonical vk flattening."""
    return knapsack_hash_fields(hc.g2.F.p, vk_field_elements(hc, vk, num_inputs))


def vk_set_commitment(hc, vks, num_inputs: int):
    """(root, leaves) for a power-of-two padded vk set."""
    leaves = [vk_digest(hc, vk, num_inputs) for vk in vks]
    n = 1
    while n < len(leaves):
        n *= 2
    leaves = leaves + [0] * (n - len(leaves))
    return merkle_knapsack_root(hc.g2.F.p, leaves), leaves


class MPPCDStepCircuit:
    """mp_compliance_step_pcd_circuit_maker: one predicate's constraints
    and, per incoming edge, a variable-key verifier whose key digest is
    set-committed against the commitment input wire."""

    def __init__(self, outer_curve: str, predicate: CompliancePredicate,
                 set_depth: int = 1, arity: int = 0):
        self.inner_hc = host_curve(partner(outer_curve))
        self.outer_curve = outer_curve
        self.predicate = predicate
        self.arity = arity
        self.set_depth = set_depth
        pb = Protoboard(self.inner_hc.g2.F.p)
        self.pb = pb

        n_pred_vars = predicate.constraint_system.num_variables
        self.pred_vars = [pb.allocate_var(f"pv{i}") for i in range(n_pred_vars)]
        # allocated after the predicate's wires: the n + 1 public wires are the
        # outgoing message and the arity, not the commitment (as in the JAX package)
        self.commitment = pb.allocate_var("setc_root")
        pb.set_input_sizes(predicate.constraint_system.primary_input_size + 1)
        for cons in predicate.constraint_system.constraints:
            pb.add_r1cs_constraint(R1CSConstraint(cons.a, cons.b, cons.c), "predicate")

        self.verifiers = []
        self.set_gadgets = []
        if arity > 0:
            msg_base = (1 + predicate.outgoing_message_payload_length) + 1
            for k in range(arity):
                payload_len = predicate.incoming_message_payload_lengths[
                    min(k, len(predicate.incoming_message_payload_lengths) - 1)]
                vg = Groth16VerifierGadgetVarVK(pb, self.inner_hc, num_inputs=1 + payload_len,
                                                annotation=f"mpv{k}")
                self.verifiers.append(vg)
                # authenticate the witness vk against the commitment
                sg = SetCommitmentGadget(pb, set_depth, vg.vk_digest, self.commitment.lc(),
                                         annotation=f"setc{k}")
                self.set_gadgets.append(sg)
                # bind the verified statement to the predicate's incoming-message wires
                for j in range(1 + payload_len):
                    pred_wire = self.pred_vars[msg_base + j]
                    pb.add_r1cs_constraint(
                        R1CSConstraint(LC.constant(1), pred_wire.lc() - vg.inputs[j].lc(),
                                       LC.constant(0)),
                        f"bind msg{k}.{j}")
                msg_base += 1 + payload_len

    def fill(self, outgoing, incoming, local_data, witness, commitment, inner=None):
        """Fill the predicate's wires, the commitment and, per edge, the
        verifier and the membership path from ``inner``: (vk, proof,
        leaf_index, leaves) an edge.  True iff the circuit is satisfied."""
        pb = self.pb
        assignment = outgoing.as_assignment()
        assignment.append(len(incoming))
        for msg in incoming:
            assignment += msg.as_assignment()
        assignment += local_data.as_assignment()
        assignment += list(witness)
        if len(assignment) != len(self.pred_vars):
            raise ValueError(f"{len(assignment)} values for {len(self.pred_vars)} predicate wires")
        for var, val in zip(self.pred_vars, assignment):
            pb.set_val(var, val)
        pb.set_val(self.commitment, commitment)
        for k, (vg, sg) in enumerate(zip(self.verifiers, self.set_gadgets)):
            vk, proof, leaf_index, leaves = inner[k]
            vg.generate_r1cs_witness(vk, incoming[k].as_assignment(), proof)
            bits, path = merkle_knapsack_path(pb.p, leaves, leaf_index)
            sg.generate_r1cs_witness(bits, path)
        return pb.is_satisfied()


@dataclass
class MPPCDKeypair:
    """r1cs_mp_ppzkpcd_keypair: one (pk, vk) per predicate and the vk-set
    commitment all step circuits authenticate against."""

    pks: list
    vks: list
    predicates: list
    commitment: int
    leaves: list
    circuits: list = field(default=None, repr=False, compare=False)


class MPPCDProver:
    """r1cs_mp_ppzkpcd generator / prover / verifier on one outer curve.
    ``device`` is the outer model's: the card unless the caller passes
    "cpu"."""

    def __init__(self, outer_curve: str = "MNT4753", device="cuda"):
        self.outer_curve = outer_curve
        self.device = device
        self._model_obj = None

    def _model(self):
        if self._model_obj is None:
            from ..models import mnt4753, mnt6753

            mod = mnt4753 if self.outer_curve == "MNT4753" else mnt6753
            self._model_obj = mod.get(self.device)
        return self._model_obj

    def keygen(self, predicates, rng, arity: int = 0, set_depth: int = 1,
               profiler: Profiler | None = None) -> MPPCDKeypair:
        """``groth16_full``'s generator over every predicate's step circuit
        in turn (its draws from ``rng``), then the commitment to the
        resulting vk set (r1cs_mp_ppzkpcd.tcc keygen)."""
        model = self._model()
        prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
        hc = host_curve(partner(self.outer_curve))
        circuits, pks, vks = [], [], []
        for pred in predicates:
            prof.enter_block("mp step circuit")
            with collector_paused():
                circ = MPPCDStepCircuit(self.outer_curve, pred, set_depth=set_depth, arity=arity)
                cs = circ.pb.get_constraint_system()
            prof.leave_block("mp step circuit")
            pk, secrets = g16.proving_key(model, cs, rng, prof)
            circuits.append(circ)
            pks.append(pk)
            vks.append(g16.verification_key(pk, secrets))
        num_inputs = max(1 + p.incoming_message_payload_lengths[0] for p in predicates)
        commitment, leaves = vk_set_commitment(hc, vks, num_inputs)
        return MPPCDKeypair(pks=pks, vks=vks, predicates=list(predicates), commitment=commitment,
                            leaves=leaves, circuits=circuits)

    def prove(self, kp: MPPCDKeypair, which: int, outgoing, incoming, local_data, witness, rng,
              inner=None, profiler: Profiler | None = None):
        """Fill predicate ``which``'s step circuit, then ``groth16_full.prover``
        (r, s from ``rng``).  Raises ValueError where the step is not
        compliant or a predecessor does not verify or authenticate."""
        model = self._model()
        prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
        circ = kp.circuits[which]
        prof.enter_block("mp fill")
        ok = circ.fill(outgoing, incoming, local_data, witness, kp.commitment, inner)
        prof.leave_block("mp fill")
        if not ok:
            raise ValueError("mp step circuit unsatisfied")
        return g16.prover(model, kp.pks[which], circ.pb.primary_input(),
                          circ.pb.auxiliary_input(), rng, profiler=prof)

    def verify(self, kp: MPPCDKeypair, which: int, outgoing: R1CSPCDMessage, proof,
               num_incoming: int) -> bool:
        """``groth16_full.verifier_strong_IC`` under predicate ``which``'s key
        on the statement its step circuit makes public: the outgoing message
        and the arity wire after it, which holds the number of incoming
        messages of the proved step (the module's docstring)."""
        pred = kp.predicates[which]
        primary = outgoing.as_assignment()[: pred.constraint_system.primary_input_size]
        return g16.verifier_strong_IC(kp.vks[which], primary + [num_incoming], proof)
