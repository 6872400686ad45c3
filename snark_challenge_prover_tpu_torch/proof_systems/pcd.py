"""Proof-carrying data over the MNT cycle (r1cs_sp_ppzkpcd structure).

Counterpart of the JAX package's ``proof_systems/pcd.py`` (libsnark
r1cs_pcd: compliance_predicate.hpp and sp_pcd_circuits.{hpp,tcc}):

  * ``R1CSPCDMessage`` / ``R1CSPCDLocalData`` / ``CompliancePredicate``:
    a predicate is an R1CS over wires
      [outgoing message | arity | incoming messages | local data]
    accepting iff the local invariant holds;
  * ``PCDStepCircuit``: the predicate's constraints replicated over
    protoboard wires, with one in-circuit Groth16 verifier per incoming
    message (``gadgets/verifier_gadget.Groth16VerifierGadget``) whose
    public inputs are bound to that message's wires.  The step circuit
    lives over the outer curve's Fr, which is the inner (partner) curve's
    Fq, so the partner's proofs verify natively;
  * ``SPPCDProver``: key generation, proving and verification of the step
    circuit through ``proof_systems/groth16_full`` on the outer curve's
    model, on the card unless the caller asks for the CPU.  The circuit is
    built and filled on the host ("pcd step circuit", "pcd fill"); the
    generator's and the prover's own blocks follow.  Base-case proofs
    (arity 0) carry no verifier gadget.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gadgets.protoboard import Protoboard, collector_paused
from ..gadgets.verifier_gadget import Groth16VerifierGadget
from ..host.curves import host_curve
from ..relations.r1cs import (
    LinearCombination as LC,
    R1CSConstraint,
    R1CSConstraintSystem,
)
from ..utils.profiling import Profiler
from . import groth16_full as g16


@dataclass
class R1CSPCDMessage:
    """r1cs_pcd_message: a typed payload of field elements."""

    type: int
    payload: list

    def as_assignment(self):
        return [self.type] + list(self.payload)


@dataclass
class R1CSPCDLocalData:
    payload: list

    def as_assignment(self):
        return list(self.payload)


@dataclass
class CompliancePredicate:
    """compliance_predicate<FieldT> (compliance_predicate.hpp:77-120):
    an R1CS over [1 | outgoing | arity | incoming... | local data]."""

    name: int
    type: int
    constraint_system: R1CSConstraintSystem
    outgoing_message_payload_length: int
    max_arity: int
    incoming_message_payload_lengths: list
    local_data_length: int
    witness_length: int
    relies_on_same_type_inputs: bool = True

    def is_satisfied(self, outgoing: R1CSPCDMessage, incoming: list,
                     local_data: R1CSPCDLocalData, witness: list) -> bool:
        """compliance_predicate.tcc is_satisfied: evaluate the R1CS on
        the concatenated assignment."""
        assignment = outgoing.as_assignment()
        assignment.append(len(incoming))
        for msg in incoming:
            assignment += msg.as_assignment()
        assignment += local_data.as_assignment()
        assignment += list(witness)
        primary = assignment[: self.constraint_system.primary_input_size]
        auxiliary = assignment[self.constraint_system.primary_input_size:]
        return self.constraint_system.is_satisfied(primary, auxiliary)


class PCDStepCircuit:
    """The sp PCD step circuit over one curve of the cycle: predicate
    constraints + one verifier gadget per incoming message."""

    def __init__(self, outer_curve: str, predicate: CompliancePredicate,
                 inner_vk=None, arity: int = 0):
        # the step circuit lives over the OUTER curve's Fr, which equals
        # the INNER (partner) curve's Fq — partner proofs verify natively
        inner_curve = "MNT6753" if outer_curve == "MNT4753" else "MNT4753"
        self.inner_hc = host_curve(inner_curve)
        self.outer_curve = outer_curve
        self.predicate = predicate
        self.arity = arity
        pb = Protoboard(self.inner_hc.g2.F.p)
        self.pb = pb

        # wires mirroring the predicate's variable order
        n_pred_vars = predicate.constraint_system.num_variables
        self.pred_vars = [pb.allocate_var(f"pv{i}")
                          for i in range(n_pred_vars)]
        pb.set_input_sizes(predicate.constraint_system.primary_input_size)
        for cons in predicate.constraint_system.constraints:
            pb.add_r1cs_constraint(
                R1CSConstraint(cons.a, cons.b, cons.c), "predicate"
            )

        # one in-circuit verifier per incoming message (the predecessor
        # proof attests the incoming message was itself compliant); the
        # verifier's public-input wires are BOUND to the predicate's
        # incoming-message wires — the message the predicate reasons
        # about is exactly the statement the predecessor proof attests
        self.verifiers = []
        if arity > 0:
            if inner_vk is None:
                raise ValueError("recursion needs the inner vk")
            msg_base = (1 + predicate.outgoing_message_payload_length) + 1
            for k in range(arity):
                payload_len = predicate.incoming_message_payload_lengths[
                    min(k, len(predicate.incoming_message_payload_lengths) - 1)
                ]
                vg = Groth16VerifierGadget(
                    pb, self.inner_hc, inner_vk,
                    num_inputs=1 + payload_len,
                    annotation=f"pcdv{k}",
                )
                self.verifiers.append(vg)
                for j in range(1 + payload_len):
                    pred_wire = self.pred_vars[msg_base + j]
                    pb.add_r1cs_constraint(
                        R1CSConstraint(
                            LC.constant(1),
                            pred_wire.lc() - vg.inputs[j].lc(),
                            LC.constant(0),
                        ),
                        f"bind msg{k}.{j}",
                    )
                msg_base += 1 + payload_len

    def fill(self, outgoing, incoming, local_data, witness,
             inner_proofs=None):
        """Fill predicate wires + each verifier gadget from a real
        predecessor proof; satisfiable iff the step is compliant AND
        every predecessor proof verifies."""
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
        for k, vg in enumerate(self.verifiers):
            msg_inputs = incoming[k].as_assignment()
            vg.generate_r1cs_witness(msg_inputs, inner_proofs[k])
        return pb.is_satisfied()


@dataclass
class SPPCDKeypair:
    pk: object
    vk: object
    predicate: CompliancePredicate
    circuit: PCDStepCircuit = field(default=None, repr=False, compare=False)


class SPPCDProver:
    """r1cs_sp_ppzkpcd generator / prover / verifier on one outer curve.
    Base case (arity 0): the step circuit is the predicate alone.  The
    recursive case adds a verifier gadget per incoming edge (about 195 k
    constraints for an MNT4753 predecessor, 341 k for an MNT6753 one).
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

    def keygen(self, predicate: CompliancePredicate, rng, inner_vk=None, arity: int = 0,
               profiler: Profiler | None = None) -> SPPCDKeypair:
        """The step circuit, then ``groth16_full``'s generator on it (its
        draws from ``rng``: t, alpha, beta, delta, the G1 base's scalar)."""
        model = self._model()
        prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
        prof.enter_block("pcd step circuit")
        with collector_paused():
            circuit = PCDStepCircuit(self.outer_curve, predicate, inner_vk, arity)
            cs = circuit.pb.get_constraint_system()
        prof.leave_block("pcd step circuit")
        pk, secrets = g16.proving_key(model, cs, rng, prof)
        vk = g16.verification_key(pk, secrets)
        return SPPCDKeypair(pk=pk, vk=vk, predicate=predicate, circuit=circuit)

    def prove(self, kp: SPPCDKeypair, outgoing, incoming, local_data, witness, rng,
              inner_proofs=None, profiler: Profiler | None = None):
        """Fill the step circuit from the messages and the predecessor
        proofs, then ``groth16_full.prover`` (r, s from ``rng``).  Raises
        ValueError where the step is not compliant or a predecessor proof
        does not verify."""
        model = self._model()
        prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
        circuit = kp.circuit
        prof.enter_block("pcd fill")
        ok = circuit.fill(outgoing, incoming, local_data, witness, inner_proofs)
        prof.leave_block("pcd fill")
        if not ok:
            raise ValueError("step circuit unsatisfied")
        primary = circuit.pb.primary_input()
        auxiliary = circuit.pb.auxiliary_input()
        return g16.prover(model, kp.pk, primary, auxiliary, rng, profiler=prof)

    def verify(self, kp: SPPCDKeypair, outgoing: R1CSPCDMessage, proof) -> bool:
        primary = outgoing.as_assignment()[: kp.predicate.constraint_system.primary_input_size]
        return g16.verifier_strong_IC(kp.vk, primary, proof)
