"""BACS, bilinear arithmetic circuit satisfiability, on the host.

Counterpart of the JAX package's ``relations/bacs.py`` (libsnark
relations/circuit_satisfaction_problems/bacs/bacs.{hpp,tcc}): a circuit is a
topologically ordered list of bilinear gates, each assigning the wire

    output = <lhs, wires> * <rhs, wires>

from wires already assigned (the inputs come first).  The circuit is
satisfied when every gate flagged ``is_circuit_output`` evaluates to 0.
Values are exact Python ints mod p; proving goes through
``reductions.bacs_to_r1cs``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .r1cs import LinearCombination


@dataclass
class BACSGate:
    """bacs_gate (bacs.hpp:55-77): out = <lhs, w> * <rhs, w>."""

    lhs: LinearCombination
    rhs: LinearCombination
    output: int  # the wire index the gate assigns
    is_circuit_output: bool = False

    def evaluate(self, assignment, p: int) -> int:
        return self.lhs.evaluate(assignment, p) * self.rhs.evaluate(assignment, p) % p


class BACSCircuit:
    """bacs_circuit (bacs.hpp:110-159)."""

    def __init__(self, p: int, primary_input_size: int = 0, auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.gates: list[BACSGate] = []

    @property
    def num_inputs(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_gates(self) -> int:
        return len(self.gates)

    @property
    def num_wires(self) -> int:
        return self.num_inputs + self.num_gates

    def add_gate(self, g: BACSGate):
        """Gates assign the wires in order (bacs.tcc add_gate)."""
        if g.output != self.num_wires + 1:
            raise ValueError("gates must be topologically ordered")
        self.gates.append(g)

    def is_valid(self) -> bool:
        for i, g in enumerate(self.gates):
            n_before = self.num_inputs + i
            if g.output != n_before + 1:
                return False
            if not (g.lhs.is_valid(n_before) and g.rhs.is_valid(n_before)):
                return False
        return True

    def get_all_wires(self, primary, auxiliary) -> list:
        """Every gate evaluated in order (bacs.tcc get_all_wires)."""
        p = self.p
        wires = [v % p for v in list(primary) + list(auxiliary)]
        for g in self.gates:
            wires.append(g.evaluate(wires, p))
        return wires

    def get_all_outputs(self, primary, auxiliary) -> list:
        wires = self.get_all_wires(primary, auxiliary)
        return [wires[g.output - 1] for g in self.gates if g.is_circuit_output]

    def is_satisfied(self, primary, auxiliary) -> bool:
        """Every circuit output is zero (bacs.tcc is_satisfied)."""
        return all(v == 0 for v in self.get_all_outputs(primary, auxiliary))
