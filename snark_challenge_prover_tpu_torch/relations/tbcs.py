"""TBCS, two-input boolean circuit satisfiability, on the host.

Counterpart of the JAX package's ``relations/tbcs.py`` (libsnark
relations/circuit_satisfaction_problems/tbcs/tbcs.{hpp,cpp}): each gate
reads two earlier wires and has one of 16 types, whose opcode is its truth
table, read at position 3 - (2X + Y) (tbcs.cpp:24-37).  Wire 0 is the
constant TRUE; the inputs are wires 1..num_inputs and gate j assigns wire
num_inputs + j + 1.  A circuit is satisfied when every gate flagged
``is_circuit_output`` evaluates to false.  Proving goes through
``reductions.tbcs_to_uscs``.
"""

from __future__ import annotations

from dataclasses import dataclass

# the gate types (tbcs.hpp:55-72): the opcode is the 4-bit truth table
TBCS_GATE_CONSTANT_0 = 0
TBCS_GATE_AND = 1
TBCS_GATE_X_AND_NOT_Y = 2
TBCS_GATE_X = 3
TBCS_GATE_NOT_X_AND_Y = 4
TBCS_GATE_Y = 5
TBCS_GATE_XOR = 6
TBCS_GATE_OR = 7
TBCS_GATE_NOR = 8
TBCS_GATE_EQUIVALENCE = 9
TBCS_GATE_NOT_Y = 10
TBCS_GATE_IF_Y_THEN_X = 11
TBCS_GATE_NOT_X = 12
TBCS_GATE_IF_X_THEN_Y = 13
TBCS_GATE_NAND = 14
TBCS_GATE_CONSTANT_1 = 15


@dataclass
class TBCSGate:
    """tbcs_gate (tbcs.hpp:87-111): output = type(left, right)."""

    left_wire: int
    right_wire: int
    type: int
    output: int  # the wire the gate assigns
    is_circuit_output: bool = False

    def evaluate(self, wires) -> bool:
        """tbcs.cpp:24-37: wire 0 reads TRUE; bit 3 - (2X + Y) of the opcode."""
        X = True if self.left_wire == 0 else bool(wires[self.left_wire - 1])
        Y = True if self.right_wire == 0 else bool(wires[self.right_wire - 1])
        pos = 3 - ((2 if X else 0) + (1 if Y else 0))
        return bool(self.type & (1 << pos))


class TBCSCircuit:
    """tbcs_circuit (tbcs.hpp:133-180)."""

    def __init__(self, primary_input_size: int = 0, auxiliary_input_size: int = 0):
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.gates: list[TBCSGate] = []

    @property
    def num_inputs(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_gates(self) -> int:
        return len(self.gates)

    @property
    def num_wires(self) -> int:
        return self.num_inputs + self.num_gates

    def add_gate(self, g: TBCSGate):
        """Gates assign the wires in order (tbcs.cpp add_gate)."""
        if g.output != self.num_wires + 1:
            raise ValueError("gates must assign the wires in order")
        self.gates.append(g)

    def is_valid(self) -> bool:
        for i, g in enumerate(self.gates):
            n_before = self.num_inputs + i
            if g.output != n_before + 1:
                return False
            if g.left_wire > n_before or g.right_wire > n_before:
                return False
            if not 0 <= g.type < 16:
                return False
        return True

    def get_all_wires(self, primary, auxiliary) -> list:
        """The inputs as booleans, then every gate in order (tbcs.cpp:215-235)."""
        wires = [bool(v) for v in list(primary) + list(auxiliary)]
        for g in self.gates:
            wires.append(g.evaluate(wires))
        return wires

    def get_all_outputs(self, primary, auxiliary) -> list:
        wires = self.get_all_wires(primary, auxiliary)
        return [wires[g.output - 1] for g in self.gates if g.is_circuit_output]

    def is_satisfied(self, primary, auxiliary) -> bool:
        """Every circuit output is false (tbcs.cpp:252-264)."""
        return not any(self.get_all_outputs(primary, auxiliary))
