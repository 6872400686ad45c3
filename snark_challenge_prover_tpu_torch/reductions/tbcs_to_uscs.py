"""TBCS -> USCS reduction, on the host.

Counterpart of the JAX package's ``reductions/tbcs_to_uscs.py`` (libsnark
reductions/tbcs_to_uscs/tbcs_to_uscs.tcc): each gate becomes one USCS
constraint over {x, y, z, 1} that lands in {-1, +1} exactly when
z = type(x, y) on boolean wires (the coefficient table of tcc:50-135),
then one booleanity constraint 2 w - 1 a variable and one constraint
w + 1 a circuit output, which with w boolean forces w = 0.

The booleanity loop is the reference's as it stands (tcc:138-142): it
constrains variables 0 .. num_wires - 1, the constant ONE and every wire
but the last, so a circuit of G gates, I inputs and O outputs gives
2 G + I + O constraints over I + G variables.
"""

from __future__ import annotations

from ..relations.r1cs import LinearCombination
from ..relations.tbcs import TBCSCircuit
from ..relations.uscs import USCSConstraintSystem

# (cx, cy, cz, c1) by gate opcode, tbcs_to_uscs.tcc:50-135
_GATE_LC = {
    0: (0, 0, 1, 1),      # CONSTANT_0
    1: (-2, -2, 4, 1),    # AND
    2: (-2, 2, 4, -1),    # X_AND_NOT_Y
    3: (-1, 0, 1, 1),     # X
    4: (2, -2, 4, -1),    # NOT_X_AND_Y
    5: (0, 1, 1, -1),     # Y
    6: (1, 1, 1, -1),     # XOR
    7: (-2, -2, 4, -1),   # OR
    8: (2, 2, 4, -3),     # NOR
    9: (1, 1, 1, -2),     # EQUIVALENCE
    10: (0, -1, 1, 0),    # NOT_Y
    11: (-2, 2, 4, -3),   # IF_Y_THEN_X
    12: (-1, 0, 1, 0),    # NOT_X
    13: (2, -2, 4, -3),   # IF_X_THEN_Y
    14: (2, 2, 4, -5),    # NAND
    15: (0, 0, 1, 0),     # CONSTANT_1
}


def instance_map(circuit: TBCSCircuit, p: int) -> USCSConstraintSystem:
    """tbcs_to_uscs_instance_map (tcc:22-150): the gates' constraints, the
    booleanity constraints, the outputs'; an invalid circuit raises
    ValueError."""
    if not circuit.is_valid():
        raise ValueError("the circuit's gates do not assign the wires in order from earlier wires")
    cs = USCSConstraintSystem(p, primary_input_size=circuit.primary_input_size,
                              auxiliary_input_size=circuit.auxiliary_input_size + circuit.num_gates)
    for g in circuit.gates:
        cx, cy, cz, c1 = _GATE_LC[g.type]
        terms = [(idx, c) for idx, c in ((g.left_wire, cx), (g.right_wire, cy), (g.output, cz),
                                         (0, c1)) if c]
        cs.add_constraint(LinearCombination(terms))
    for i in range(circuit.num_wires):  # variables 0 .. num_wires - 1, as the reference
        cs.add_constraint(LinearCombination([(i, 2), (0, -1)]))
    for g in circuit.gates:
        if g.is_circuit_output:
            cs.add_constraint(LinearCombination([(g.output, 1), (0, 1)]))
    return cs


def witness_map(circuit: TBCSCircuit, primary, auxiliary) -> list:
    """tbcs_to_uscs_witness_map (tcc:152-160): every wire as 0 or 1."""
    return [1 if b else 0 for b in circuit.get_all_wires(primary, auxiliary)]
