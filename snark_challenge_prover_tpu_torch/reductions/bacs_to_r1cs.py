"""BACS -> R1CS reduction, on the host.

Counterpart of the JAX package's ``reductions/bacs_to_r1cs.py`` (libsnark
bacs_to_r1cs.tcc): one constraint <lhs, w> * <rhs, w> = out a gate, then
1 * out = 0 for each circuit output; the witness is the circuit's wires.
"""

from __future__ import annotations

from ..relations.bacs import BACSCircuit
from ..relations.r1cs import LinearCombination, R1CSConstraint, R1CSConstraintSystem


def instance_map(circuit: BACSCircuit) -> R1CSConstraintSystem:
    """bacs_to_r1cs_instance_map (tcc:23-62); an invalid circuit raises
    ValueError."""
    if not circuit.is_valid():
        raise ValueError("the circuit's gates are not topologically ordered over earlier wires")
    cs = R1CSConstraintSystem(circuit.p, primary_input_size=circuit.primary_input_size,
                              auxiliary_input_size=circuit.auxiliary_input_size + circuit.num_gates)
    for g in circuit.gates:
        cs.add_constraint(R1CSConstraint(g.lhs, g.rhs, LinearCombination.of_var(g.output)))
    for g in circuit.gates:
        if g.is_circuit_output:
            cs.add_constraint(R1CSConstraint(LinearCombination.constant(1),
                                             LinearCombination.of_var(g.output),
                                             LinearCombination()))
    return cs


def witness_map(circuit: BACSCircuit, primary, auxiliary) -> list:
    """bacs_to_r1cs_witness_map (tcc:64-72): every wire, in order."""
    return circuit.get_all_wires(primary, auxiliary)
