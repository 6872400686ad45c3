"""USCS, unitary-square constraint systems, on the host.

Counterpart of the JAX package's ``relations/uscs.py`` (libsnark
relations/constraint_satisfaction_problems/uscs/uscs.{hpp,tcc}): each
constraint is one linear combination <terms, (1, w)>, satisfied when it
evaluates to +1 or -1.  Values are exact Python ints mod p; proving goes
through ``reductions.uscs_to_ssp``.
"""

from __future__ import annotations

from .r1cs import LinearCombination


class USCSConstraintSystem:
    """uscs_constraint_system (uscs.hpp:86-141): the constraints and the
    primary/auxiliary split, variable 0 the constant ONE."""

    def __init__(self, p: int, primary_input_size: int = 0, auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.constraints: list[LinearCombination] = []

    @property
    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def add_constraint(self, lc: LinearCombination):
        self.constraints.append(lc)

    def is_valid(self) -> bool:
        n = self.num_variables
        return self.primary_input_size <= n and all(c.is_valid(n) for c in self.constraints)

    def is_satisfied(self, primary, auxiliary) -> bool:
        """Every constraint evaluates to +1 or -1 (uscs.tcc is_satisfied)."""
        assignment = list(primary) + list(auxiliary)
        p = self.p
        for lc in self.constraints:
            v = lc.evaluate(assignment, p)
            if v != 1 and v != p - 1:
                return False
        return True
