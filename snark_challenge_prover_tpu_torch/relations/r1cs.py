"""R1CS constraint systems, on the host.

Counterpart of the JAX package's ``relations/r1cs.py`` (libsnark's
r1cs.hpp:52-141 and variable.hpp/tcc): linear combinations over Fr,
constraints <A,w> * <B,w> = <C,w>, the satisfiability check and the
generator's ``swap_AB_if_beneficial``.  Values are exact Python ints mod r.

Variable indexing follows libsnark: index 0 is the constant ONE, indices
1..num_inputs are the primary (public) inputs, the rest the auxiliary ones.
"""

from __future__ import annotations

from dataclasses import dataclass


class LinearCombination:
    """Sparse sum_j coeff_j * x_{index_j} (variable.hpp linear_combination)."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        # list of (var_index, coeff), coeff an int (reduced lazily)
        self.terms = list(terms) if terms else []

    @classmethod
    def of_var(cls, index: int, coeff: int = 1):
        return cls([(index, coeff)])

    @classmethod
    def constant(cls, value: int):
        """value * ONE; the empty combination for 0."""
        return cls([(0, value)]) if value else cls()

    def __add__(self, other: "LinearCombination"):
        return LinearCombination(self.terms + other.terms)

    def __mul__(self, scalar: int):
        return LinearCombination([(i, c * scalar) for i, c in self.terms])

    __rmul__ = __mul__

    def __sub__(self, other: "LinearCombination"):
        """self + (-1) other: the terms of both, the second's negated."""
        return self + (other * -1)

    def evaluate(self, assignment, p: int) -> int:
        """<self, (1, assignment...)> mod p."""
        acc = 0
        for idx, coeff in self.terms:
            acc += coeff * (1 if idx == 0 else assignment[idx - 1])
        return acc % p

    def collate(self, p: int) -> dict:
        """{index: coefficient mod p}, duplicate indices merged, zero
        coefficients dropped."""
        out: dict[int, int] = {}
        for idx, coeff in self.terms:
            out[idx] = (out.get(idx, 0) + coeff) % p
        return {i: c for i, c in out.items() if c}

    def is_valid(self, num_variables: int) -> bool:
        return all(0 <= i <= num_variables for i, _ in self.terms)


@dataclass
class R1CSConstraint:
    """<a,w> * <b,w> = <c,w> (r1cs.hpp:52); is_square marks a == b."""

    a: LinearCombination
    b: LinearCombination
    c: LinearCombination
    is_square: bool = False


class R1CSConstraintSystem:
    """Constraints and the primary/auxiliary split (r1cs.hpp:99-141)."""

    def __init__(self, p: int, primary_input_size: int = 0, auxiliary_input_size: int = 0):
        self.p = p
        self.primary_input_size = primary_input_size
        self.auxiliary_input_size = auxiliary_input_size
        self.constraints: list[R1CSConstraint] = []

    @property
    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_square_constraints(self) -> int:
        """Constraints flagged a == b (r1cs.hpp:119), which the R1CS -> SAP
        reduction keeps as one square constraint each."""
        return sum(1 for c in self.constraints if c.is_square)

    def add_constraint(self, c: R1CSConstraint):
        self.constraints.append(c)

    def is_valid(self) -> bool:
        n = self.num_variables
        return all(c.a.is_valid(n) and c.b.is_valid(n) and c.c.is_valid(n)
                   for c in self.constraints)

    def is_satisfied(self, primary, auxiliary) -> bool:
        """Every constraint holds on (primary ++ auxiliary) (r1cs.tcc)."""
        assignment = list(primary) + list(auxiliary)
        p = self.p
        for cons in self.constraints:
            a = cons.a.evaluate(assignment, p)
            b = cons.b.evaluate(assignment, p)
            if a * b % p != cons.c.evaluate(assignment, p):
                return False
        return True

    def swap_AB_if_beneficial(self) -> bool:
        """Swap every constraint's a and b when B touches more non-input
        variables than A: the B query is also built over G2, where group
        operations cost more (r1cs.tcc swap_AB_if_beneficial)."""
        touched_a: set[int] = set()
        touched_b: set[int] = set()
        for cons in self.constraints:
            touched_a.update(i for i, _ in cons.a.terms if i > self.primary_input_size)
            touched_b.update(i for i, _ in cons.b.terms if i > self.primary_input_size)
        if len(touched_b) > len(touched_a):
            for cons in self.constraints:
                cons.a, cons.b = cons.b, cons.a
            return True
        return False
