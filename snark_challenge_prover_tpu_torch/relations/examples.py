"""Synthetic satisfiable R1CS instances (libsnark r1cs_examples.tcc:25-160),
on the host.

Counterpart of the JAX package's ``relations/examples.py``, drawing from
the caller's PRNG in the same order and building the same constraints with
the same terms in the same order:

  * field input: a chain alternating (a + b) * 1 = c and a * b = c, closed
    by one squaring constraint over the sum of all variables;
  * binary input: XOR chains res = u + v - 2uv over random earlier bits.

The closing constraint's two sums are built as one list each, O(m); adding
one term at a time, as the JAX package does, copies the growing list m
times.
"""

from __future__ import annotations

from dataclasses import dataclass

from .r1cs import LinearCombination as LC, R1CSConstraint, R1CSConstraintSystem


@dataclass
class R1CSExample:
    constraint_system: R1CSConstraintSystem
    primary_input: list
    auxiliary_input: list


def _checked(cs: R1CSConstraintSystem, assignment: list, num_inputs: int) -> R1CSExample:
    primary, auxiliary = assignment[:num_inputs], assignment[num_inputs:]
    if cs.num_variables != len(assignment) or not cs.is_satisfied(primary, auxiliary):
        raise RuntimeError("the example's assignment does not satisfy its constraints")
    return R1CSExample(cs, primary, auxiliary)


def generate_r1cs_example_with_field_input(p: int, num_constraints: int, num_inputs: int,
                                           rng) -> R1CSExample:
    if num_inputs > num_constraints + 2:
        raise ValueError("more inputs than variables")
    cs = R1CSConstraintSystem(p, primary_input_size=num_inputs,
                              auxiliary_input_size=2 + num_constraints - num_inputs)
    a = rng.randrange(p)
    b = rng.randrange(p)
    assignment = [a, b]
    for i in range(num_constraints - 1):
        if i % 2:  # a * b = c
            A, B = LC.of_var(i + 1), LC.of_var(i + 2)
            tmp = a * b % p
        else:  # (a + b) * 1 = c
            A, B = LC([(i + 1, 1), (i + 2, 1)]), LC.of_var(0)
            tmp = (a + b) % p
        assignment.append(tmp)
        a, b = b, tmp
        cs.add_constraint(R1CSConstraint(A, B, LC.of_var(i + 3)))

    # closing constraint: (sum of all earlier variables)^2 = the last one
    earlier = range(1, cs.num_variables)
    fin = sum(assignment[i - 1] for i in earlier) % p
    cs.add_constraint(R1CSConstraint(LC([(i, 1) for i in earlier]), LC([(i, 1) for i in earlier]),
                                     LC.of_var(cs.num_variables)))
    assignment.append(fin * fin % p)
    return _checked(cs, assignment, num_inputs)


def generate_r1cs_example_with_binary_input(p: int, num_constraints: int, num_inputs: int,
                                            rng) -> R1CSExample:
    if num_inputs < 1:
        raise ValueError("the binary example needs at least one input")
    cs = R1CSConstraintSystem(p, primary_input_size=num_inputs,
                              auxiliary_input_size=num_constraints)
    assignment = [rng.randrange(2) for _ in range(num_inputs)]
    lastvar = num_inputs - 1
    for i in range(num_constraints):
        lastvar += 1
        u = rng.randrange(num_inputs) if i == 0 else rng.randrange(i)
        v = rng.randrange(num_inputs) if i == 0 else rng.randrange(i)
        # XOR: 2u * v = u + v - res
        C = LC.of_var(u + 1, 2) if u == v else LC([(u + 1, 1), (v + 1, 1)])
        cs.add_constraint(R1CSConstraint(LC.of_var(u + 1, 2), LC.of_var(v + 1, 1),
                                         C + LC.of_var(lastvar + 1, -1)))
        assignment.append((assignment[u] + assignment[v]
                           - 2 * assignment[u] * assignment[v]) % p)
    return _checked(cs, assignment, num_inputs)
