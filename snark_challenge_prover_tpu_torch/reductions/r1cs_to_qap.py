"""R1CS -> QAP reduction, the key generator's side, on the host.

Counterpart of the JAX package's ``reductions/r1cs_to_qap.py``
(libsnark r1cs_to_qap.tcc):

  * ``instance_map_with_evaluation`` (tcc:105-177): every QAP polynomial
    A_i, B_i, C_i evaluated at the secret point t through the domain's
    Lagrange basis, and Z(t), as exact integers;
  * ``assemble_abc_evaluations`` (tcc:225-238 and the aC loop at
    :286-291): the evaluations of A, B and C on the domain for an
    assignment, which the challenge's input file carries.

The domain is the one the prover takes, ``get_domain_of_min_size`` of
num_constraints + num_inputs + 1 points (tcc:119).  The prover's own
``witness_map`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.fft import get_domain_of_min_size
from ..relations.r1cs import R1CSConstraintSystem


def qap_domain_size(cs: R1CSConstraintSystem, F) -> int:
    """The QAP's domain size: that of F's smallest domain holding
    num_constraints + num_inputs + 1 points."""
    return get_domain_of_min_size(F, cs.num_constraints + cs.primary_input_size + 1).n


@dataclass
class QAPInstanceEvaluation:
    """qap_instance_evaluation (qap.hpp): what the Groth16 generator needs,
    as exact host integers."""

    domain_size: int
    num_variables: int
    num_inputs: int
    t: int
    At: list  # num_variables + 1 entries
    Bt: list
    Ct: list
    Zt: int


def instance_map_with_evaluation(cs: R1CSConstraintSystem, t: int, F) -> QAPInstanceEvaluation:
    """r1cs_to_qap_instance_map_with_evaluation (tcc:105-177).  Sums are
    reduced once at the end, which gives the same residues.  The powers of
    t (the JAX package's ``Ht``) are left to the caller, which makes them
    where it needs them (the generator on the device, ``ops.fft.power_table``)."""
    p = cs.p
    domain = get_domain_of_min_size(F, cs.num_constraints + cs.primary_input_size + 1)
    n = domain.n
    nvar = cs.num_variables
    At = [0] * (nvar + 1)
    Bt = [0] * (nvar + 1)
    Ct = [0] * (nvar + 1)
    Zt = domain.compute_vanishing_polynomial(t)
    u = domain.evaluate_all_lagrange_polynomials(t)

    # input consistency rows: A_i gains the basis at row n_c + i, i <= num_inputs
    for i in range(cs.primary_input_size + 1):
        At[i] = u[cs.num_constraints + i]
    for ui, cons in zip(u, cs.constraints):
        for idx, coeff in cons.a.terms:
            At[idx] += ui * coeff
        for idx, coeff in cons.b.terms:
            Bt[idx] += ui * coeff
        for idx, coeff in cons.c.terms:
            Ct[idx] += ui * coeff
    return QAPInstanceEvaluation(
        domain_size=n, num_variables=nvar, num_inputs=cs.primary_input_size, t=t,
        At=[v % p for v in At], Bt=[v % p for v in Bt], Ct=[v % p for v in Ct], Zt=Zt)


def assemble_abc_evaluations(cs: R1CSConstraintSystem, primary, auxiliary, F):
    """(aA, aB, aC), each of qap_domain_size(cs, F) host integers: row i
    of the constraints' A, B and C on the assignment, and the input
    consistency rows aA[n_c + i] = w_i (w_0 = 1)."""
    p = cs.p
    n = qap_domain_size(cs, F)
    assignment = list(primary) + list(auxiliary)
    aA, aB, aC = [0] * n, [0] * n, [0] * n
    for i in range(cs.primary_input_size + 1):
        aA[i + cs.num_constraints] = 1 if i == 0 else assignment[i - 1] % p
    for i, cons in enumerate(cs.constraints):
        aA[i] = (aA[i] + cons.a.evaluate(assignment, p)) % p
        aB[i] = cons.b.evaluate(assignment, p)
        aC[i] = cons.c.evaluate(assignment, p)
    return aA, aB, aC
