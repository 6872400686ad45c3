"""USCS -> SSP (square span program) reduction.

Counterpart of the JAX package's ``reductions/uscs_to_ssp.py`` (libsnark
reductions/uscs_to_ssp/uscs_to_ssp.tcc):

  * ``instance_map_with_evaluation`` (tcc:57-101, the key generator's side,
    host): every V_i evaluated at the secret point t through the domain's
    Lagrange basis, V_0 gaining the basis at each dummy row 1^2 = 1 that
    pads the constraints to the domain, and Z(t), as exact integers;
  * ``assemble_v_evaluations`` (tcc:124-136, host): V on the domain for an
    assignment;
  * ``witness_map`` (tcc:104-192, the prover's side): those evaluations as
    words on the model's device, then ``witness_map_device``: the QAP's FFT
    dance with V squared and C = 1 (``r1cs_to_qap.quotient_coefficients``),
    H = (V^2 - 1) / Z, plus the zero-knowledge patch 2 d V + d^2 Z in
    coefficient form, giving the n + 1 coefficients of H.

The domain is ``get_domain_of_min_size`` of num_constraints points
(tcc:46-55).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.fft import get_domain_of_min_size, get_evaluation_domain, host_table
from ..ops.field import canonical_words
from ..relations.uscs import USCSConstraintSystem
from .r1cs_to_qap import add_host_coefficients, quotient_coefficients


def ssp_domain_size(cs: USCSConstraintSystem, F) -> int:
    """The SSP's domain size: that of F's smallest domain holding
    num_constraints points (at least one)."""
    return get_domain_of_min_size(F, max(1, cs.num_constraints)).n


@dataclass
class SSPInstanceEvaluation:
    """ssp_instance_evaluation (ssp.hpp): what the USCS generator needs, as
    exact host integers.  The powers of t (the JAX package's ``Ht``) are
    left to the caller, which makes them on the device
    (``ops.fft.power_table``)."""

    domain_size: int
    num_variables: int
    num_inputs: int
    t: int
    Vt: list  # num_variables + 1 entries
    Zt: int


def instance_map_with_evaluation(cs: USCSConstraintSystem, t: int, F) -> SSPInstanceEvaluation:
    """uscs_to_ssp_instance_map_with_evaluation (tcc:57-101).  Sums are
    reduced once at the end, which gives the same residues."""
    p = cs.p
    domain = get_domain_of_min_size(F, max(1, cs.num_constraints))
    Vt = [0] * (cs.num_variables + 1)
    Zt = domain.compute_vanishing_polynomial(t)
    u = domain.evaluate_all_lagrange_polynomials(t)
    for ui, lc in zip(u, cs.constraints):
        for idx, coeff in lc.terms:
            Vt[idx] += ui * coeff
    Vt[0] += sum(u[cs.num_constraints :])  # the dummy constraints 1^2 = 1
    return SSPInstanceEvaluation(domain_size=domain.n, num_variables=cs.num_variables,
                                 num_inputs=cs.primary_input_size, t=t,
                                 Vt=[v % p for v in Vt], Zt=Zt)


def assemble_v_evaluations(cs: USCSConstraintSystem, full, F) -> list:
    """V on the domain for the assignment ``full`` (primary then auxiliary,
    no constant): each constraint's value, then 1 at each dummy row
    (tcc:124-136), ssp_domain_size(cs, F) host integers."""
    p = cs.p
    aV = [lc.evaluate(full, p) for lc in cs.constraints]
    return aV + [1] * (ssp_domain_size(cs, F) - len(aV))


def witness_map_device(model, cv, d: int = 0):
    """V on the domain (Montgomery words (24, n) on the model's device) ->
    H's n + 1 coefficients (24, n + 1) (tcc:138-182): H = (V^2 - 1) / Z by
    the QAP's FFT dance with V squared and C = 1, plus, with d nonzero,
    2 d V + d^2 Z in coefficient form, Z the domain's own vanishing
    polynomial (``add_poly_Z``); the top coefficient is d^2 times Z's."""
    F = model.Fr
    p = F.p
    n = cv.shape[1]
    domain = get_evaluation_domain(F, n)
    H, V = quotient_coefficients(F, domain, cv, None, None, with_a=True)
    z = [0] * (n + 1)
    if d % p:
        domain.add_poly_Z(d * d % p, z)
        H = F.add(H, add_host_coefficients(F, F.mul_const(V, F.const(2 * d % p)), z))
    del V
    return torch.cat([H, host_table(F, [z[n]])], dim=1)


@dataclass
class SSPWitness:
    """ssp_witness (ssp.hpp): the assignment of variables 1..m and H's
    coefficients as Montgomery words (24, degree + 1) on the model's
    device."""

    num_variables: int
    degree: int
    num_inputs: int
    d: int
    full_assignment: list
    H: torch.Tensor


def witness_map(model, cs: USCSConstraintSystem, primary, auxiliary, d: int = 0) -> SSPWitness:
    """uscs_to_ssp_witness_map (tcc:104-192): V on the domain on the host as
    canonical integers, its Montgomery words on the device, then
    ``witness_map_device``."""
    F = model.Fr
    full = [v % cs.p for v in list(primary) + list(auxiliary)]
    aV = assemble_v_evaluations(cs, full, F)
    cv = F.from_canonical(canonical_words(F, aV))
    return SSPWitness(num_variables=cs.num_variables, degree=len(aV),
                      num_inputs=cs.primary_input_size, d=d, full_assignment=full,
                      H=witness_map_device(model, cv, d))
