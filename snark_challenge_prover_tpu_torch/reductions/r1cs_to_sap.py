"""R1CS -> SAP (square arithmetic program) reduction, for GM17.

Counterpart of the JAX package's ``reductions/r1cs_to_sap.py`` (libsnark
r1cs_to_sap.tcc):

  * each non-square constraint <a,w> * <b,w> = <c,w> becomes two square
    constraints (tcc:75-135), with a fresh variable x':
        (<a,w> + <b,w>)^2 = 4 <c,w> + x'   and   (<a,w> - <b,w>)^2 = x';
    a constraint flagged ``is_square`` (a == b) stays one;
  * one more square constraint for the constant and two for each public
    input, which make the input polynomials linearly independent
    (tcc:137-180, [GM17] p.29): x_0^2 = x_0, and with a fresh x''_i,
    (x_i + x_0)^2 = 4 x_i + x''_i and (x_i - x_0)^2 = x''_i;
  * ``instance_map_with_evaluation`` (tcc:196-308, the key generator's
    side, host): A_i(t), C_i(t) and Z(t) as exact integers;
  * ``extended_assignment`` and ``assemble_ac_evaluations`` (tcc:357-418,
    464-505, host): the reduction's extra variables and the evaluations of
    A and C on the domain;
  * ``witness_map`` (tcc:310-551, the prover's side): those evaluations as
    words on the model's device, then ``witness_map_device``: the QAP's FFT
    dance with the pointwise square A A in place of A B, and the
    zero-knowledge patch 2 d1 A - d2 + d1^2 Z, giving the n + 1
    coefficients of H.

The domain is ``get_domain_of_min_size`` of 2 num_constraints -
num_square_constraints + 2 num_inputs + 1 points (tcc:37-52).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.fft import get_domain_of_min_size, get_evaluation_domain, host_table
from ..ops.field import canonical_words
from ..relations.r1cs import R1CSConstraintSystem
from .r1cs_to_qap import add_host_coefficients, quotient_coefficients


def sap_min_size(cs: R1CSConstraintSystem) -> int:
    """The points the SAP needs (r1cs_to_sap_get_domain, tcc:48-51)."""
    return 2 * cs.num_constraints - cs.num_square_constraints + 2 * cs.primary_input_size + 1


def sap_domain_size(cs: R1CSConstraintSystem, F) -> int:
    return get_domain_of_min_size(F, sap_min_size(cs)).n


def sap_num_variables(cs: R1CSConstraintSystem) -> int:
    """The R1CS variables, one x' a non-square constraint and one x'' a
    public input (tcc:66)."""
    return cs.num_variables + cs.num_constraints - cs.num_square_constraints + cs.primary_input_size


@dataclass
class SAPInstanceEvaluation:
    """sap_instance_evaluation (sap.hpp): what the GM17 generator needs, as
    exact host integers.  The powers of t (the JAX package's ``Ht``) are
    left to the caller, which makes them on the device
    (``ops.fft.power_table``)."""

    domain_size: int
    num_variables: int
    num_inputs: int
    t: int
    At: list  # num_variables + 1 entries
    Ct: list
    Zt: int


def instance_map_with_evaluation(cs: R1CSConstraintSystem, t: int, F) -> SAPInstanceEvaluation:
    """r1cs_to_sap_instance_map_with_evaluation (tcc:196-308).  Sums are
    reduced once at the end, which gives the same residues."""
    p = cs.p
    domain = get_domain_of_min_size(F, sap_min_size(cs))
    nvar = sap_num_variables(cs)
    At = [0] * (nvar + 1)
    Ct = [0] * (nvar + 1)
    Zt = domain.compute_vanishing_polynomial(t)
    u = domain.evaluate_all_lagrange_polynomials(t)

    extra = cs.num_variables + 1  # x' of the j-th non-square constraint: variable extra + j
    k = nonsq = 0  # the next SAP constraint, the non-square ones so far
    for cons in cs.constraints:
        if cons.is_square:
            for idx, coeff in cons.a.terms:
                At[idx] += u[k] * coeff
            for idx, coeff in cons.c.terms:
                Ct[idx] += u[k] * coeff
            k += 1
        else:
            plus, minus = u[k] + u[k + 1], u[k] - u[k + 1]
            for idx, coeff in cons.a.terms:
                At[idx] += plus * coeff
            for idx, coeff in cons.b.terms:
                At[idx] += minus * coeff
            for idx, coeff in cons.c.terms:
                Ct[idx] += 4 * u[k] * coeff
            Ct[extra + nonsq] += plus
            nonsq += 1
            k += 2

    # the input constraints (tcc:137-180): x'' of input i is variable ev2 + i
    ev2 = cs.num_variables + nonsq
    At[0] += u[k]
    Ct[0] += u[k]
    for i in range(1, cs.primary_input_size + 1):
        lo, hi = u[k + 2 * i - 1], u[k + 2 * i]
        At[i] += lo + hi
        At[0] += lo - hi
        Ct[i] += 4 * lo
        Ct[ev2 + i] += lo + hi
    return SAPInstanceEvaluation(domain_size=domain.n, num_variables=nvar,
                                 num_inputs=cs.primary_input_size, t=t,
                                 At=[v % p for v in At], Ct=[v % p for v in Ct], Zt=Zt)


def extended_assignment(cs: R1CSConstraintSystem, primary, auxiliary) -> list:
    """The assignment of the SAP's variables 1..m (tcc:357-390): primary
    and auxiliary, then x' = (<a,w> - <b,w>)^2 of each non-square
    constraint, then x'' = (x_i - 1)^2 of each input."""
    p = cs.p
    full = [v % p for v in list(primary) + list(auxiliary)]
    for cons in cs.constraints:
        if not cons.is_square:
            d = cons.a.evaluate(full, p) - cons.b.evaluate(full, p)
            full.append(d * d % p)
    for i in range(cs.primary_input_size):
        full.append((full[i] - 1) ** 2 % p)
    return full


def assemble_ac_evaluations(cs: R1CSConstraintSystem, full, F):
    """(aA, aC), each of sap_domain_size(cs, F) host integers: the SAP's A
    and C on the domain for the extended assignment ``full`` (0-based, no
    constant; tcc:392-418 aA and tcc:464-505 aC)."""
    p = cs.p
    n = sap_domain_size(cs, F)
    aA, aC = [0] * n, [0] * n
    extra = cs.num_variables  # x' of the j-th non-square constraint: full[extra + j]
    k = nonsq = 0
    for cons in cs.constraints:
        av, cv = cons.a.evaluate(full, p), cons.c.evaluate(full, p)
        if cons.is_square:
            aA[k], aC[k] = av, cv
            k += 1
        else:
            bv, x_extra = cons.b.evaluate(full, p), full[extra + nonsq]
            aA[k], aA[k + 1] = (av + bv) % p, (av - bv) % p
            aC[k], aC[k + 1] = (4 * cv + x_extra) % p, x_extra
            nonsq += 1
            k += 2
    ev2 = cs.num_variables + nonsq
    aA[k], aC[k] = 1, 1
    for i in range(1, cs.primary_input_size + 1):
        xi, xpp = full[i - 1], full[ev2 + i - 1]
        aA[k + 2 * i - 1], aA[k + 2 * i] = (xi + 1) % p, (xi - 1) % p
        aC[k + 2 * i - 1], aC[k + 2 * i] = (4 * xi + xpp) % p, xpp
    return aA, aC


def witness_map_device(model, ca, cc, d1: int = 0, d2: int = 0):
    """The evaluations of A and C on the domain (Montgomery words (24, n) on
    the model's device) -> H's n + 1 coefficients (24, n + 1): H = (A A -
    C) / Z by the QAP's FFT dance with A squared (``quotient_coefficients``,
    tcc:421-540), plus, with d1 or d2 nonzero, 2 d1 A - d2 + d1^2 Z in
    coefficient form (tcc:443-456), Z the domain's own vanishing polynomial
    (``add_poly_Z``); the top coefficient is d1^2 times Z's."""
    F = model.Fr
    p = F.p
    n = ca.shape[1]
    domain = get_evaluation_domain(F, n)
    H = quotient_coefficients(F, domain, ca, None, cc)
    z = [0] * (n + 1)
    if d1 % p or d2 % p:
        domain.add_poly_Z(d1 * d1 % p, z)
        z[0] = (z[0] - d2) % p
        A = F.mul_const(domain.ifft(ca), F.const(2 * d1 % p))
        H = F.add(H, add_host_coefficients(F, A, z))
    return torch.cat([H, host_table(F, [z[n]])], dim=1)


@dataclass
class SAPWitness:
    """sap_witness (sap.hpp): the extended assignment of variables 1..m and
    H's coefficients as Montgomery words (24, degree + 1) on the model's
    device."""

    num_variables: int
    degree: int
    num_inputs: int
    d1: int
    d2: int
    full_assignment: list
    H: torch.Tensor


def witness_map(model, cs: R1CSConstraintSystem, primary, auxiliary,
                d1: int = 0, d2: int = 0) -> SAPWitness:
    """r1cs_to_sap_witness_map (tcc:310-551): the extended assignment, A
    and C on the domain on the host as canonical integers, their Montgomery
    words on the device, then ``witness_map_device``."""
    F = model.Fr
    full = extended_assignment(cs, primary, auxiliary)
    aA, aC = assemble_ac_evaluations(cs, full, F)
    n = len(aA)
    words = F.from_canonical(canonical_words(F, aA + aC))
    del aA, aC
    ca, cc = words[:, :n].contiguous(), words[:, n:].contiguous()
    del words
    return SAPWitness(num_variables=sap_num_variables(cs), degree=n,
                      num_inputs=cs.primary_input_size, d1=d1, d2=d2, full_assignment=full,
                      H=witness_map_device(model, ca, cc, d1, d2))
