"""R1CS -> QAP reduction.

Counterpart of the JAX package's ``reductions/r1cs_to_qap.py``
(libsnark r1cs_to_qap.tcc):

  * ``instance_map_with_evaluation`` (tcc:105-177, the key generator's
    side, host): every QAP polynomial A_i, B_i, C_i evaluated at the
    secret point t through the domain's Lagrange basis, and Z(t), as
    exact integers;
  * ``assemble_abc_evaluations`` (tcc:225-238 and the aC loop at
    :286-291, host): the evaluations of A, B and C on the domain for an
    assignment, which the challenge's input file carries;
  * ``witness_map`` (tcc:206-340, the prover's side): those evaluations
    as words on the model's device, then ``witness_map_device``: the FFT
    dance iFFT -> cosetFFT -> pointwise -> divide by Z -> icosetFFT
    (``quotient_coefficients``, which the challenge prover's ``compute_h``
    shares) and the optional zero-knowledge patch d2 A + d1 B - d3 +
    d1 d2 Z, giving the n + 1 coefficients of H.

The domain is the one the prover takes, ``get_domain_of_min_size`` of
num_constraints + num_inputs + 1 points (tcc:119).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.fft import get_domain_of_min_size, get_evaluation_domain, host_table
from ..ops.field import canonical_words
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


def quotient_coefficients(F, domain, ca, cb, cc, with_a: bool = False):
    """The FFT dance (tcc:243-330, main.cpp:105-163): the evaluations of
    A, B and C on the domain, Montgomery words (24, n) -> the n
    coefficients of H = (A B - C) / Z, computed on the coset, where Z does
    not vanish.  ``cb`` None: B = A, H = (A^2 - C) / Z (the SAP's and the
    SSP's); ``cc`` None: C = 1, which is 1 on the coset too, so it takes no
    iFFT and coset FFT (the SSP's).  ``with_a``: (H, A's n coefficients),
    which the caller's zero-knowledge patch reuses."""
    a_coeffs = domain.ifft(ca)
    a = domain.coset_fft(a_coeffs)
    if not with_a:
        del a_coeffs
    hab = F.sqr(a) if cb is None else F.mul(a, domain.coset_fft(domain.ifft(cb)))
    del a
    h = F.sub(hab, F.ones(hab.shape[1:]) if cc is None else domain.coset_fft(domain.ifft(cc)))
    del hab
    H = domain.icoset_fft(domain.divide_by_z_on_coset(h))
    return (H, a_coeffs) if with_a else H


def witness_map_device(model, ca, cb, cc, d1: int = 0, d2: int = 0, d3: int = 0):
    """The evaluations of A, B and C on the domain (Montgomery words (24, n)
    on the model's device) -> H's n + 1 coefficients (24, n + 1), the top
    one zero unless the zero-knowledge patch adds d1 d2 there.  With any of
    d1, d2, d3 nonzero, H gains d2 A + d1 B - d3 + d1 d2 Z (coefficient
    form, tcc:298-330), Z the domain's own vanishing polynomial
    (``add_poly_Z``), so every domain kind gets its own, not x^n - 1."""
    F = model.Fr
    p = F.p
    n = ca.shape[1]
    domain = get_evaluation_domain(F, n)
    H = quotient_coefficients(F, domain, ca, cb, cc)
    z = [0] * (n + 1)
    if d1 % p or d2 % p or d3 % p:
        patch = F.add(F.mul_const(domain.ifft(ca), F.const(d2)),
                      F.mul_const(domain.ifft(cb), F.const(d1)))
        domain.add_poly_Z(d1 * d2 % p, z)
        z[0] = (z[0] - d3) % p
        H = F.add(H, add_host_coefficients(F, patch, z))
    return torch.cat([H, host_table(F, [z[n]])], dim=1)


def add_host_coefficients(F, coeffs: torch.Tensor, z: list) -> torch.Tensor:
    """Montgomery coefficients (24, n) plus the host integers z[:n] (a
    polynomial's, mostly zero), added where they are nonzero."""
    cols = [k for k in range(coeffs.shape[1]) if z[k]]
    if cols:
        idx = torch.tensor(cols, device=F.device)
        coeffs[:, idx] = F.add(coeffs[:, idx], host_table(F, [z[k] for k in cols]))
    return coeffs


def witness_map(model, cs: R1CSConstraintSystem, primary, auxiliary,
                d1: int = 0, d2: int = 0, d3: int = 0):
    """r1cs_to_qap_witness_map (tcc:206-340): (the full assignment,
    primary then auxiliary, and H's coefficients (24, n + 1) in Montgomery
    form on the model's device).  A, B and C on the domain are made on the
    host as canonical integers and turned into Montgomery words on the
    device."""
    F = model.Fr
    aA, aB, aC = assemble_abc_evaluations(cs, primary, auxiliary, F)
    n = len(aA)
    words = F.from_canonical(canonical_words(F, aA + aB + aC))
    ca, cb, cc = (words[:, k * n : (k + 1) * n].contiguous() for k in range(3))
    del words
    return list(primary) + list(auxiliary), witness_map_device(model, ca, cb, cc, d1, d2, d3)
