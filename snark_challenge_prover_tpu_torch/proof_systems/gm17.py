"""GM17, the simulation-extractable SNARK (r1cs_se_ppzksnark): key
generator, blinded prover, verifiers.

Counterpart of the JAX package's ``proof_systems/gm17.py`` (libsnark
r1cs_se_ppzksnark.{hpp,tcc}).

The generator (tcc:230-448) evaluates the SAP at a random t with Z(t) != 0
(``reductions.r1cs_to_sap``, host), draws alpha, beta, gamma and the bases
G = g G1 and H = h G2 (wNAF on the model's device), and builds

    vk = (H, G^alpha, H^beta, G^gamma, H^gamma,
          query_i = G^(gamma C_i(t) + (alpha + beta) A_i(t)), i <= num_inputs)
    pk = (A_query_i = G^(gamma A_i(t)), B_query_i = H^(gamma A_i(t)),
          C_query_1_i = G^(gamma query-exponent_i), i > num_inputs,
          C_query_2_i = G^(2 gamma^2 Z(t) A_i(t)),
          G_gamma_Z, H_gamma_Z, G_ab_gamma_Z, G_gamma2_Z2,
          G_gamma2_Z_t_i = G^(gamma^2 Z(t) t^i), i <= n)

by fixed-base exponentiation (``ops.fixed_base``): the five G1 families
through one window table on G and one ``batch_exp_with_coeff``, their
scalars made on the device from A(t) and C(t) (t^i by
``ops.fft.power_table``); B through a table on H^gamma.

The prover (tcc:449-578): the SAP witness map on the device, four G1 MSMs
(A_query[1:] and C_query_2[1:] over the assignment, C_query_1 over its
auxiliary part, G_gamma2_Z_t over H) as one staged multi-MSM, the G2 MSM,
and the blinding by d1, d2, r on the host's exact integers:

    A = G^(gamma (A(t) + (r + d1) Z(t)))      B = H^(same)
    C = G^(sum_{i > l} w_i gamma query-exponent_i + (r^2 + 2 r d1) gamma^2 Z^2
           + (r + d1) (alpha + beta) gamma Z + 2 r gamma^2 Z A(t)
           + gamma^2 Z (H(t) + d2)).

The verifiers (tcc:580-738) run the two pairing checks on the host
(``AtePairing``):

    e(A G^alpha, B H^beta) = e(G^alpha, H^beta) e(psi, H^gamma) e(C, H),
    e(A, H^gamma) = e(G^gamma, B),

psi the inputs accumulated over the query.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..host.curves import host_curve
from ..ops import fixed_base, msm as msm_mod
from ..ops.fft import get_domain_of_min_size, power_table
from ..ops.field import canonical_words
from ..reductions import r1cs_to_sap as sap
from ..relations.r1cs import R1CSConstraintSystem
from ..utils.profiling import Profiler
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host, _g2_proj_to_host, query_point
from .groth16_full import _wire_affine


@dataclass
class ProvingKey:
    """r1cs_se_ppzksnark_proving_key (hpp:77-172): each query as affine
    (x, y) Montgomery word tensors on the model's device, the identity as
    y = 0; the single points as host affine integers."""

    curve: str
    A_query: tuple       # (x, y), each (24, m + 1)
    B_query: tuple       # (x, y), each (deg, 24, m + 1)
    C_query_1: tuple     # (24, m - num_inputs)
    C_query_2: tuple     # (24, m + 1)
    G_gamma_Z: tuple
    H_gamma_Z: tuple
    G_ab_gamma_Z: tuple
    G_gamma2_Z2: tuple
    G_gamma2_Z_t: tuple  # (24, n + 1)
    constraint_system: R1CSConstraintSystem


@dataclass
class VerificationKey:
    """r1cs_se_ppzksnark_verification_key (hpp:174-251), host affine."""

    curve: str
    H: tuple
    G_alpha: tuple
    H_beta: tuple
    G_gamma: tuple
    H_gamma: tuple
    query: list  # num_inputs + 1 G1 points


@dataclass
class Proof:
    """pi = (A in G1, B in G2, C in G1) as host affine integers (hpp:253-312)."""

    A: tuple
    B: tuple
    C: tuple


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def generator(model, cs: R1CSConstraintSystem, rng, profiler: Profiler | None = None) -> Keypair:
    """r1cs_se_ppzksnark_generator (tcc:230-448), drawing from ``rng`` in the
    JAX package's order: t until Z(t) != 0, then alpha, beta, gamma and the
    scalars of G and H.  Phases: "sap instance map", "gm17 scalars",
    "gm17 bases", "gm17 G window table", "gm17 H_gamma window table",
    "gm17 G1 queries (fused)", "gm17 B query (G2)", "gm17 singles"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    hc = host_curve(model.name)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    r_p = Fr.p

    prof.enter_block("sap instance map")
    domain = get_domain_of_min_size(Fr, sap.sap_min_size(cs))
    t = rng.randrange(1, r_p)
    while not domain.compute_vanishing_polynomial(t):  # tcc:236-244
        t = rng.randrange(1, r_p)
    inst = sap.instance_map_with_evaluation(cs, t, Fr)
    prof.leave_block("sap instance map")
    m, n, l = inst.num_variables, inst.domain_size, inst.num_inputs
    alpha, beta, gamma, g_scalar, h_scalar = (rng.randrange(1, r_p) for _ in range(5))
    ab = (alpha + beta) % r_p
    g2z = gamma * gamma % r_p * inst.Zt % r_p

    prof.enter_block("gm17 scalars")
    At_c = canonical_words(Fr, inst.At)
    At_m = Fr.from_canonical(At_c)
    vq = Fr.add(Fr.mul_const(Fr.from_canonical(canonical_words(Fr, inst.Ct)), Fr.const(gamma)),
                Fr.mul_const(At_m, Fr.const(ab)))
    # one table and one batch_exp for the verifier's query, A, C1, C2 and
    # G_gamma2_Z_t (tcc:283-289), each family by its coefficient
    g1_scalars = torch.cat([vq[:, : l + 1], At_m, vq[:, l + 1 :], At_m, power_table(Fr, t, n + 1)],
                           dim=1)
    coeffs = [1, gamma, gamma, 2 * g2z % r_p, g2z]
    counts = [l + 1, m + 1, m - l, m + 1, n + 1]
    g1_coeffs = torch.cat([Fr.const(c).unsqueeze(1).expand(-1, k) for c, k in zip(coeffs, counts)],
                          dim=1)
    del vq, At_m
    prof.leave_block("gm17 scalars")

    prof.enter_block("gm17 bases")
    G_base = fixed_base.opt_window_wnaf_exp(G1, model.g1_generator(), g_scalar)
    H_base = fixed_base.opt_window_wnaf_exp(G2, model.g2_generator(), h_scalar)
    H_gamma_base = fixed_base.opt_window_wnaf_exp(G2, H_base, gamma)
    prof.leave_block("gm17 bases")
    w1 = fixed_base.get_exp_window_size(g1_scalars.shape[1])
    w2 = fixed_base.get_exp_window_size(m + 1)
    prof.enter_block("gm17 G window table")
    t1 = fixed_base.get_window_table(G1, w1, G_base)
    prof.leave_block("gm17 G window table")
    prof.enter_block("gm17 H_gamma window table")
    t2 = fixed_base.get_window_table(G2, w2, H_gamma_base)
    prof.leave_block("gm17 H_gamma window table")

    prof.enter_block("gm17 G1 queries (fused)")
    x, y = _wire_affine(G1, fixed_base.batch_exp_with_coeff(G1, w1, t1, g1_coeffs, g1_scalars, Fr))
    del g1_scalars, g1_coeffs, t1
    ends = [0]
    for k in counts:
        ends.append(ends[-1] + k)
    vq_q, A_q, C1_q, C2_q, Zt_q = ((x[:, a:b], y[:, a:b]) for a, b in zip(ends, ends[1:]))
    prof.leave_block("gm17 G1 queries (fused)")
    prof.enter_block("gm17 B query (G2)")
    B_q = _wire_affine(G2, fixed_base.batch_exp(G2, w2, t2, At_c))
    del At_c, t2
    prof.leave_block("gm17 B query (G2)")

    prof.enter_block("gm17 singles")
    Gh, Hh = _g1_proj_to_host(model, G_base), _g2_proj_to_host(model, H_base)
    gz = inst.Zt * gamma % r_p
    pk = ProvingKey(curve=model.name, A_query=A_q, B_query=B_q, C_query_1=C1_q, C_query_2=C2_q,
                    G_gamma_Z=hc.g1.mul(gz, Gh), H_gamma_Z=hc.g2.mul(gz, Hh),
                    G_ab_gamma_Z=hc.g1.mul(ab * gz % r_p, Gh),
                    G_gamma2_Z2=hc.g1.mul(g2z * inst.Zt % r_p, Gh), G_gamma2_Z_t=Zt_q,
                    constraint_system=cs)
    vk = VerificationKey(curve=model.name, H=Hh, G_alpha=hc.g1.mul(alpha, Gh),
                         H_beta=hc.g2.mul(beta, Hh), G_gamma=hc.g1.mul(gamma, Gh),
                         H_gamma=hc.g2.mul(gamma, Hh),
                         query=[query_point(model, vq_q, i) for i in range(l + 1)])
    prof.leave_block("gm17 singles")
    return Keypair(pk, vk)


def prover(model, pk: ProvingKey, primary, auxiliary, rng,
           profiler: Profiler | None = None) -> Proof:
    """r1cs_se_ppzksnark_prover (tcc:449-578), drawing d1, d2, r from ``rng``
    (each ``rng.randrange(r)``), as the JAX package does.  An assignment that
    does not satisfy the key's constraints raises ValueError.  Phases:
    "sap witness map", "gm17 G1 multiexps", "gm17 G2 multiexp",
    "gm17 assemble proof (host)"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    cs = pk.constraint_system
    r_p = Fr.p
    if not cs.is_satisfied(primary, auxiliary):
        raise ValueError("the assignment does not satisfy the constraint system")
    d1, d2, r = (rng.randrange(r_p) for _ in range(3))

    prof.enter_block("sap witness map")
    wit = sap.witness_map(model, cs, primary, auxiliary, d1, d2)
    l = wit.num_inputs
    w_can = canonical_words(Fr, wit.full_assignment)  # variables 1..m
    h_can = Fr.to_canonical(wit.H)
    del wit
    prof.leave_block("sap witness map")

    prof.enter_block("gm17 G1 multiexps")
    tail = lambda pair: G1.from_affine(*(c[:, 1:] for c in pair))
    pts, scal = msm_mod.pad_and_stack(
        G1, [tail(pk.A_query), G1.from_affine(*pk.C_query_1), tail(pk.C_query_2),
             G1.from_affine(*pk.G_gamma2_Z_t)],
        [w_can, w_can[:, l:], w_can, h_can])
    del h_can
    res4 = msm_mod.msm_multi_staged(G1, pts, scal)
    del pts, scal
    prof.leave_block("gm17 G1 multiexps")
    prof.enter_block("gm17 G2 multiexp")
    res2 = msm_mod.msm_staged(G2, G2.from_affine(*(c[..., 1:] for c in pk.B_query)), w_can)
    prof.leave_block("gm17 G2 multiexp")

    prof.enter_block("gm17 assemble proof (host)")
    hc = host_curve(model.name)
    g1, g2 = hc.g1, hc.g2
    A_msm, C1_msm, C2_msm, H_msm = (_g1_proj_to_host(model, tuple(c[..., i] for c in res4))
                                    for i in range(4))
    B_msm = _g2_proj_to_host(model, res2)
    rd1 = (r + d1) % r_p
    # tcc:487-505, then C in the order of tcc:525-566
    A = g1.add(g1.add(g1.mul(rd1, pk.G_gamma_Z), query_point(model, pk.A_query, 0)), A_msm)
    B = g2.add(g2.add(g2.mul(rd1, pk.H_gamma_Z), query_point(model, pk.B_query, 0)), B_msm)
    C = C1_msm
    for k, P in ((r * r % r_p, pk.G_gamma2_Z2), (rd1, pk.G_ab_gamma_Z),
                 (r, query_point(model, pk.C_query_2, 0)), (2 * r * d1 % r_p, pk.G_gamma2_Z2),
                 (r, C2_msm), (d2, query_point(model, pk.G_gamma2_Z_t, 0))):
        C = g1.add(C, g1.mul(k, P))
    C = g1.add(C, H_msm)
    prof.leave_block("gm17 assemble proof (host)")
    return Proof(A=A, B=B, C=C)


# ---------------------------------------------------------------------------
# verifiers
# ---------------------------------------------------------------------------

def verifier_process_vk(vk: VerificationKey) -> VerificationKey:
    """The host pairing precomputes nothing across proofs: the key itself."""
    return vk


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """tcc:598-688: the proof's points on the curve, the inputs accumulated
    over the query (more inputs than the key has raise ValueError), and the
    two pairing checks."""
    hc = host_curve(vk.curve)
    if len(primary) > len(vk.query) - 1:
        raise ValueError(f"{len(primary)} inputs, the key has {len(vk.query) - 1}")
    for P, group in ((proof.A, hc.g1), (proof.B, hc.g2), (proof.C, hc.g1)):
        if not group.is_on_curve(P):
            return False
    psi = vk.query[0]
    for v, Q in zip(primary, vk.query[1:]):
        psi = hc.g1.add(psi, hc.g1.mul(v % hc.fr_spec.p, Q))
    engine = AtePairing(hc)
    gt, e = engine.GT, engine.reduced_pairing
    lhs = e(hc.g1.add(proof.A, vk.G_alpha), hc.g2.add(proof.B, vk.H_beta))
    rhs = gt.mul(e(vk.G_alpha, vk.H_beta), gt.mul(e(psi, vk.H_gamma), e(proof.C, vk.H)))
    if lhs != rhs:
        return False
    return e(proof.A, vk.H_gamma) == e(vk.G_gamma, proof.B)


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """The weak check with exactly as many inputs as the key."""
    if len(vk.query) != len(primary) + 1:
        return False
    return online_verifier_weak_IC(vk, primary, proof)


def verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_weak_IC(verifier_process_vk(vk), primary, proof)


def verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_strong_IC(verifier_process_vk(vk), primary, proof)
