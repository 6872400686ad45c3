"""PGHR13 (r1cs_ppzksnark), the Pinocchio scheme with knowledge
commitments: key generator, blinded prover, verifiers.

Counterpart of the JAX package's ``proof_systems/pghr13.py`` (libsnark
r1cs_ppzksnark.{hpp,tcc}).

The generator (tcc:230-430) evaluates the QAP at a random t
(``reductions.r1cs_to_qap``, host) with Z(t) appended to A(t), B(t) and
C(t) as row m + 1 (tcc:290-293), draws alphaA, alphaB, alphaC, rA, rB,
beta, gamma (rC = rA rB), and builds on the curves' generators G and H

    A_query_i = (rA A_i G, rA alphaA A_i G)     B_query_i = (rB B_i H, rB alphaB B_i G)
    C_query_i = (rC C_i G, rC alphaC C_i G)     H_query_i = t^i G, i <= n
    K_query_i = beta (rA A_i + rB B_i + rC C_i) G, i <= m, then beta rA Z,
                beta rB Z, beta rC Z times G
    vk = (alphaA H, alphaB G, alphaC H, gamma H, gamma beta G, gamma beta H,
          rC Z(t) H, IC_i = rA A_i G for i <= num_inputs),

with the reference's two quirks kept: K skips row m + 1 (tcc:305-313), and
A's input rows are zeroed into the IC after K is formed (tcc:317-325).  The
seven G1 families and the IC go through one window table and one
``batch_exp_with_coeff``, their scalars made on the device; B's G2 half
through its own table.

The prover (tcc:430-545): the QAP witness map with the zero-knowledge shifts
d1, d2, d3 (``r1cs_to_qap.witness_map``), seven G1 MSMs over variables 1..m
and H (one staged multi-MSM), the G2 MSM, and the O(1) assembly on the
host's exact integers:

    g_A = A_query[0] + d1 A_query[m+1] + <A_query[1..m], w>  (g and h halves)
    g_B, g_C likewise with d2, d3
    g_H = <H_query, H>
    g_K = K_query[0] + d1 K[m+1] + d2 K[m+2] + d3 K[m+3] + <K_query[1..m], w>.

The verifiers (tcc:547-720) run five pairing checks on the host: the three
knowledge commitments, the QAP's divisibility and the same coefficients.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..host.curves import host_curve
from ..ops import fixed_base, msm as msm_mod
from ..ops.fft import host_table, power_table
from ..ops.field import canonical_words
from ..reductions import r1cs_to_qap as qap
from ..relations.r1cs import R1CSConstraintSystem
from ..utils.profiling import Profiler
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host, _g2_proj_to_host, query_point
# a projective batch -> the (x, y) a key stores, the identity as y = 0 (the JAX
# package's pghr13._np_pair, which the later proof systems import)
from .groth16_full import _wire_affine as _np_pair


@dataclass
class ProvingKey:
    """r1cs_ppzksnark_proving_key (hpp:77-177): each query as affine (x, y)
    Montgomery word tensors on the model's device, the identity as y = 0; a
    knowledge commitment as its g and h halves."""

    curve: str
    A_query_g: tuple   # (x, y), each (24, m + 2)
    A_query_h: tuple
    B_query_g: tuple   # G2: (x, y), each (deg, 24, m + 2)
    B_query_h: tuple   # G1
    C_query_g: tuple
    C_query_h: tuple
    H_query: tuple     # (24, n + 1)
    K_query: tuple     # (24, m + 4)
    constraint_system: R1CSConstraintSystem


@dataclass
class VerificationKey:
    """r1cs_ppzksnark_verification_key (hpp:179-272), host affine."""

    curve: str
    alphaA_g2: tuple
    alphaB_g1: tuple
    alphaC_g2: tuple
    gamma_g2: tuple
    gamma_beta_g1: tuple
    gamma_beta_g2: tuple
    rC_Z_g2: tuple
    encoded_IC_base: tuple
    encoded_IC_values: list


@dataclass
class Proof:
    """pi = (g_A, g_B, g_C knowledge commitments, g_H, g_K) as host affine
    integers (hpp:274-351)."""

    g_A: tuple  # (g in G1, h in G1)
    g_B: tuple  # (g in G2, h in G1)
    g_C: tuple  # (g in G1, h in G1)
    g_H: tuple
    g_K: tuple


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def query_families(model, cs: R1CSConstraintSystem, rng, prof: Profiler, system: str,
                   ic_split: bool):
    """The generator's draws and queries (tcc:230-430), shared with ADSNARK:
    t, then alphaA, alphaB, alphaC, rA, rB, beta, gamma from ``rng``; the
    seven G1 families (and, with ``ic_split``, the IC, A's input rows then
    zeroed in A's queries) through one window table and one
    ``batch_exp_with_coeff``, B's G2 half through its own.  Phases "<system>
    qap instance map", "<system> scalars", "<system> G1 window table",
    "<system> G2 window table", "<system> G1 queries (fused)", "<system> B
    query (G2)".  Returns ({query name: (x, y)}, with "IC" under ``ic_split``;
    the secrets by name, with Z(t) as "Zt" and the number of inputs "l")."""
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    r_p = Fr.p

    t = rng.randrange(1, r_p)
    prof.enter_block(f"{system} qap instance map")
    inst = qap.instance_map_with_evaluation(cs, t, Fr)
    prof.leave_block(f"{system} qap instance map")
    m, n, l = inst.num_variables, inst.domain_size, inst.num_inputs
    alphaA, alphaB, alphaC, rA, rB, beta, gamma = (rng.randrange(1, r_p) for _ in range(7))
    rC = rA * rB % r_p
    Zt = inst.Zt

    prof.enter_block(f"{system} scalars")
    # A(t), B(t), C(t) with Z(t) as row m + 1
    words = Fr.from_canonical(canonical_words(Fr, inst.At + [Zt] + inst.Bt + [Zt] + inst.Ct + [Zt]))
    At, Bt, Ct = (words[:, k * (m + 2) : (k + 1) * (m + 2)] for k in range(3))
    c = lambda v: Fr.const(v % r_p)
    # K over rows 0..m (row m + 1 skipped), then the three Z rows; the IC from
    # A's input rows, which A's queries then lose
    K = torch.cat([Fr.add(Fr.add(Fr.mul_const(At[:, : m + 1], c(beta * rA)),
                                 Fr.mul_const(Bt[:, : m + 1], c(beta * rB))),
                          Fr.mul_const(Ct[:, : m + 1], c(beta * rC))),
                   host_table(Fr, [beta * rX * Zt % r_p for rX in (rA, rB, rC)])], dim=1)
    A = torch.cat([Fr.zeros((l + 1,)), At[:, l + 1 :]], dim=1) if ic_split else At
    families = [(A, rA), (A, rA * alphaA), (Bt, rB * alphaB), (Ct, rC), (Ct, rC * alphaC),
                (power_table(Fr, t, n + 1), 1), (K, 1)] + ([(At[:, : l + 1], rA)] if ic_split else [])
    g1_scalars = torch.cat([s for s, _ in families], dim=1)
    g1_coeffs = torch.cat([c(k).unsqueeze(1).expand(-1, s.shape[1]) for s, k in families], dim=1)
    counts = [s.shape[1] for s, _ in families]
    B2_coeff, B2_scalars = c(rB), Bt.contiguous()
    del words, At, Bt, Ct, K, A, families
    prof.leave_block(f"{system} scalars")

    w1 = fixed_base.get_exp_window_size(g1_scalars.shape[1])
    w2 = fixed_base.get_exp_window_size(m + 2)
    prof.enter_block(f"{system} G1 window table")
    t1 = fixed_base.get_window_table(G1, w1, model.g1_generator())
    prof.leave_block(f"{system} G1 window table")
    prof.enter_block(f"{system} G2 window table")
    t2 = fixed_base.get_window_table(G2, w2, model.g2_generator())
    prof.leave_block(f"{system} G2 window table")

    prof.enter_block(f"{system} G1 queries (fused)")
    x, y = _np_pair(G1, fixed_base.batch_exp_with_coeff(G1, w1, t1, g1_coeffs, g1_scalars, Fr))
    del g1_scalars, g1_coeffs, t1
    ends = [0]
    for k in counts:
        ends.append(ends[-1] + k)
    names = ["A_query_g", "A_query_h", "B_query_h", "C_query_g", "C_query_h", "H_query", "K_query",
             "IC"]
    queries = {name: (x[:, a:b], y[:, a:b]) for name, a, b in zip(names, ends, ends[1:])}
    prof.leave_block(f"{system} G1 queries (fused)")
    prof.enter_block(f"{system} B query (G2)")
    queries["B_query_g"] = _np_pair(G2, fixed_base.batch_exp_with_coeff(G2, w2, t2, B2_coeff,
                                                                        B2_scalars, Fr))
    del B2_scalars, t2
    prof.leave_block(f"{system} B query (G2)")
    secrets = {"alphaA": alphaA, "alphaB": alphaB, "alphaC": alphaC, "rA": rA, "rB": rB,
               "rC": rC, "beta": beta, "gamma": gamma, "Zt": Zt, "l": l}
    return queries, secrets


def verification_singles(model, secrets: dict) -> dict:
    """The verification key's points common to PGHR13 and ADSNARK (host
    affine): alphaA H, alphaB G, alphaC H, gamma H, gamma beta G,
    gamma beta H, rC Z(t) H."""
    hc = host_curve(model.name)
    G, H, r_p = hc.g1_gen, hc.g2_gen, hc.fr_spec.p
    gb = secrets["gamma"] * secrets["beta"] % r_p
    return {"alphaA_g2": hc.g2.mul(secrets["alphaA"], H), "alphaB_g1": hc.g1.mul(secrets["alphaB"], G),
            "alphaC_g2": hc.g2.mul(secrets["alphaC"], H), "gamma_g2": hc.g2.mul(secrets["gamma"], H),
            "gamma_beta_g1": hc.g1.mul(gb, G), "gamma_beta_g2": hc.g2.mul(gb, H),
            "rC_Z_g2": hc.g2.mul(secrets["rC"] * secrets["Zt"] % r_p, H)}


def generator(model, cs: R1CSConstraintSystem, rng, profiler: Profiler | None = None) -> Keypair:
    """r1cs_ppzksnark_generator (tcc:230-430), drawing from ``rng`` in the JAX
    package's order: t, then alphaA, alphaB, alphaC, rA, rB, beta, gamma.
    Phases: "pghr13 qap instance map", "pghr13 scalars", "pghr13 G1 window
    table", "pghr13 G2 window table", "pghr13 G1 queries (fused)",
    "pghr13 B query (G2)", "pghr13 vk singles"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    queries, secrets = query_families(model, cs, rng, prof, "pghr13", ic_split=True)
    ICq = queries.pop("IC")
    prof.enter_block("pghr13 vk singles")
    vk = VerificationKey(
        curve=model.name, **verification_singles(model, secrets),
        encoded_IC_base=query_point(model, ICq, 0),
        encoded_IC_values=[query_point(model, ICq, i) for i in range(1, secrets["l"] + 1)])
    prof.leave_block("pghr13 vk singles")
    return Keypair(ProvingKey(curve=model.name, **queries, constraint_system=cs), vk)


def prover(model, pk: ProvingKey, primary, auxiliary, rng,
           profiler: Profiler | None = None) -> Proof:
    """r1cs_ppzksnark_prover (tcc:430-545), drawing d1, d2, d3 from ``rng``
    (each ``rng.randrange(r)``), as the JAX package does.  An assignment
    that does not satisfy the key's constraints raises ValueError.  Phases:
    "pghr13 qap witness map", "pghr13 G1 multiexps", "pghr13 G2 multiexp",
    "pghr13 assemble proof (host)"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    cs = pk.constraint_system
    r_p = Fr.p
    if not cs.is_satisfied(primary, auxiliary):
        raise ValueError("the assignment does not satisfy the constraint system")
    d1, d2, d3 = (rng.randrange(r_p) for _ in range(3))

    prof.enter_block("pghr13 qap witness map")
    full, H = qap.witness_map(model, cs, primary, auxiliary, d1, d2, d3)
    m = cs.num_variables
    w_can = canonical_words(Fr, [v % r_p for v in full])
    h_can = Fr.to_canonical(H)
    del H, full
    prof.leave_block("pghr13 qap witness map")

    # variables 1..m of six G1 families, and H over its n + 1 coefficients
    prof.enter_block("pghr13 G1 multiexps")
    body = lambda pair: G1.from_affine(*(c[:, 1 : m + 1] for c in pair))
    pts, scal = msm_mod.pad_and_stack(
        G1, [body(pk.A_query_g), body(pk.A_query_h), body(pk.B_query_h), body(pk.C_query_g),
             body(pk.C_query_h), body(pk.K_query), G1.from_affine(*pk.H_query)],
        [w_can] * 6 + [h_can])
    del h_can
    res7 = msm_mod.msm_multi_staged(G1, pts, scal)
    del pts, scal
    prof.leave_block("pghr13 G1 multiexps")
    prof.enter_block("pghr13 G2 multiexp")
    res2 = msm_mod.msm_staged(G2, G2.from_affine(*(c[..., 1 : m + 1] for c in pk.B_query_g)),
                              w_can)
    prof.leave_block("pghr13 G2 multiexp")

    prof.enter_block("pghr13 assemble proof (host)")
    hc = host_curve(model.name)
    g1, g2 = hc.g1, hc.g2
    Ag, Ah, Bh, Cg, Ch, K, Hm = (_g1_proj_to_host(model, tuple(c[..., i] for c in res7))
                                 for i in range(7))
    Bg = _g2_proj_to_host(model, res2)

    def kc_half(group, pair, msm, d):
        """pair[0] + d pair[m + 1] + msm (tcc:466-500)."""
        return group.add(group.add(query_point(model, pair, 0),
                                   group.mul(d, query_point(model, pair, m + 1))), msm)

    g_A = (kc_half(g1, pk.A_query_g, Ag, d1), kc_half(g1, pk.A_query_h, Ah, d1))
    g_B = (kc_half(g2, pk.B_query_g, Bg, d2), kc_half(g1, pk.B_query_h, Bh, d2))
    g_C = (kc_half(g1, pk.C_query_g, Cg, d3), kc_half(g1, pk.C_query_h, Ch, d3))
    g_K = K
    for d, row in ((d1, m + 1), (d2, m + 2), (d3, m + 3)):
        g_K = g1.add(g_K, g1.mul(d, query_point(model, pk.K_query, row)))
    g_K = g1.add(g_K, query_point(model, pk.K_query, 0))
    prof.leave_block("pghr13 assemble proof (host)")
    return Proof(g_A=g_A, g_B=g_B, g_C=g_C, g_H=Hm, g_K=g_K)


# ---------------------------------------------------------------------------
# verifiers
# ---------------------------------------------------------------------------

def verifier_process_vk(vk: VerificationKey) -> VerificationKey:
    """The host pairing precomputes nothing across proofs: the key itself."""
    return vk


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """tcc:569-688: the inputs accumulated over the IC (more inputs than the
    key has raise ValueError), the proof's points on the curve, and the five
    pairing checks."""
    hc = host_curve(vk.curve)
    g1 = hc.g1
    if len(primary) > len(vk.encoded_IC_values):
        raise ValueError(f"{len(primary)} inputs, the key has {len(vk.encoded_IC_values)}")
    acc = vk.encoded_IC_base
    for v, P in zip(primary, vk.encoded_IC_values):
        acc = g1.add(acc, g1.mul(v % hc.fr_spec.p, P))
    g1_points = (proof.g_A[0], proof.g_A[1], proof.g_B[1], proof.g_C[0], proof.g_C[1],
                 proof.g_H, proof.g_K)
    if not all(g1.is_on_curve(P) for P in g1_points) or not hc.g2.is_on_curve(proof.g_B[0]):
        return False
    engine = AtePairing(hc)
    gt, e, one2 = engine.GT, engine.reduced_pairing, hc.g2_gen
    # the knowledge commitments: e(g, alpha) = e(h, H), B's mirrored
    if e(proof.g_A[0], vk.alphaA_g2) != e(proof.g_A[1], one2):
        return False
    if e(vk.alphaB_g1, proof.g_B[0]) != e(proof.g_B[1], one2):
        return False
    if e(proof.g_C[0], vk.alphaC_g2) != e(proof.g_C[1], one2):
        return False
    # divisibility: e(A + acc, B) = e(H, rC Z) e(C, H)
    A_acc = g1.add(proof.g_A[0], acc)
    if e(A_acc, proof.g_B[0]) != gt.mul(e(proof.g_H, vk.rC_Z_g2), e(proof.g_C[0], one2)):
        return False
    # same coefficients: e(K, gamma) = e(A + acc + C, gamma beta) e(gamma beta, B)
    return e(proof.g_K, vk.gamma_g2) == gt.mul(e(g1.add(A_acc, proof.g_C[0]), vk.gamma_beta_g2),
                                               e(vk.gamma_beta_g1, proof.g_B[0]))


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """The weak check with exactly as many inputs as the key."""
    if len(vk.encoded_IC_values) != len(primary):
        return False
    return online_verifier_weak_IC(vk, primary, proof)


def verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_weak_IC(verifier_process_vk(vk), primary, proof)


def verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_strong_IC(verifier_process_vk(vk), primary, proof)
