"""The USCS ppzkSNARK (square span programs, [DFGK14]): key generator,
blinded prover, verifiers.

Counterpart of the JAX package's ``proof_systems/uscs_ppzksnark.py``
(libsnark uscs_ppzksnark.{hpp,tcc}).

The generator (tcc:205-340) evaluates the SSP at a random t
(``reductions.uscs_to_ssp``, host), appends Z(t) to V(t) as row m + 1
(Vt_table), draws alpha and tilde, and builds on the curves' generators G
and H

    V_g1_query_i       = V_i(t) G         i > num_inputs, then the Z(t) row
    alpha_V_g1_query_i = alpha V_i(t) G   likewise
    H_g1_query_i       = t^i G            i <= n
    V_g2_query_i       = V_i(t) H         every row, the Z(t) row included
    vk = (tilde H, alpha tilde H, Z(t) H, IC_i = V_i(t) G for i <= num_inputs).

The four G1 families (the IC's V_1..V_l last) go through one window table
and one ``batch_exp_with_coeff``, alpha the coefficient of its column range
and t^i made on the device (``ops.fft.power_table``); the G2 query through
its own table.

The prover (tcc:343-432): the SSP witness map with the zero-knowledge
shift d (``uscs_to_ssp.witness_map``), the three G1 MSMs (V and alpha V over
the non-input variables, H over its n + 1 coefficients) as one staged
multi-MSM, the G2 MSM over variables 1..m, and the O(1) assembly on the
host's exact integers:

    V_g1 = d V_g1_query[Z row] + <V_g1_query[..nv], w[l+1..m]>
    alpha_V_g1 likewise
    H_g1 = <H_g1_query, H>
    V_g2 = V_g2_query[0] + d V_g2_query[Z row] + <V_g2_query[1..m], w>.

The verifiers (tcc:434-530) run the three pairing checks on the host,
acc the inputs accumulated over the IC:

    e(V_g1 + acc, H) = e(G, V_g2)
    e(V_g1 + acc, V_g2) = e(H_g1, Z(t) H) e(G, H)
    e(V_g1, alpha tilde H) = e(alpha_V_g1, tilde H).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..host.curves import host_curve
from ..ops import fixed_base, msm as msm_mod
from ..ops.fft import power_table
from ..ops.field import canonical_words
from ..reductions import uscs_to_ssp as ssp
from ..relations.uscs import USCSConstraintSystem
from ..utils.profiling import Profiler
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host, _g2_proj_to_host, query_point
from .groth16_full import _wire_affine


@dataclass
class ProvingKey:
    """uscs_ppzksnark_proving_key (hpp:74-157): each query as affine (x, y)
    Montgomery word tensors on the model's device, the identity as y = 0."""

    curve: str
    V_g1_query: tuple        # (x, y), each (24, m - num_inputs + 1), the Z(t) row last
    alpha_V_g1_query: tuple
    H_g1_query: tuple        # (24, n + 1)
    V_g2_query: tuple        # G2: (x, y), each (deg, 24, m + 2)
    constraint_system: USCSConstraintSystem


@dataclass
class VerificationKey:
    """uscs_ppzksnark_verification_key (hpp:159-230), host affine."""

    curve: str
    tilde_g2: tuple
    alpha_tilde_g2: tuple
    Z_g2: tuple
    encoded_IC_base: tuple
    encoded_IC_values: list


@dataclass
class Proof:
    """pi = (V_g1, alpha_V_g1, H_g1, V_g2) as host affine integers
    (hpp:232-303)."""

    V_g1: tuple
    alpha_V_g1: tuple
    H_g1: tuple
    V_g2: tuple


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def generator(model, cs: USCSConstraintSystem, rng, profiler: Profiler | None = None) -> Keypair:
    """uscs_ppzksnark_generator (tcc:205-340), drawing from ``rng`` in the JAX
    package's order: t, then alpha and tilde.  Phases: "ssp instance map",
    "uscs scalars", "uscs G1 window table", "uscs G2 window table",
    "uscs G1 queries (fused)", "uscs V query (G2)", "uscs vk singles"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    hc = host_curve(model.name)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    r_p = Fr.p

    t = rng.randrange(1, r_p)
    prof.enter_block("ssp instance map")
    inst = ssp.instance_map_with_evaluation(cs, t, Fr)
    prof.leave_block("ssp instance map")
    m, n, l = inst.num_variables, inst.domain_size, inst.num_inputs
    alpha, tilde = rng.randrange(1, r_p), rng.randrange(1, r_p)
    Zt = inst.Zt

    prof.enter_block("uscs scalars")
    # Vt_table = V(t) ++ [Z(t)]: the inputs' rows 1..l go to the IC, the rest
    # (with the Z(t) row) to V and alpha V
    Vt_c = canonical_words(Fr, inst.Vt + [Zt])
    Vt_m = Fr.from_canonical(Vt_c)
    families = [(Vt_m[:, l + 1 :], 1), (Vt_m[:, l + 1 :], alpha), (power_table(Fr, t, n + 1), 1),
                (Vt_m[:, 1 : l + 1], 1)]
    g1_scalars = torch.cat([s for s, _ in families], dim=1)
    g1_coeffs = torch.cat([Fr.const(k).unsqueeze(1).expand(-1, s.shape[1]) for s, k in families],
                          dim=1)
    counts = [s.shape[1] for s, _ in families]
    del Vt_m, families
    prof.leave_block("uscs scalars")

    w1 = fixed_base.get_exp_window_size(g1_scalars.shape[1])
    w2 = fixed_base.get_exp_window_size(m + 2)
    prof.enter_block("uscs G1 window table")
    t1 = fixed_base.get_window_table(G1, w1, model.g1_generator())
    prof.leave_block("uscs G1 window table")
    prof.enter_block("uscs G2 window table")
    t2 = fixed_base.get_window_table(G2, w2, model.g2_generator())
    prof.leave_block("uscs G2 window table")

    prof.enter_block("uscs G1 queries (fused)")
    x, y = _wire_affine(G1, fixed_base.batch_exp_with_coeff(G1, w1, t1, g1_coeffs, g1_scalars, Fr))
    del g1_scalars, g1_coeffs, t1
    ends = [0]
    for k in counts:
        ends.append(ends[-1] + k)
    Vq, aVq, Hq, ICq = ((x[:, a:b], y[:, a:b]) for a, b in zip(ends, ends[1:]))
    prof.leave_block("uscs G1 queries (fused)")
    prof.enter_block("uscs V query (G2)")
    V2q = _wire_affine(G2, fixed_base.batch_exp(G2, w2, t2, Vt_c))
    del Vt_c, t2
    prof.leave_block("uscs V query (G2)")

    prof.enter_block("uscs vk singles")
    G, H = hc.g1_gen, hc.g2_gen
    vk = VerificationKey(
        curve=model.name, tilde_g2=hc.g2.mul(tilde, H),
        alpha_tilde_g2=hc.g2.mul(alpha * tilde % r_p, H), Z_g2=hc.g2.mul(Zt, H),
        encoded_IC_base=hc.g1.mul(inst.Vt[0], G),
        encoded_IC_values=[query_point(model, ICq, i) for i in range(l)])
    prof.leave_block("uscs vk singles")
    pk = ProvingKey(curve=model.name, V_g1_query=Vq, alpha_V_g1_query=aVq, H_g1_query=Hq,
                    V_g2_query=V2q, constraint_system=cs)
    return Keypair(pk, vk)


def prover(model, pk: ProvingKey, primary, auxiliary, rng,
           profiler: Profiler | None = None) -> Proof:
    """uscs_ppzksnark_prover (tcc:343-432), drawing d from ``rng``
    (``rng.randrange(r)``), as the JAX package does.  An assignment that does
    not satisfy the key's constraints raises ValueError.  Phases:
    "ssp witness map", "uscs G1 multiexps", "uscs G2 multiexp",
    "uscs assemble proof (host)"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    cs = pk.constraint_system
    r_p = Fr.p
    if not cs.is_satisfied(primary, auxiliary):
        raise ValueError("the assignment does not satisfy the constraint system")
    d = rng.randrange(r_p)

    prof.enter_block("ssp witness map")
    wit = ssp.witness_map(model, cs, primary, auxiliary, d)
    m, l = wit.num_variables, wit.num_inputs
    nv = m - l  # the non-input variables
    w_can = canonical_words(Fr, wit.full_assignment)  # variables 1..m
    h_can = Fr.to_canonical(wit.H)
    del wit
    prof.leave_block("ssp witness map")

    # V and alpha V over the non-input variables (their Z(t) row left out), H
    # over its n + 1 coefficients
    prof.enter_block("uscs G1 multiexps")
    head = lambda pair: G1.from_affine(*(c[:, :nv] for c in pair))
    pts, scal = msm_mod.pad_and_stack(
        G1, [head(pk.V_g1_query), head(pk.alpha_V_g1_query), G1.from_affine(*pk.H_g1_query)],
        [w_can[:, l:], w_can[:, l:], h_can])
    del h_can
    res3 = msm_mod.msm_multi_staged(G1, pts, scal)
    del pts, scal
    prof.leave_block("uscs G1 multiexps")
    prof.enter_block("uscs G2 multiexp")
    res2 = msm_mod.msm_staged(G2, G2.from_affine(*(c[..., 1 : m + 1] for c in pk.V_g2_query)),
                              w_can)
    prof.leave_block("uscs G2 multiexp")

    prof.enter_block("uscs assemble proof (host)")
    hc = host_curve(model.name)
    g1, g2 = hc.g1, hc.g2
    V_m, aV_m, H_m = (_g1_proj_to_host(model, tuple(c[..., i] for c in res3)) for i in range(3))
    V2_m = _g2_proj_to_host(model, res2)
    last = pk.V_g1_query[0].shape[-1] - 1  # the Z(t) row, nv
    last2 = pk.V_g2_query[0].shape[-1] - 1  # the Z(t) row, m + 1
    V_g1 = g1.add(g1.mul(d, query_point(model, pk.V_g1_query, last)), V_m)
    alpha_V_g1 = g1.add(g1.mul(d, query_point(model, pk.alpha_V_g1_query, last)), aV_m)
    V_g2 = g2.add(g2.add(query_point(model, pk.V_g2_query, 0),
                         g2.mul(d, query_point(model, pk.V_g2_query, last2))), V2_m)
    prof.leave_block("uscs assemble proof (host)")
    return Proof(V_g1=V_g1, alpha_V_g1=alpha_V_g1, H_g1=H_m, V_g2=V_g2)


# ---------------------------------------------------------------------------
# verifiers
# ---------------------------------------------------------------------------

def verifier_process_vk(vk: VerificationKey) -> VerificationKey:
    """The host pairing precomputes nothing across proofs: the key itself."""
    return vk


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """tcc:447-530: the inputs accumulated over the IC (more inputs than the
    key has raise ValueError), the proof's points on the curve, and the
    three pairing checks."""
    hc = host_curve(vk.curve)
    g1 = hc.g1
    if len(primary) > len(vk.encoded_IC_values):
        raise ValueError(f"{len(primary)} inputs, the key has {len(vk.encoded_IC_values)}")
    acc = vk.encoded_IC_base
    for v, P in zip(primary, vk.encoded_IC_values):
        acc = g1.add(acc, g1.mul(v % hc.fr_spec.p, P))
    if not all(g1.is_on_curve(P) for P in (proof.V_g1, proof.alpha_V_g1, proof.H_g1)) \
            or not hc.g2.is_on_curve(proof.V_g2):
        return False
    engine = AtePairing(hc)
    gt, e = engine.GT, engine.reduced_pairing
    one1, one2 = hc.g1_gen, hc.g2_gen
    V_acc = g1.add(proof.V_g1, acc)
    # V(t) in both groups
    if e(V_acc, one2) != e(one1, proof.V_g2):
        return False
    # V^2 = H Z + 1
    if e(V_acc, proof.V_g2) != gt.mul(e(proof.H_g1, vk.Z_g2), e(one1, one2)):
        return False
    # the same coefficients under alpha
    return e(proof.V_g1, vk.alpha_tilde_g2) == e(proof.alpha_V_g1, vk.tilde_g2)


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """The weak check with exactly as many inputs as the key."""
    if len(vk.encoded_IC_values) != len(primary):
        return False
    return online_verifier_weak_IC(vk, primary, proof)


def verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_weak_IC(verifier_process_vk(vk), primary, proof)


def verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_strong_IC(verifier_process_vk(vk), primary, proof)
