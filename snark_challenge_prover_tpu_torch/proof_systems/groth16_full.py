"""Full Groth16 (r1cs_gg_ppzksnark): key generator, blinded prover, verifiers.

Counterpart of the JAX package's ``proof_systems/groth16_full.py``
(libsnark r1cs_gg_ppzksnark.{hpp,tcc}).

The generator (tcc:207-380): sample t, alpha, beta, delta; evaluate the QAP at t
(``reductions.r1cs_to_qap.instance_map_with_evaluation``, host); build the
A, B, L and H queries by fixed-base exponentiation on the model's device
(``ops.fixed_base``), the four G1 queries through one window table and one
``batch_exp_with_coeff``, the G2 B query through its own ``batch_exp``
(``proving_key``); and the verification key's e(alpha, beta), delta_g2 and
ABC on the host (``verification_key``).  This scheme variant has no gamma:
ABC pairs with the plain G2 generator.  The challenge's files need only
the proving key, so ``cli_generate_parameters`` calls ``proving_key``
alone; the JAX package's ``generator`` and ``Keypair`` are these two
calls.

The scalars are made on the device from the host's canonical words: ABC_i
= beta A_i(t) + alpha B_i(t) + C_i(t), L_i = ABC_i / delta for the
auxiliary variables and H_i = t^i Z(t) / delta, t^i by ``ops.fft.power_table``.

The prover (tcc:382-497): the QAP witness map on the device
(``reductions.r1cs_to_qap.witness_map``), the five MSMs that the challenge
prover runs (``groth16.groth16_msms``), and the blinding on the host's
exact integers, r and s drawn from the caller's generator:

    A = alpha + sum a_i A_i(t) + r delta
    B = beta  + sum a_i B_i(t) + s delta     (in G1 and G2)
    C = Ht + Lt + s A + r B - r s delta.

The verifiers (tcc:499-672) run on the host with ``AtePairing``: the inputs
accumulated over ABC, the proof's points on the curve, and
e(A, B) = e(alpha, beta) e(acc, G2) e(C, delta).  A proof's bytes are the
challenge's wire format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..host.curves import host_curve
from ..io import serialization as ser
from ..ops import fixed_base
from ..ops.fft import power_table
from ..ops.field import canonical_words
from ..reductions import r1cs_to_qap as qap
from ..relations.r1cs import R1CSConstraintSystem
from ..utils.profiling import Profiler
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host, g1_words, g2_words, groth16_msms, msm_results_to_host


@dataclass
class ProvingKey:
    """r1cs_gg_ppzksnark_proving_key (hpp:70-165): the single points as
    host affine integers, each query as affine (x, y) Montgomery word
    tensors on the model's device, an identity stored as (0, 0) (the wire
    format's)."""

    curve: str
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    A_query: tuple     # (x, y), each (24, m + 1)
    B_query_g2: tuple  # (x, y), each (deg, 24, m + 1)
    B_query_g1: tuple
    H_query: tuple     # (24, n - 1)
    L_query: tuple     # (24, m - num_inputs)
    constraint_system: R1CSConstraintSystem


@dataclass
class VerificationKey:
    """r1cs_gg_ppzksnark_verification_key (hpp:167-260)."""

    curve: str
    alpha_g1_beta_g2: tuple  # GT element: a pair of Fq^e components
    delta_g2: tuple          # host affine
    ABC_g1: list             # [ABC_0, ..., ABC_num_inputs] host affine


@dataclass
class Proof:
    """pi = (A in G1, B in G2, C in G1) as host affine integers (hpp:262-320).
    ``extras`` holds the prover's (Ht + Lt, r, s, A, B in G1, delta_g1), which
    ``bg.prover`` needs to rescale C; it takes no part in equality."""

    g_A: tuple
    g_B: tuple
    g_C: tuple
    extras: tuple | None = field(default=None, compare=False, repr=False)

    def to_bytes(self, model) -> bytes:
        """The challenge's wire format: A, B, C affine, Montgomery, 96 bytes
        a coordinate, the identity as zeros."""
        w = ser.Writer()
        w.g1(*g1_words(model, self.g_A))
        w.g2(*g2_words(model, self.g_B))
        w.g1(*g1_words(model, self.g_C))
        return w.bytes()


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def _wire_affine(curve, P):
    """Projective batch -> affine (x, y) with the identity as (0, 0)."""
    F = curve.F
    x, y, z = curve.to_affine(P)
    return x, F.select(F.is_zero(z), F.zeros(z.shape[F.elem_ndim:]), y)


@dataclass
class KeySecrets:
    """What the verification key needs of the generator's secrets: the G1
    base (host affine) and ABC_i = beta A_i(t) + alpha B_i(t) + C_i(t) for
    i <= num_inputs."""

    g1_base: tuple
    abc: list


def proving_key(model, cs: R1CSConstraintSystem, rng, profiler: Profiler | None = None):
    """The proving key of r1cs_gg_ppzksnark_generator (tcc:207-350) and the
    secrets ``verification_key`` needs, drawing from ``rng`` in the JAX
    package's order: the A/B swap, then t, alpha, beta, delta, then the G1
    base's scalar.  Phases: "instance map", "scalars", "window tables",
    "G1 queries", "G2 query"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    hc = host_curve(model.name)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    r_p = Fr.p

    cs.swap_AB_if_beneficial()
    t = rng.randrange(1, r_p)
    alpha = rng.randrange(1, r_p)
    beta = rng.randrange(1, r_p)
    delta = rng.randrange(1, r_p)
    delta_inv = pow(delta, -1, r_p)

    prof.enter_block("instance map")
    inst = qap.instance_map_with_evaluation(cs, t, Fr)
    prof.leave_block("instance map")
    n, m, nin = inst.domain_size, inst.num_variables, inst.num_inputs

    prof.enter_block("scalars")
    At, Bt, Ct = (canonical_words(Fr, v) for v in (inst.At, inst.Bt, inst.Ct))
    At_m, Bt_m = Fr.from_canonical(At), Fr.from_canonical(Bt)
    abc = Fr.add(Fr.add(Fr.mul_const(At_m, Fr.const(beta)), Fr.mul_const(Bt_m, Fr.const(alpha))),
                 Fr.from_canonical(Ct))
    # the four G1 queries share one table and one batch_exp: A, B, then
    # L_i = ABC_i / delta and H_i = t^i Z(t) / delta, the last two by their
    # coefficients (multiexp.tcc:649)
    g1_scalars = torch.cat([At_m, Bt_m, abc[:, nin + 1 :], power_table(Fr, t, n - 1)], dim=1)
    g1_coeffs = torch.cat([Fr.const(1).unsqueeze(1).expand(-1, 2 * (m + 1)),
                           Fr.const(delta_inv).unsqueeze(1).expand(-1, m - nin),
                           Fr.const(inst.Zt * delta_inv % r_p).unsqueeze(1).expand(-1, n - 1)],
                          dim=1)
    del abc, At, Ct, At_m, Bt_m
    abc_inputs = [(beta * inst.At[i] + alpha * inst.Bt[i] + inst.Ct[i]) % r_p
                  for i in range(nin + 1)]
    g1_scalar = rng.randrange(1, r_p)  # the G1 base is g1_scalar times the generator (tcc:290)
    prof.leave_block("scalars")

    prof.enter_block("window tables")
    g1_base = fixed_base.opt_window_wnaf_exp(G1, model.g1_generator(), g1_scalar)
    w1 = fixed_base.get_exp_window_size(g1_scalars.shape[1])
    w2 = fixed_base.get_exp_window_size(m + 1)
    t1 = fixed_base.get_window_table(G1, w1, g1_base)
    t2 = fixed_base.get_window_table(G2, w2, model.g2_generator())
    prof.leave_block("window tables")

    prof.enter_block("G1 queries")
    x, y = _wire_affine(G1, fixed_base.batch_exp_with_coeff(G1, w1, t1, g1_coeffs, g1_scalars, Fr))
    del g1_scalars, g1_coeffs, t1
    ends = [0, m + 1, 2 * (m + 1), 2 * (m + 1) + m - nin, x.shape[-1]]
    A_q, B1_q, L_q, H_q = ((x[:, a:b], y[:, a:b]) for a, b in zip(ends, ends[1:]))
    prof.leave_block("G1 queries")

    prof.enter_block("G2 query")
    B2_q = _wire_affine(G2, fixed_base.batch_exp(G2, w2, t2, Bt))
    del Bt, t2
    prof.leave_block("G2 query")

    g1b = _g1_proj_to_host(model, g1_base)
    g2b = hc.g2_gen
    pk = ProvingKey(curve=model.name, alpha_g1=hc.g1.mul(alpha, g1b), beta_g1=hc.g1.mul(beta, g1b),
                    beta_g2=hc.g2.mul(beta, g2b), delta_g1=hc.g1.mul(delta, g1b),
                    delta_g2=hc.g2.mul(delta, g2b), A_query=A_q, B_query_g2=B2_q,
                    B_query_g1=B1_q, H_query=H_q, L_query=L_q, constraint_system=cs)
    return pk, KeySecrets(g1_base=g1b, abc=abc_inputs)


def verification_key(pk: ProvingKey, secrets: KeySecrets) -> VerificationKey:
    """r1cs_gg_ppzksnark_verification_key (tcc:352-366) on the host:
    e(alpha_g1, beta_g2), delta_g2 and ABC_i times the G1 base."""
    hc = host_curve(pk.curve)
    return VerificationKey(curve=pk.curve,
                           alpha_g1_beta_g2=AtePairing(hc).reduced_pairing(pk.alpha_g1, pk.beta_g2),
                           delta_g2=pk.delta_g2,
                           ABC_g1=[hc.g1.mul(v, secrets.g1_base) for v in secrets.abc])



def generator(model, cs: R1CSConstraintSystem, rng) -> Keypair:
    """r1cs_gg_ppzksnark_generator (tcc:207-380): ``proving_key`` and then
    ``verification_key``, drawing from ``rng`` as the JAX package's does."""
    pk, secrets = proving_key(model, cs, rng)
    return Keypair(pk, verification_key(pk, secrets))


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def prover(model, pk: ProvingKey, primary, auxiliary, rng,
           profiler: Profiler | None = None) -> Proof:
    """r1cs_gg_ppzksnark_prover (tcc:382-497), blinding included: r, then
    s, each ``rng.randrange(r)`` (zero allowed), as the JAX package draws
    them.  An assignment that does not satisfy the key's constraints
    raises ValueError.  Phases (``profiler``): "witness map",
    "G1 multiexp x4", "G2 multiexp", "assemble proof (host)"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    Fr = model.Fr
    cs = pk.constraint_system
    r_p = Fr.p
    if not cs.is_satisfied(primary, auxiliary):
        raise ValueError("the assignment does not satisfy the constraint system")

    prof.enter_block("witness map")
    full, H = qap.witness_map(model, cs, primary, auxiliary)
    n = H.shape[1] - 1
    r = rng.randrange(r_p)
    s = rng.randrange(r_p)
    w_can = canonical_words(Fr, [1] + [v % r_p for v in full])
    h_can = Fr.to_canonical(H[:, : n - 1])
    del H
    prof.leave_block("witness map")

    g1_res, g2_res = groth16_msms(model, pk.A_query, pk.B_query_g1, pk.B_query_g2, pk.H_query,
                                  pk.L_query, w_can, h_can, cs.primary_input_size, None, prof)

    prof.enter_block("assemble proof (host)")
    hc = host_curve(model.name)
    g1, g2 = hc.g1, hc.g2
    At, Bt1, Ht, Lt, Bt2 = msm_results_to_host(model, g1_res, g2_res)
    g1_A = g1.add(g1.add(pk.alpha_g1, At), g1.mul(r, pk.delta_g1))
    g1_B = g1.add(g1.add(pk.beta_g1, Bt1), g1.mul(s, pk.delta_g1))
    g2_B = g2.add(g2.add(pk.beta_g2, Bt2), g2.mul(s, pk.delta_g2))
    HtLt = g1.add(Ht, Lt)
    g1_C = g1.add(g1.add(HtLt, g1.mul(s, g1_A)),
                  g1.add(g1.mul(r, g1_B), g1.neg(g1.mul(r * s % r_p, pk.delta_g1))))
    prof.leave_block("assemble proof (host)")
    return Proof(g_A=g1_A, g_B=g2_B, g_C=g1_C, extras=(HtLt, r, s, g1_A, g1_B, pk.delta_g1))


# ---------------------------------------------------------------------------
# verifiers
# ---------------------------------------------------------------------------

def verifier_process_vk(vk: VerificationKey) -> VerificationKey:
    """The processed key (tcc:499-512): the host pairing precomputes nothing
    across proofs, so it is the key itself."""
    return vk


def input_accumulator(hc, ABC_g1: list, primary):
    """ABC_0 + sum_i x_i ABC_{i+1}; more inputs than the key has raise."""
    if len(primary) > len(ABC_g1) - 1:
        raise ValueError(f"{len(primary)} inputs, the key has {len(ABC_g1) - 1}")
    acc = ABC_g1[0]
    for v, P in zip(primary, ABC_g1[1:]):
        acc = hc.g1.add(acc, hc.g1.mul(v % hc.fr_spec.p, P))
    return acc


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """tcc:515-566: the inputs accumulated, the proof's points on the curve,
    and e(A, B) = e(alpha, beta) e(acc, G2) e(C, delta)."""
    hc = host_curve(vk.curve)
    acc = input_accumulator(hc, vk.ABC_g1, primary)
    for P, group in ((proof.g_A, hc.g1), (proof.g_B, hc.g2), (proof.g_C, hc.g1)):
        if not group.is_on_curve(P):
            return False
    engine = AtePairing(hc)
    gt = engine.GT
    rhs = gt.mul(vk.alpha_g1_beta_g2, gt.mul(engine.reduced_pairing(acc, hc.g2_gen),
                                             engine.reduced_pairing(proof.g_C, vk.delta_g2)))
    return engine.reduced_pairing(proof.g_A, proof.g_B) == rhs


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    """tcc:583-607: the weak check with exactly as many inputs as the key."""
    if len(vk.ABC_g1) - 1 != len(primary):
        return False
    return online_verifier_weak_IC(vk, primary, proof)


def verifier_weak_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_weak_IC(verifier_process_vk(vk), primary, proof)


def verifier_strong_IC(vk: VerificationKey, primary, proof: Proof) -> bool:
    return online_verifier_strong_IC(verifier_process_vk(vk), primary, proof)


# the affine variants (tcc:609-672) differ from these only in the pairing's
# internals; the host pairing has one form
affine_verifier_weak_IC = verifier_weak_IC
affine_verifier_strong_IC = verifier_strong_IC
