"""Full Groth16 (r1cs_gg_ppzksnark): the key generator.

Counterpart of ``generator`` and the key containers of the JAX package's
``proof_systems/groth16_full.py`` (libsnark r1cs_gg_ppzksnark.tcc:207-380):
sample t, alpha, beta, delta; evaluate the QAP at t
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
The blinded prover and the verifiers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..host.curves import host_curve
from ..ops import fixed_base
from ..ops.fft import power_table
from ..reductions import r1cs_to_qap as qap
from ..relations.r1cs import R1CSConstraintSystem
from ..utils.bigint import ints_to_words
from ..utils.profiling import Profiler
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host


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


def canonical_words(F, values) -> torch.Tensor:
    """Canonical host integers -> their words (24, len) on F's device."""
    return torch.from_numpy(ints_to_words(values)).to(F.device)


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

