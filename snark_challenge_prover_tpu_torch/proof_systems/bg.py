"""BG (Bowe-Gabizon 2017) SNARK: r1cs_bg_ppzksnark.

Counterpart of the JAX package's ``proof_systems/bg.py`` (libsnark
r1cs_bg_ppzksnark.{hpp,tcc}, the Groth16 variant the reference fork carries
for Mina; its caml surface is the camlsnark_*_bg_* family,
caml_mnt4753.cpp:900-1077).  BG adds a delta randomised by the prover:

  * the keys are Groth16 keys (the BG generator, tcc:200-394, is the gg
    generator), so ``generator`` and the key containers are
    ``groth16_full``'s;
  * ``prover(model, pk, d, ...)`` (tcc:394-514) takes a field element d from
    the caller (Mina draws one a proof) and blinds with delta' = d delta:
        A = alpha + sum a_i A_i(t) + (r d) delta
        B = beta  + sum a_i B_i(t) + (s d) delta   (G1 and G2)
        C = d^-1 (Ht + Lt) + s A + r B - (r s d) delta
        delta_prime = d delta_g2,
    which is the Groth16 prover run on the delta' view of the same key
    (the MSMs do not involve delta) with C rescaled from its ``extras``;
    z and y_s are identity placeholders, as the reference's prover returns
    them (tcc:505-510), for the caller to fill in;
  * the verifiers (tcc:516-647): the Groth16 check with the proof's own
    delta_prime pairing C, and e(y_s, delta') e(-z, delta) = 1 (tcc:579-584).
    The fork's online verifier as written (tcc:564-566) pairs C with
    vk.delta_g2, under which only d = 1 proofs close; Mina's verifier pairs
    with delta_prime, which is the default here, and
    ``reference_literal_qap_check=True`` gives the fork's literal form.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..host.curves import host_curve
from .ate_pairing import AtePairing
from .groth16_full import (  # noqa: F401  (the BG generator is the gg generator)
    Keypair,
    ProvingKey,
    VerificationKey,
    generator,
    input_accumulator,
)
from .groth16_full import prover as gg_prover


@dataclass
class BGProof:
    """r1cs_bg_ppzksnark_proof (hpp:120-200): Groth16's (A, B, C), delta_prime
    = d delta_g2, and the pair z, y_s (G1, host affine; None the identity)."""

    g_A: tuple
    g_B: tuple
    g_C: tuple
    delta_prime: tuple
    z: tuple | None = None
    y_s: tuple | None = None


def prover(model, pk: ProvingKey, d: int, primary, auxiliary, rng,
           profiler=None) -> BGProof:
    """r1cs_bg_ppzksnark_prover (tcc:394-514); d = 0 mod r raises."""
    hc = host_curve(model.name)
    r_p = model.Fr.p
    d %= r_p
    if d == 0:
        raise ValueError("the BG randomiser d must be nonzero")
    shifted = replace(pk, delta_g1=hc.g1.mul(d, pk.delta_g1), delta_g2=hc.g2.mul(d, pk.delta_g2))
    gg = gg_prover(model, shifted, primary, auxiliary, rng, profiler)
    # gg's C is (Ht + Lt) + s A + r B - r s delta'; BG's takes d^-1 (Ht + Lt)
    HtLt, r, s, g1_A, g1_B, delta_prime_g1 = gg.extras
    g1 = hc.g1
    C = g1.add(g1.add(g1.mul(pow(d, -1, r_p), HtLt), g1.mul(s, g1_A)),
               g1.add(g1.mul(r, g1_B), g1.neg(g1.mul(r * s % r_p, delta_prime_g1))))
    return BGProof(g_A=gg.g_A, g_B=gg.g_B, g_C=C, delta_prime=shifted.delta_g2)


def online_verifier_weak_IC(vk: VerificationKey, primary, proof: BGProof,
                            reference_literal_qap_check: bool = False) -> bool:
    """tcc:532-590: the inputs accumulated, the proof's points on the curve,
    the QAP check with C paired with delta_prime (vk.delta_g2 with
    ``reference_literal_qap_check``), and e(y_s, delta') e(-z, delta) = 1."""
    hc = host_curve(vk.curve)
    acc = input_accumulator(hc, vk.ABC_g1, primary)
    for P, group in ((proof.g_A, hc.g1), (proof.g_B, hc.g2), (proof.g_C, hc.g1),
                     (proof.delta_prime, hc.g2)):
        if not group.is_on_curve(P):
            return False
    engine = AtePairing(hc)
    gt = engine.GT
    c_partner = vk.delta_g2 if reference_literal_qap_check else proof.delta_prime
    rhs = gt.mul(vk.alpha_g1_beta_g2, gt.mul(engine.reduced_pairing(acc, hc.g2_gen),
                                             engine.reduced_pairing(proof.g_C, c_partner)))
    if engine.reduced_pairing(proof.g_A, proof.g_B) != rhs:
        return False
    if proof.y_s is None and proof.z is None:
        return True  # the identity placeholders satisfy the BG check
    t1 = gt.one if proof.y_s is None else engine.reduced_pairing(proof.y_s, proof.delta_prime)
    t2 = gt.one if proof.z is None else engine.reduced_pairing(hc.g1.neg(proof.z), vk.delta_g2)
    return gt.mul(t1, t2) == gt.one


def online_verifier_strong_IC(vk: VerificationKey, primary, proof: BGProof,
                              reference_literal_qap_check: bool = False) -> bool:
    """tcc:606-626: the weak check with exactly as many inputs as the key."""
    if len(vk.ABC_g1) - 1 != len(primary):
        return False
    return online_verifier_weak_IC(vk, primary, proof, reference_literal_qap_check)


verifier_weak_IC = online_verifier_weak_IC
verifier_strong_IC = online_verifier_strong_IC


def verify_components(a, b, c, delta_prime, z, y_s, vk: VerificationKey, primary) -> bool:
    """camlsnark_*_bg_proof_verify_components (caml_mnt4753.cpp:1038-1055):
    a proof assembled from the caller's components, strong-IC verified."""
    return verifier_strong_IC(vk, primary, BGProof(g_A=a, g_B=b, g_C=c, delta_prime=delta_prime,
                                                   z=z, y_s=y_s))
