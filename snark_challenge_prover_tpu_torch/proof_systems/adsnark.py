"""ADSNARK (r1cs_ppzkadsnark): SNARKs over authenticated data.

Counterpart of the JAX package's ``proof_systems/adsnark.py`` (libsnark
r1cs_ppzkadsnark.{hpp,tcc}, the Backes-Barbosa-Fiore-Reischuk scheme): a
PGHR13-style SNARK whose public inputs a data provider authenticates with
MACs and label signatures, verified with the secret authentication key
(symmetric) or publicly through pairings.

  * The authentication layer (tcc:378-446), on the host: sak = (i, the
    signature key, a PRF seed), pak = (-i H, the signature's public key),
    pap = i G.  ``auth_sign``: lambda = PRF(seed, label), Lambda = lambda H,
    sigma = Sign(label, Lambda), mu = lambda + i v, a linear MAC on the value
    v.  The PRF is HMAC-SHA512 expanded to 1024 bits mod r, the signature a
    Schnorr signature over G1 (hash SHA-512 over the label, Lambda and R),
    the instantiations the JAX package chose.
  * The generator (tcc:452-637): PGHR13's without the IC split, so A's
    input rows stay in its query; the verification key carries A0 =
    A_query[0].g and Ain = A_query[1..l].g, the proving key rA_i_Z_g1 =
    (rA Z(t)) pap.I1.  The seven G1 families go through one window table
    and one ``batch_exp_with_coeff``, B's G2 half through its own.
  * The prover (tcc:641-820): the QAP witness map with the shifts
    (d1 + dauth, d2, d3); nine G1 MSMs in one staged multi-MSM (A's g and h
    halves once over the auxiliary rows and once over the input rows, B.h,
    C.g, C.h and K over the whole assignment, H over its coefficients) and
    the G2 MSM, then on the host's exact integers
        g_A   = d1 A_query[m+1] + <A_query[1..m], w with the inputs zeroed>
        g_Aau = dauth A_query[m+1] + <A_query[1..l], the inputs>
        g_B, g_C as PGHR13's (with d2, d3), g_H = <H_query, H>,
        g_K   = K_query[0] + (d1 + dauth) K[m+1] + d2 K[m+2] + d3 K[m+3]
                + <K_query[1..m], w>, the witness map's own shifts as in
                libsnark (the JAX package takes d1 alone at K[m+1]: ROADMAP,
                "Known defects in the reference"),
        muA   = dauth rA_i_Z_g1 + sum_i mu_i Ain_i.
  * The verifiers (tcc:843-1160), host pairings: the symmetric one
    recomputes the MAC, muA = i g_Aau.g + sum_i lambda_i Ain_i; the public
    one checks the label signatures and prod_i e(Ain_i, Lambda_i) =
    e(muA, H) e(g_Aau.g, -i H); both then the five PGHR13 checks with
    Aacc = A0 + g_Aau.g + g_A.g.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from ..host.curves import host_curve
from ..ops import msm as msm_mod
from ..ops.field import canonical_words
from ..reductions import r1cs_to_qap as qap
from ..relations.r1cs import R1CSConstraintSystem
from ..utils.profiling import Profiler
from . import pghr13
from .ate_pairing import AtePairing
from .groth16 import _g1_proj_to_host, _g2_proj_to_host, query_point


# ---------------------------------------------------------------------------
# authentication layer
# ---------------------------------------------------------------------------

@dataclass
class PubAuthPrms:
    I1: tuple  # i G1


@dataclass
class SecAuthKey:
    i: int
    sig_sk: int
    prf_seed: bytes


@dataclass
class PubAuthKey:
    minus_i2: tuple  # -i G2
    sig_vk: tuple    # the Schnorr public key (G1)


@dataclass
class AuthKeys:
    pap: PubAuthPrms
    pak: PubAuthKey
    sak: SecAuthKey


@dataclass
class AuthData:
    mu: int
    Lambda: tuple  # lambda G2
    sigma: tuple   # the Schnorr signature (s, e)


def _prf(seed: bytes, label: bytes, r_p: int) -> int:
    """HMAC-SHA512 expanded to 1024 bits, reduced mod r: a deterministic map
    from a label to Fr (the reference's prfCompute)."""
    h1 = hmac.new(seed, b"\x00" + label, hashlib.sha512).digest()
    h2 = hmac.new(seed, b"\x01" + label, hashlib.sha512).digest()
    return int.from_bytes(h1 + h2, "little") % r_p


def _sig_hash(label: bytes, Lambda, r_pt, r_p: int) -> int:
    """SHA-512 of the label, Lambda's coordinates and R's x, 96 bytes each,
    mod r."""
    enc = label
    for comp in (Lambda[0] + Lambda[1] if Lambda else ()):  # G2 coordinates
        enc += int(comp).to_bytes(96, "little")
    enc += int(r_pt[0]).to_bytes(96, "little")
    return int.from_bytes(hashlib.sha512(enc).digest(), "little") % r_p


class _Schnorr:
    """Label signatures over the curve's G1 (the reference's sigGen, sigSign,
    sigVerif and sigBatchVerif)."""

    def __init__(self, hc):
        self.hc = hc
        self.r = hc.fr_spec.p

    def keygen(self, rng):
        sk = rng.randrange(1, self.r)
        return sk, self.hc.g1.mul(sk, self.hc.g1_gen)

    def sign(self, sk: int, label: bytes, Lambda, rng):
        k = rng.randrange(1, self.r)
        R = self.hc.g1.mul(k, self.hc.g1_gen)
        e = _sig_hash(label, Lambda, R, self.r)
        return ((k - sk * e) % self.r, e)

    def verify(self, vk, label: bytes, Lambda, sig) -> bool:
        s, e = sig
        R = self.hc.g1.add(self.hc.g1.mul(s, self.hc.g1_gen), self.hc.g1.mul(e, vk))
        return _sig_hash(label, Lambda, R, self.r) == e

    def batch_verify(self, vk, labels, Lambdas, sigs) -> bool:
        return all(self.verify(vk, lb, L, sg) for lb, L, sg in zip(labels, Lambdas, sigs))


def auth_generator(model, rng) -> AuthKeys:
    """r1cs_ppzkadsnark_auth_generator (tcc:378-390), drawing from ``rng`` in
    the JAX package's order: the signature key, the 256-bit PRF seed, i."""
    hc = host_curve(model.name)
    sig_sk, sig_vk = _Schnorr(hc).keygen(rng)
    seed = rng.randrange(1 << 256).to_bytes(32, "little")
    i = rng.randrange(1, hc.fr_spec.p)
    return AuthKeys(pap=PubAuthPrms(I1=hc.g1.mul(i, hc.g1_gen)),
                    pak=PubAuthKey(minus_i2=hc.g2.neg(hc.g2.mul(i, hc.g2_gen)), sig_vk=sig_vk),
                    sak=SecAuthKey(i=i, sig_sk=sig_sk, prf_seed=seed))


def auth_sign(model, values, sak: SecAuthKey, labels, rng) -> list:
    """r1cs_ppzkadsnark_auth_sign (tcc:392-411): for each value, mu = lambda
    + i v with Lambda and the label's signature (which draws its k)."""
    hc = host_curve(model.name)
    sch = _Schnorr(hc)
    r_p = hc.fr_spec.p
    out = []
    for v, label in zip(values, labels):
        lam = _prf(sak.prf_seed, label, r_p)
        Lambda = hc.g2.mul(lam, hc.g2_gen)
        sigma = sch.sign(sak.sig_sk, label, Lambda, rng)
        out.append(AuthData(mu=(lam + sak.i * v) % r_p, Lambda=Lambda, sigma=sigma))
    return out


def auth_verify_sym(model, values, auth_data, sak: SecAuthKey, labels) -> bool:
    """tcc:415-429: each mu against the PRF and the secret i."""
    r_p = host_curve(model.name).fr_spec.p
    return all(ad.mu == (_prf(sak.prf_seed, lb, r_p) + sak.i * v) % r_p
               for v, ad, lb in zip(values, auth_data, labels))


def auth_verify_pub(model, values, auth_data, pak: PubAuthKey, labels) -> bool:
    """tcc:433-447: Lambda - v (-i H) = mu H, and the label's signature."""
    hc = host_curve(model.name)
    sch = _Schnorr(hc)
    ok = True
    for v, ad, lb in zip(values, auth_data, labels):
        Mup = hc.g2.add(ad.Lambda, hc.g2.neg(hc.g2.mul(v, pak.minus_i2)))
        ok &= hc.g2.mul(ad.mu, hc.g2_gen) == Mup
        ok &= sch.verify(pak.sig_vk, lb, ad.Lambda, ad.sigma)
    return ok


# ---------------------------------------------------------------------------
# keys and proof
# ---------------------------------------------------------------------------

@dataclass
class ProvingKey:
    """r1cs_ppzkadsnark_proving_key: each query as affine (x, y) Montgomery
    word tensors on the model's device, the identity as y = 0; a knowledge
    commitment as its g and h halves; rA_i_Z_g1 host affine."""

    curve: str
    A_query_g: tuple   # (x, y), each (24, m + 2); rows 1..l are the inputs'
    A_query_h: tuple
    B_query_g: tuple   # G2: (x, y), each (deg, 24, m + 2)
    B_query_h: tuple
    C_query_g: tuple
    C_query_h: tuple
    H_query: tuple     # (24, n + 1)
    K_query: tuple     # (24, m + 4)
    rA_i_Z_g1: tuple
    constraint_system: R1CSConstraintSystem


@dataclass
class VerificationKey:
    """r1cs_ppzkadsnark_verification_key, host affine."""

    curve: str
    alphaA_g2: tuple
    alphaB_g1: tuple
    alphaC_g2: tuple
    gamma_g2: tuple
    gamma_beta_g1: tuple
    gamma_beta_g2: tuple
    rC_Z_g2: tuple
    A0: tuple
    Ain: list


@dataclass
class Proof:
    """(g_A, g_B, g_C knowledge commitments, g_H, g_K, g_Aau, muA), host
    affine integers."""

    g_A: tuple
    g_B: tuple
    g_C: tuple
    g_H: tuple
    g_K: tuple
    g_Aau: tuple
    muA: tuple


@dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


def generator(model, cs: R1CSConstraintSystem, prms: PubAuthPrms, rng,
              profiler: Profiler | None = None) -> Keypair:
    """r1cs_ppzkadsnark_generator (tcc:452-637): PGHR13's draws and queries
    (``pghr13.query_families``, drawing from ``rng`` in the JAX package's
    order: t, then alphaA, alphaB, alphaC, rA, rB, beta, gamma) without the
    IC split.  Phases: "adsnark qap instance map", "adsnark scalars",
    "adsnark G1 window table", "adsnark G2 window table", "adsnark G1
    queries (fused)", "adsnark B query (G2)", "adsnark vk singles"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    hc = host_curve(model.name)
    queries, secrets = pghr13.query_families(model, cs, rng, prof, "adsnark", ic_split=False)
    Ag = queries["A_query_g"]
    prof.enter_block("adsnark vk singles")
    vk = VerificationKey(curve=model.name, **pghr13.verification_singles(model, secrets),
                         A0=query_point(model, Ag, 0),
                         Ain=[query_point(model, Ag, i) for i in range(1, secrets["l"] + 1)])
    rA_i_Z_g1 = hc.g1.mul(secrets["rA"] * secrets["Zt"] % hc.fr_spec.p, prms.I1)
    prof.leave_block("adsnark vk singles")
    return Keypair(ProvingKey(curve=model.name, **queries, rA_i_Z_g1=rA_i_Z_g1,
                              constraint_system=cs), vk)


def prover(model, pk: ProvingKey, primary, auxiliary, auth_data, rng,
           profiler: Profiler | None = None) -> Proof:
    """r1cs_ppzkadsnark_prover (tcc:641-820), drawing d1, d2, d3 and dauth
    from ``rng`` (each ``rng.randrange(r)``), as the JAX package does; the
    primary inputs are the authenticated values, ``auth_data`` their
    ``auth_sign`` output.  An assignment that does not satisfy the key's
    constraints raises ValueError.  Phases: "adsnark qap witness map",
    "adsnark G1 multiexps", "adsnark G2 multiexp", "adsnark assemble proof
    (host)"."""
    prof = profiler if profiler is not None else Profiler(model.device, verbose=False)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    cs = pk.constraint_system
    r_p = Fr.p
    l, m = cs.primary_input_size, cs.num_variables
    if not cs.is_satisfied(primary, auxiliary):
        raise ValueError("the assignment does not satisfy the constraint system")
    d1, d2, d3, dauth = (rng.randrange(r_p) for _ in range(4))

    prof.enter_block("adsnark qap witness map")
    full, H = qap.witness_map(model, cs, primary, auxiliary, (d1 + dauth) % r_p, d2, d3)
    w_all = canonical_words(Fr, [v % r_p for v in full])
    w_aux, w_in = w_all.clone(), w_all.clone()
    w_aux[:, :l] = 0  # the auxiliary rows, the inputs zeroed
    w_in[:, l:] = 0   # the input rows alone
    h_can = Fr.to_canonical(H)
    del H, full
    prof.leave_block("adsnark qap witness map")

    # nine families over variables 1..m, and H over its n + 1 coefficients
    prof.enter_block("adsnark G1 multiexps")
    body = lambda pair: G1.from_affine(*(c[:, 1 : m + 1] for c in pair))
    Ag, Ah = body(pk.A_query_g), body(pk.A_query_h)
    pts, scal = msm_mod.pad_and_stack(
        G1, [Ag, Ah, Ag, Ah, body(pk.B_query_h), body(pk.C_query_g), body(pk.C_query_h),
             body(pk.K_query), G1.from_affine(*pk.H_query)],
        [w_aux, w_aux, w_in, w_in, w_all, w_all, w_all, w_all, h_can])
    del Ag, Ah, h_can, w_aux, w_in
    res9 = msm_mod.msm_multi_staged(G1, pts, scal)
    del pts, scal
    prof.leave_block("adsnark G1 multiexps")
    prof.enter_block("adsnark G2 multiexp")
    res2 = msm_mod.msm_staged(G2, G2.from_affine(*(c[..., 1 : m + 1] for c in pk.B_query_g)),
                              w_all)
    prof.leave_block("adsnark G2 multiexp")

    prof.enter_block("adsnark assemble proof (host)")
    hc = host_curve(model.name)
    g1, g2 = hc.g1, hc.g2
    Aaux_g, Aaux_h, Ain_g, Ain_h, Bh_m, Cg_m, Ch_m, K_m, H_m = (
        _g1_proj_to_host(model, tuple(c[..., i] for c in res9)) for i in range(9))
    Bg_m = _g2_proj_to_host(model, res2)
    q = lambda pair, i: query_point(model, pair, i)

    def kc_half(group, pair, msm, d):
        """pair[0] + d pair[m + 1] + msm."""
        return group.add(group.add(q(pair, 0), group.mul(d, q(pair, m + 1))), msm)

    AZg, AZh = q(pk.A_query_g, m + 1), q(pk.A_query_h, m + 1)
    # g_A: the auxiliary rows and d1 times the Z row, no row-0 term (tcc:659);
    # g_Aau: the input rows and dauth times the Z row
    g_A = (g1.add(g1.mul(d1, AZg), Aaux_g), g1.add(g1.mul(d1, AZh), Aaux_h))
    g_Aau = (g1.add(g1.mul(dauth, AZg), Ain_g), g1.add(g1.mul(dauth, AZh), Ain_h))
    g_B = (kc_half(g2, pk.B_query_g, Bg_m, d2), kc_half(g1, pk.B_query_h, Bh_m, d2))
    g_C = (kc_half(g1, pk.C_query_g, Cg_m, d3), kc_half(g1, pk.C_query_h, Ch_m, d3))
    # K's Z rows take the witness map's shifts, d1 + dauth first (libsnark's
    # qap_wit.d1); the JAX package takes d1 there (adsnark.py:520), and its
    # proofs then fail the same-coefficients check
    g_K = K_m
    for d, row in ((d1 + dauth, m + 1), (d2, m + 2), (d3, m + 3)):
        g_K = g1.add(g_K, g1.mul(d, q(pk.K_query, row)))
    g_K = g1.add(g_K, q(pk.K_query, 0))
    # muA = dauth rA_i_Z_g1 + sum_i mu_i Ain_i (tcc:795-807)
    muA = g1.mul(dauth, pk.rA_i_Z_g1)
    for ad, Ain_i in zip(auth_data, _vk_ain(model, pk)):
        muA = g1.add(muA, g1.mul(ad.mu, Ain_i))
    prof.leave_block("adsnark assemble proof (host)")
    return Proof(g_A=g_A, g_B=g_B, g_C=g_C, g_H=H_m, g_K=g_K, g_Aau=g_Aau, muA=muA)


def _vk_ain(model, pk: ProvingKey) -> list:
    """The input rows of the A query as host points (the verification key's
    Ain)."""
    return [query_point(model, pk.A_query_g, i)
            for i in range(1, pk.constraint_system.primary_input_size + 1)]


# ---------------------------------------------------------------------------
# verifiers
# ---------------------------------------------------------------------------

def _kc_check(engine, g, h, alpha_partner) -> bool:
    """e(g, alpha) = e(h, H), a knowledge commitment over G1."""
    if g is None and h is None:
        return True
    return engine.reduced_pairing(g, alpha_partner) == engine.reduced_pairing(h, engine.hc.g2_gen)


def _snark_checks(model, vk: VerificationKey, proof: Proof) -> bool:
    """The five PGHR13-style checks with Aacc = A0 + g_Aau.g + g_A.g
    (tcc:897-1030)."""
    hc = host_curve(model.name)
    engine = AtePairing(hc)
    gt, e, one2 = engine.GT, engine.reduced_pairing, hc.g2_gen
    if not (_kc_check(engine, *proof.g_Aau, vk.alphaA_g2)
            and _kc_check(engine, *proof.g_A, vk.alphaA_g2)):
        return False
    # B: e(alphaB_g1, B.g) = e(B.h, H)
    if e(vk.alphaB_g1, proof.g_B[0]) != e(proof.g_B[1], one2):
        return False
    if not _kc_check(engine, *proof.g_C, vk.alphaC_g2):
        return False
    Aacc = hc.g1.add(hc.g1.add(vk.A0, proof.g_Aau[0]), proof.g_A[0])
    # divisibility: e(Aacc, B.g) = e(H, rC Z) e(C.g, H)
    if e(Aacc, proof.g_B[0]) != gt.mul(e(proof.g_H, vk.rC_Z_g2), e(proof.g_C[0], one2)):
        return False
    # same coefficients: e(K, gamma) = e(Aacc + C.g, gamma beta) e(gamma beta, B.g)
    return e(proof.g_K, vk.gamma_g2) == gt.mul(e(hc.g1.add(Aacc, proof.g_C[0]), vk.gamma_beta_g2),
                                               e(vk.gamma_beta_g1, proof.g_B[0]))


def verifier_sym(model, vk: VerificationKey, proof: Proof, sak: SecAuthKey, labels) -> bool:
    """The symmetric verifier (tcc:843-1035): the MAC with the secret key,
    muA = i g_Aau.g + sum_i lambda_i Ain_i, then the SNARK checks."""
    hc = host_curve(model.name)
    r_p = hc.fr_spec.p
    prodA = hc.g1.mul(sak.i, proof.g_Aau[0])
    for lb, Ain_i in zip(labels, vk.Ain):
        prodA = hc.g1.add(prodA, hc.g1.mul(_prf(sak.prf_seed, lb, r_p), Ain_i))
    if prodA != proof.muA:
        return False
    return _snark_checks(model, vk, proof)


def verifier_pub(model, vk: VerificationKey, proof: Proof, auth_data, pak: PubAuthKey,
                 labels) -> bool:
    """The public verifier (tcc:1040-1160): the label signatures and
    prod_i e(Ain_i, Lambda_i) = e(muA, H) e(g_Aau.g, -i H), then the SNARK
    checks."""
    hc = host_curve(model.name)
    if not _Schnorr(hc).batch_verify(pak.sig_vk, labels, [ad.Lambda for ad in auth_data],
                                     [ad.sigma for ad in auth_data]):
        return False
    engine = AtePairing(hc)
    gt, e = engine.GT, engine.reduced_pairing
    lhs = gt.one
    for Ain_i, ad in zip(vk.Ain, auth_data):
        lhs = gt.mul(lhs, e(Ain_i, ad.Lambda))
    if lhs != gt.mul(e(proof.muA, hc.g2_gen), e(proof.g_Aau[0], pak.minus_i2)):
        return False
    return _snark_checks(model, vk, proof)
