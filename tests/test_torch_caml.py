"""The port's caml I/O: libsnark's key and proof bytes
(``io/caml_serialization.py``) and the camlsnark_* C ABI bridge
(``io/caml_ffi.py``), against the JAX package's on the JAX tests' (5, 2)
example (tests/test_caml_serialization.py):

  * the key is the port's ``groth16_full.ProvingKey`` on the CPU, made from
    exact host points (tools/oracle.py's group law over the JAX package's
    QAP at a random t, as tests/test_torch_groth16_full.py makes its keys:
    the JAX generator compiles for minutes), the proof the port's
    ``groth16_full.prover`` on the CPU (once a test session);
  * the port's bytes of the key, the verification key and the proof equal
    the JAX functions' bytes; the JAX readers' objects, brought over with
    ``convert``, equal the port's readers' and the originals; the read-back
    verification key verifies the read-back proof;
  * ``CamlFFI`` builds its own ``libcamlsnark.so`` from ``native/`` into the
    port's ``_build/`` and hands every handle back as a ``c_void_p``;
  * ``extract`` of the chain circuit built through the C ABI equals, term for
    term, the port's and the JAX package's
    ``generate_r1cs_example_with_field_input`` on the same seed, on both
    curves' prefixes;
  * ``digest`` is the MD5 layout tests/test_caml_ffi.py computes, and
    ``r1cs_digest`` of the extracted system;
  * the native string entry points round the port's bytes (the JAX test of
    them crashes: its ``make_string`` handle is a bare int, cut to 32 bits).

Every comparison is exact."""

import ctypes
import hashlib
import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.io import caml_serialization as jax_cser
from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.proof_systems import groth16_full as jax_g16
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import examples as jax_examples
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.host.curves import host_curve
from snark_challenge_prover_tpu_torch.io import caml_ffi
from snark_challenge_prover_tpu_torch.io import caml_serialization as cser
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as port_g16
from snark_challenge_prover_tpu_torch.proof_systems.ate_pairing import AtePairing
from snark_challenge_prover_tpu_torch.relations import examples as port_examples
from chip_smoke import caml_chain_circuit
from test_torch_keygen import _once
from tools import oracle as orc

torch.set_num_threads(1)

CURVE = "MNT4753"
NUM_CONSTRAINTS, NUM_INPUTS, SEED = 5, 2, 42  # tests/test_caml_serialization.py's example


def build_keys():
    """The JAX key pair of the (5, 2) example from exact host points, and the
    port's copies on the CPU."""
    cur = orc.ORACLES[CURVE]()
    model = jax_mnt4753.get()
    p, spec = model.Fr.p, model.Fq.spec
    rng = random.Random(SEED)
    ex = jax_examples.generate_r1cs_example_with_field_input(p, NUM_CONSTRAINTS, NUM_INPUTS, rng)
    cs = ex.constraint_system
    cs.swap_AB_if_beneficial()
    t, alpha, beta, delta, g1s = (rng.randrange(1, p) for _ in range(5))
    dinv = pow(delta, -1, p)
    inst = jax_qap.instance_map_with_evaluation(cs, t, model.Fr)
    n, nin = inst.domain_size, inst.num_inputs
    abc = [(beta * a + alpha * b + c) % p for a, b, c in zip(inst.At, inst.Bt, inst.Ct)]
    g1b = cur.g1.mul(g1s, cur.g1_gen)
    g1 = lambda scalars: [cur.g1.mul(v, g1b) for v in scalars]
    planes = lambda values: ints_to_limbs([spec.to_mont(v) for v in values])
    g1_pair = lambda pts: (planes([0 if P is None else P[0] for P in pts]),
                           planes([0 if P is None else P[1] for P in pts]))

    def g2_pair(pts):
        comps = lambda k: np.stack([planes([0 if P is None else P[k][c] for P in pts])
                                    for c in range(cur.ext_deg)])
        return comps(0), comps(1)

    alpha_g1, beta_g2 = cur.g1.mul(alpha, g1b), cur.g2.mul(beta, cur.g2_gen)
    jpk = jax_g16.ProvingKey(
        curve=CURVE, alpha_g1=alpha_g1, beta_g1=cur.g1.mul(beta, g1b), beta_g2=beta_g2,
        delta_g1=cur.g1.mul(delta, g1b), delta_g2=cur.g2.mul(delta, cur.g2_gen),
        A_query=g1_pair(g1(inst.At)),
        B_query_g2=g2_pair([cur.g2.mul(v, cur.g2_gen) for v in inst.Bt]),
        B_query_g1=g1_pair(g1(inst.Bt)),
        H_query=g1_pair(g1([inst.Zt * dinv * h % p for h in inst.Ht[: n - 1]])),
        L_query=g1_pair(g1([v * dinv % p for v in abc[nin + 1 :]])), constraint_system=cs)
    gt = AtePairing(host_curve(CURVE)).reduced_pairing(alpha_g1, beta_g2)
    jvk = jax_g16.VerificationKey(curve=CURVE, alpha_g1_beta_g2=gt, delta_g2=jpk.delta_g2,
                                  ABC_g1=g1(abc[: nin + 1]))
    return {"ex": ex, "jpk": jpk, "jvk": jvk, "pk": convert.proving_key_from_jax(jpk, "cpu"),
            "vk": convert.verification_key_from_jax(jvk)}


_KEYS = {}


def keys():
    if not _KEYS:
        _KEYS.update(build_keys())
    return _KEYS


def _prove():
    k = keys()
    return port_g16.prover(mnt4753.get("cpu"), k["pk"], k["ex"].primary_input,
                           k["ex"].auxiliary_input, random.Random(SEED + 1))


@pytest.fixture(scope="module")
def proof(tmp_path_factory):
    """The port's CPU prove of the key, once a test session."""
    return _once(tmp_path_factory, "caml-prove-5-2", lambda d: _prove())[1]


def same_cs(a, b) -> bool:
    return ((a.p, a.primary_input_size, a.auxiliary_input_size)
            == (b.p, b.primary_input_size, b.auxiliary_input_size)
            and [(c.a.terms, c.b.terms, c.c.terms, c.is_square) for c in a.constraints]
            == [(c.a.terms, c.b.terms, c.c.terms, c.is_square) for c in b.constraints])


def same_pk(a, b) -> bool:
    singles = ("curve", "alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")
    queries = ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query")
    return (all(getattr(a, k) == getattr(b, k) for k in singles)
            and all(torch.equal(x, y) for k in queries
                    for x, y in zip(getattr(a, k), getattr(b, k)))
            and same_cs(a.constraint_system, b.constraint_system))


def test_proving_key_bytes_equal_jax():
    k = keys()
    data = cser.proving_key_to_bytes(k["pk"])
    assert data == jax_cser.proving_key_to_bytes(k["jpk"])
    jax_read = jax_cser.proving_key_from_bytes(CURVE, data)
    assert jax_cser.proving_key_to_bytes(jax_read) == data
    port_read = cser.proving_key_from_bytes(CURVE, data, "cpu")
    assert same_pk(port_read, convert.proving_key_from_jax(jax_read, "cpu"))
    assert same_pk(port_read, k["pk"])
    assert cser.proving_key_to_bytes(port_read) == data


def test_verification_key_bytes_equal_jax():
    k = keys()
    data = cser.verification_key_to_bytes(k["vk"])
    assert data == jax_cser.verification_key_to_bytes(k["jvk"])
    jax_read = jax_cser.verification_key_from_bytes(CURVE, data)
    port_read = cser.verification_key_from_bytes(CURVE, data)
    assert port_read == convert.verification_key_from_jax(jax_read) == k["vk"]


def test_proof_bytes_equal_jax(proof):
    k = keys()
    data = cser.proof_to_bytes_caml(CURVE, proof)
    jax_proof = jax_g16.Proof(g_A=proof.g_A, g_B=proof.g_B, g_C=proof.g_C)
    assert data == jax_cser.proof_to_bytes_caml(CURVE, jax_proof)
    port_read = cser.proof_from_bytes_caml(CURVE, data)
    assert port_read == convert.proof_from_jax(jax_cser.proof_from_bytes_caml(CURVE, data)) == proof
    vk = cser.verification_key_from_bytes(CURVE, cser.verification_key_to_bytes(k["vk"]))
    assert port_g16.verifier_strong_IC(vk, k["ex"].primary_input, port_read)


def test_identity_points_are_flagged_with_y_one():
    """The port stores the identity as (0, 0); libsnark's bytes hold '1',
    x = 0 and y = Montgomery 1, the JAX writer's bytes for None."""
    k = keys()
    spec = host_curve(CURVE).fq_spec
    x, y = (torch.zeros((24, 2), dtype=torch.int32) for _ in range(2))
    x[:, 1], y[:, 1] = k["pk"].A_query[0][:, 0], k["pk"].A_query[1][:, 0]
    w = cser.Writer()
    cser._write_vector(w, spec, (x, y))
    jw = jax_cser.Writer()
    jw.size(2)
    jw.g1(spec, None)
    jw.g1(spec, cser.Reader(w.bytes()[2 + 193 :]).g1(spec))
    assert w.bytes() == jw.bytes()
    assert w.bytes()[2:3] == b"1" and w.bytes()[3 + 96 : 3 + 192] == spec.to_mont(1).to_bytes(96, "little")


def test_reading_a_key_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default is checked where there is no card: reading raises")
    data = cser.proving_key_to_bytes(keys()["pk"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cser.proving_key_from_bytes(CURVE, data)


def test_library_is_built_from_native_into_the_port():
    path = caml_ffi.build()
    assert path.parent == caml_ffi.PKG / "_build" and path.name.startswith("libcamlsnark-")
    assert path == caml_ffi.library_path() and path.exists()
    assert caml_ffi.load()._name == str(path)
    assert caml_ffi.NATIVE == caml_ffi.PKG.parent / "native"


@pytest.mark.parametrize("curve,model", [("MNT4753", mnt4753), ("MNT6753", mnt6753)])
def test_both_prefixes_extract_the_chain_example(curve, model):
    ffi = caml_ffi.CamlFFI(curve)
    p = model.get("cpu").Fr.p
    assert ffi.prefix == f"camlsnark_{curve.lower()}" and ffi.modulus() == p
    spare = ffi.protoboard()
    assert isinstance(spare.pb, ctypes.c_void_p) and isinstance(spare.allocate(), ctypes.c_void_p)
    pb = caml_chain_circuit(ffi, NUM_CONSTRAINTS, NUM_INPUTS, random.Random(SEED))
    cs, primary, aux = pb.extract()
    port = port_examples.generate_r1cs_example_with_field_input(p, NUM_CONSTRAINTS, NUM_INPUTS,
                                                                random.Random(SEED))
    jax_ex = jax_examples.generate_r1cs_example_with_field_input(p, NUM_CONSTRAINTS, NUM_INPUTS,
                                                                 random.Random(SEED))
    assert same_cs(cs, port.constraint_system)
    assert same_cs(cs, convert.r1cs_from_reference(jax_ex.constraint_system))
    assert (primary, aux) == (port.primary_input, port.auxiliary_input)
    assert (primary, aux) == (jax_ex.primary_input, jax_ex.auxiliary_input)
    assert pb.digest() == caml_ffi.r1cs_digest(cs)


def test_digest_matches_the_reference_layout():
    """x (primary) = a * b: tests/test_caml_ffi.py's MD5 over (size_t
    index, 96-byte canonical coefficient) a term."""
    ffi = caml_ffi.CamlFFI(CURVE)
    pb = ffi.protoboard()
    x, a, b = pb.allocate(), pb.allocate(), pb.allocate()
    pb.set_input_sizes(1)
    for var, val in ((a, 37), (b, 11), (x, 37 * 11)):
        pb.set(var, val)
    pb.add_constraint(pb.lc([(1, a)]), pb.lc([(1, b)]), pb.lc([(1, x)]))
    h = hashlib.md5()
    for idx in (2, 3, 1):
        h.update(idx.to_bytes(8, "little"))
        h.update((1).to_bytes(96, "little"))
    assert pb.digest() == h.digest()
    cs, primary, aux = pb.extract()
    assert caml_ffi.r1cs_digest(cs) == h.digest()
    assert (primary, aux) == ([37 * 11], [37, 11]) and pb.get(x) == 37 * 11


def test_native_string_entry_points_round_the_bytes(proof):
    """The camlsnark_* string entry points give the port's bytes back, and
    the port reads them into equal objects."""
    k = keys()
    ffi = caml_ffi.CamlFFI(CURVE)
    handle = ffi.make_string(b"\x00\xffbytes")
    assert isinstance(handle, ctypes.c_void_p)
    assert ffi.read_string(handle) == b"\x00\xffbytes"
    pk_bytes = cser.proving_key_to_bytes(k["pk"])
    assert ffi.proving_key_to_string(k["pk"]) == pk_bytes
    assert same_pk(ffi.proving_key_of_string(pk_bytes, "cpu"), k["pk"])
    vk_bytes = cser.verification_key_to_bytes(k["vk"])
    assert ffi.verification_key_to_string(k["vk"]) == vk_bytes
    assert ffi.verification_key_of_string(vk_bytes) == k["vk"]
    proof_bytes = cser.proof_to_bytes_caml(CURVE, proof)
    assert ffi.proof_to_string(proof) == proof_bytes
    assert ffi.proof_of_string(proof_bytes) == proof
