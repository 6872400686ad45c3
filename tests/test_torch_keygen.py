"""The port's key generator on device="cpu" at d + 1 = 8, both curves.

``cli_generate_parameters.main`` with ``--curve <curve> --seed 42
--device cpu``, once a curve for all parallel workers: each curve's two
files must be byte for byte what the JAX package's generator writes for
that seed.  The expected bytes are built here from the JAX package's host
functions replaying the seed (``relations.examples``,
``swap_AB_if_beneficial``, ``r1cs_to_qap.instance_map_with_evaluation`` and
``assemble_abc_evaluations``) and tools/oracle.py's exact group law, laid
out as the JAX package's ``cli_generate_parameters.py:50-96`` writes them;
the JAX generator itself is not run (its fixed-base programs compile for
minutes).  The port's verification key (``verification_key`` of the
proving key and secrets that the command's ``proving_key`` made) is held
to the JAX package's ``AtePairing`` on the same points, and the port's
prover must prove the generated MNT4753 files to tools/oracle.py's bytes,
as tests/test_generate_parameters.py holds the JAX prover.
``convert.proving_key_from_jax`` is checked on a JAX ``ProvingKey``
assembled by hand from host points."""

import fcntl
import hashlib
import io
import os
import random
import struct

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.host.curves import host_curve as jax_host_curve
from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.proof_systems import groth16_full as jax_g16
from snark_challenge_prover_tpu.proof_systems.ate_pairing import AtePairing as JaxAtePairing
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import examples as jax_examples
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs
from snark_challenge_prover_tpu_torch import cli_generate_parameters as port_cli
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as port_g16
from snark_challenge_prover_tpu_torch.proof_systems.groth16 import ChallengeProver
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

LOG2D, SEED = 3, 42
CURVES = ("MNT4753", "MNT6753")
JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}


def _replay(name: str, rng):
    """The JAX generator's files and secrets for one curve, by its host
    functions and exact integers."""
    cur = orc.ORACLES[name]()
    Fr = JAX_MODELS[name].get().Fr
    p = Fr.p
    d = (1 << LOG2D) - 1
    ex = jax_examples.generate_r1cs_example_with_field_input(p, d - 1, 1, rng)
    cs = ex.constraint_system
    cs.swap_AB_if_beneficial()
    t, alpha, beta, delta = (rng.randrange(1, p) for _ in range(4))
    dinv = pow(delta, -1, p)
    inst = jax_qap.instance_map_with_evaluation(cs, t, Fr)
    n, m, nin = inst.domain_size, inst.num_variables, inst.num_inputs
    ABC = [(beta * inst.At[i] + alpha * inst.Bt[i] + inst.Ct[i]) % p for i in range(m + 1)]
    Lt = [v * dinv % p for v in ABC[nin + 1 :]]
    Hs = [inst.Zt * dinv * h % p for h in inst.Ht[: n - 1]]
    g1_scalar = rng.randrange(1, p)
    g1b = cur.g1.mul(g1_scalar, cur.g1_gen)

    params = io.BytesIO()
    params.write(struct.pack("<QQ", d, m))
    for scalars in (inst.At, inst.Bt):
        for s in scalars:
            orc.write_g1(params, cur, cur.g1.mul(s, g1b))
    for s in inst.Bt:
        orc.write_g2(params, cur, cur.g2.mul(s, cur.g2_gen))
    for scalars in (Lt, Hs):
        for s in scalars:
            orc.write_g1(params, cur, cur.g1.mul(s, g1b))

    aA, aB, aC = jax_qap.assemble_abc_evaluations(cs, ex.primary_input, ex.auxiliary_input, Fr)
    r = rng.randrange(p)
    inp = io.BytesIO()
    for v in [1] + ex.primary_input + ex.auxiliary_input + aA + aB + aC + [r]:
        orc.write_mont(inp, p, v)
    return {"params": params.getvalue(), "input": inp.getvalue(), "alpha": alpha, "beta": beta,
            "delta": delta, "g1b": g1b, "ABC": ABC[: nin + 1], "cur": cur}


def _once(tmp_path_factory, key: str, make):
    """make(directory) run once in a test session, whichever of the
    parallel workers asks first: it runs under a lock in a directory that
    all workers share, and its pickled result is read back by every later
    caller, so the other workers wait for it instead of running it again."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the workers' basetemps share this parent
    out, done = root / key, root / f"{key}.pt"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            out.mkdir(exist_ok=True)
            torch.save(make(out), root / f"{key}.tmp")
            os.replace(root / f"{key}.tmp", done)
    return out, torch.load(done, weights_only=False)


def _generate(name, out):
    """The command line for one curve; the proving key and secrets that its
    ``proving_key`` returned, by a spy."""
    made = []

    def spy(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    real = port_cli.proving_key
    flag = "--log2d-mnt4" if name == "MNT4753" else "--log2d-mnt6"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cli, "proving_key", spy)
        assert port_cli.main(["--curve", name, flag, str(LOG2D), "--seed", str(SEED),
                              "--outdir", str(out), "--device", "cpu"]) == 0
    (pk_and_secrets,) = made
    return pk_and_secrets


_GENERATED = {}


def _generated(tmp_path_factory, name):
    """One curve's files from the command line at d + 1 = 8 with the seed
    (made once for all workers), its proving key and secrets, and the JAX
    generator's files, replayed."""
    if name not in _GENERATED:
        out, (pk, secrets) = _once(tmp_path_factory, f"keygen-{name}",
                                   lambda d: _generate(name, d))
        _GENERATED[name] = {"dir": out, "pk": pk, "secrets": secrets,
                            "want": _replay(name, random.Random(SEED))}
    return _GENERATED[name]


@pytest.mark.parametrize("name", CURVES)
def test_params_file_is_the_jax_generators(tmp_path_factory, name):
    generated = _generated(tmp_path_factory, name)
    assert (generated["dir"] / f"{name}-parameters").read_bytes() == generated["want"]["params"]


@pytest.mark.parametrize("name", CURVES)
def test_input_file_is_the_jax_generators(tmp_path_factory, name):
    generated = _generated(tmp_path_factory, name)
    assert (generated["dir"] / f"{name}-input").read_bytes() == generated["want"]["input"]


@pytest.mark.parametrize("name", CURVES)
def test_keys_are_the_jax_generators(tmp_path_factory, name):
    """The proving key's single points and the verification key that
    ``verification_key`` makes of it, the pairing by the JAX package's
    AtePairing."""
    generated = _generated(tmp_path_factory, name)
    want = generated["want"]
    pk = generated["pk"]
    vk = port_g16.verification_key(pk, generated["secrets"])
    cur, g1b = want["cur"], want["g1b"]
    alpha_g1 = cur.g1.mul(want["alpha"], g1b)
    beta_g2 = cur.g2.mul(want["beta"], cur.g2_gen)
    delta_g2 = cur.g2.mul(want["delta"], cur.g2_gen)
    assert pk.curve == vk.curve == name
    assert pk.alpha_g1 == alpha_g1
    assert pk.beta_g1 == cur.g1.mul(want["beta"], g1b)
    assert pk.beta_g2 == beta_g2
    assert pk.delta_g1 == cur.g1.mul(want["delta"], g1b)
    assert pk.delta_g2 == vk.delta_g2 == delta_g2
    assert vk.ABC_g1 == [cur.g1.mul(v, g1b) for v in want["ABC"]]
    engine = JaxAtePairing(jax_host_curve(name))
    assert vk.alpha_g1_beta_g2 == engine.reduced_pairing(alpha_g1, beta_g2)


@pytest.mark.parametrize("name", ["MNT4753"])
def test_port_proves_the_generated_files_as_the_oracle(tmp_path_factory, name):
    """MNT4753's files only: a CPU prove of MNT6753 takes longer than its
    whole generation, and the port's MNT6753 prover is held to the oracle
    on the committed fixture (tests/test_torch_prover.py) and to exact
    integers on its generated files at full size (chip_smoke.py)."""
    from test_generate_parameters import _parse_with_oracle

    generated = _generated(tmp_path_factory, name)
    pp = generated["dir"] / f"{name}-parameters"
    ip = generated["dir"] / f"{name}-input"
    cur = generated["want"]["cur"]
    params, inputs = _parse_with_oracle(cur, pp, ip)
    want = orc.prove(cur, params, inputs)
    got = ChallengeProver(PORT_MODELS[name].get("cpu"), verbose=False).prove_files(str(pp), str(ip))
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest()


def test_generator_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--curve", "MNT4753", "--log2d-mnt4", "3", "--outdir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", CURVES)
def test_proving_key_from_jax(name):
    """A JAX ProvingKey of host points (one identity per query) -> the
    port's: the same affine words, singles and constraints."""
    cur = orc.ORACLES[name]()
    spec = JAX_MODELS[name].get().Fq.spec
    deg = cur.ext_deg
    g1 = [None] + [cur.g1.mul(k, cur.g1_gen) for k in (1, 2, 5)]
    g2 = [None] + [cur.g2.mul(k, cur.g2_gen) for k in (1, 3)]

    def planes(coords):
        return ints_to_limbs([spec.to_mont(v) for v in coords])

    def g1_pair(pts):
        return (planes([0 if P is None else P[0] for P in pts]),
                planes([0 if P is None else P[1] for P in pts]))

    def g2_pair(pts):
        comps = lambda k: np.stack([planes([0 if P is None else P[k][c] for P in pts])
                                    for c in range(deg)])
        return comps(0), comps(1)

    ex = jax_examples.generate_r1cs_example_with_field_input(cur.fr_spec.p, 4, 1, random.Random(3))
    ref = jax_g16.ProvingKey(curve=name, alpha_g1=g1[1], beta_g1=g1[2], beta_g2=g2[1],
                             delta_g1=g1[3], delta_g2=g2[2], A_query=g1_pair(g1),
                             B_query_g2=g2_pair(g2), B_query_g1=g1_pair(g1[::-1]),
                             H_query=g1_pair(g1[:2]), L_query=g1_pair(g1[1:]),
                             constraint_system=ex.constraint_system)
    pk = convert.proving_key_from_jax(ref, "cpu")
    for key, pts in (("A_query", g1), ("B_query_g1", g1[::-1]), ("H_query", g1[:2]),
                     ("L_query", g1[1:])):
        for k, coord in enumerate(getattr(pk, key)):
            assert coord.dtype == torch.int32 and coord.device.type == "cpu"
            want = _mont_words([0 if P is None else P[k] for P in pts], spec)
            assert np.array_equal(coord.numpy(), want), key
    for k, coord in enumerate(pk.B_query_g2):
        for c in range(deg):
            want = _mont_words([0 if P is None else P[k][c] for P in g2], spec)
            assert np.array_equal(coord[c].numpy(), want)
    assert (pk.curve, pk.alpha_g1, pk.beta_g1, pk.beta_g2, pk.delta_g1, pk.delta_g2) == (
        name, g1[1], g1[2], g2[1], g1[3], g2[2])
    got_cs, ref_cs = pk.constraint_system, ex.constraint_system
    assert (got_cs.p, got_cs.primary_input_size, got_cs.auxiliary_input_size) == (
        ref_cs.p, ref_cs.primary_input_size, ref_cs.auxiliary_input_size)
    for a, b in zip(got_cs.constraints, ref_cs.constraints, strict=True):
        assert (a.a.terms, a.b.terms, a.c.terms, a.is_square) == (
            b.a.terms, b.b.terms, b.c.terms, b.is_square)


def _mont_words(values, spec):
    """Canonical ints -> Montgomery int32 words (24, n), independently of convert."""
    buf = b"".join(spec.to_mont(v).to_bytes(96, "little") for v in values)
    return np.frombuffer(buf, "<u4").reshape(-1, 24).T.astype(np.uint32).view(np.int32)
