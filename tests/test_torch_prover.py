"""The port's challenge prover on device="cpu": MNT4753 and MNT6753, d + 1 = 8.

The proof bytes must have the sha256 of tools/oracle.py's ``prove`` on the
same fixture, which is what the JAX package itself is held to
(tests/test_e2e.py).  The fixture is read once with each package's reader
and both must give the same tensors (``convert``).  MNT4753 is proved
through ``prove_files``, MNT6753 through the command line's ``main`` with
``--device cpu`` on the committed fixture.  MNT4753 is also proved through
``prove_files`` at d + 1 = 12 (a step radix-2 domain) and 7 (a geometric
sequence domain), which tools/oracle.py does not serve: there the proof
bytes are built here, with the oracle's group law, from the quotient H that
exact interpolation on the domain's points gives."""

import hashlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.io import serialization as jax_ser
from snark_challenge_prover_tpu_torch import cli, convert
from snark_challenge_prover_tpu_torch.io import serialization as port_ser
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.proof_systems.groth16 import ChallengeProver
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

LOG2D = 3
TESTDATA = Path(cli.__file__).parent / "testdata"


def _oracle_fixture(curve, base):
    """Fresh oracle fixture (seed 11, as tests/test_e2e.py) written to files."""
    cur, params, inputs = orc.generate_fixture(curve, LOG2D, seed=11)
    paths = {k: base / f"{curve}-{LOG2D}.{k}" for k in ("params", "input", "output")}
    orc.write_params_file(paths["params"], cur, params)
    orc.write_input_file(paths["input"], cur, inputs)
    paths["output"].write_bytes(orc.prove(cur, params, inputs))
    return paths


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _oracle_fixture("MNT4753", tmp_path_factory.mktemp("mnt4753"))


@pytest.fixture(scope="module")
def fixture6(tmp_path_factory):
    return _oracle_fixture("MNT6753", tmp_path_factory.mktemp("mnt6753"))


def test_committed_fixture_is_the_oracles(fixture):
    for k in ("params", "input", "output"):
        assert (TESTDATA / f"MNT4753-{LOG2D}.{k}").read_bytes() == fixture[k].read_bytes(), k


def test_readers_agree_through_convert(fixture):
    _check_readers(fixture, 2)


def test_mnt6753_readers_agree_through_convert(fixture6):
    _check_readers(fixture6, 3)


def _check_readers(fixture, deg):
    ref_p = jax_ser.read_params_bytes(fixture["params"].read_bytes(), deg)
    ref_i = jax_ser.read_input_bytes(fixture["input"].read_bytes(), ref_p.d, ref_p.m)
    got_p = port_ser.read_params(fixture["params"], deg)
    got_i = port_ser.read_input(fixture["input"], got_p.d, got_p.m)
    conv_p, conv_i = convert.params_from_reference(ref_p), convert.input_from_reference(ref_i)
    assert (got_p.d, got_p.m) == (conv_p.d, conv_p.m) == ((1 << LOG2D) - 1, (1 << LOG2D) + 2)
    for k in ("A", "B1", "B2", "L", "H"):
        for got, conv, ref in zip(getattr(got_p, k), getattr(conv_p, k), getattr(ref_p, k)):
            np.testing.assert_array_equal(got, conv)
            t = convert.tensor_from_planes(ref, "cpu")
            np.testing.assert_array_equal(t.numpy(), got)
            np.testing.assert_array_equal(convert.planes_from_port(t), ref)
    assert got_p.B2[0].shape == (deg, 24, got_p.m + 1)
    for k in ("w", "ca", "cb", "cc", "r"):
        np.testing.assert_array_equal(getattr(got_i, k), getattr(conv_i, k))


def test_prove_files_byte_exact(fixture, tmp_path):
    prover = ChallengeProver(mnt4753.get("cpu"), msm_window=4, verbose=False)
    out = tmp_path / "proof"
    got = prover.prove_files(fixture["params"], fixture["input"], out)
    want = fixture["output"].read_bytes()
    assert out.read_bytes() == got and len(got) == 768
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest(), (
        "proof bytes differ from the oracle's")
    # the phases the reference binary reports were all timed
    assert {"load params", "load inputs", "compute H", "G1 multiexp x4", "G2 multiexp",
            "assemble proof (host)", "store"} <= set(prover.profiler.cumulative)


def test_compute_h_from_converted_reference_state(fixture):
    _check_compute_h(fixture, "MNT4753", mnt4753.get("cpu"))


def test_mnt6753_compute_h_from_converted_reference_state(fixture6):
    _check_compute_h(fixture6, "MNT6753", mnt6753.get("cpu"))


def _check_compute_h(fixture, curve, model):
    """Input read by the JAX package's reader and carried over gives the
    oracle's quotient polynomial."""
    from snark_challenge_prover_tpu_torch.ops.fft import get_evaluation_domain
    from snark_challenge_prover_tpu_torch.proof_systems.groth16 import compute_h
    from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints

    cur, _, inputs = orc.generate_fixture(curve, LOG2D, seed=11)
    ref_p = jax_ser.read_params_bytes(fixture["params"].read_bytes(), model.g2_deg)
    ref_i = jax_ser.read_input_bytes(fixture["input"].read_bytes(), ref_p.d, ref_p.m)
    ca, cb, cc = (convert.tensor_from_planes(getattr(ref_i, k), "cpu") for k in ("ca", "cb", "cc"))
    h = compute_h(model, get_evaluation_domain(model.Fr, ref_p.d + 1), ca, cb, cc)
    got = words_to_ints(model.Fr.to_canonical(h).numpy())
    want = orc.compute_h(ref_p.d, inputs["ca"], inputs["cb"], inputs["cc"], cur.fr_spec)
    assert got == want[: ref_p.d + 1]


def test_cli_usage_and_unknown_curve(capsys):
    assert cli.main(["MNT4753", "compute", "a", "b"]) == 2
    assert cli.main(["BN128", "compute", "a", "b", "c", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "usage" in err and "unknown curve BN128" in err
    assert cli.main(["MNT6753", "compute", "a", "b", "c", "--device"]) == 2


def test_writer_encodes_identity_as_zeros():
    z1, z2 = np.zeros(24, np.int32), np.zeros((2, 24), np.int32)
    assert port_ser.write_proof(None, (z1, z1, z1), (z2, z2, z2), (z1, z1, z1)) == b"\x00" * 768


# ---- MNT6753: the committed fixture through the command line on the CPU -------
def test_mnt6753_committed_fixture_is_the_oracles(fixture6):
    for k in ("params", "input", "output"):
        assert (TESTDATA / f"MNT6753-{LOG2D}.{k}").read_bytes() == fixture6[k].read_bytes(), k


@pytest.fixture(scope="module")
def cli_run6(tmp_path_factory):
    """One run of ``cli.main MNT6753 compute ... --device cpu`` on the committed fixture."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("mnt6753_cli") / "proof"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["MNT6753", "compute", str(TESTDATA / f"MNT6753-{LOG2D}.params"),
                       str(TESTDATA / f"MNT6753-{LOG2D}.input"), str(out), "--device", "cpu"])
    return rc, out, printed.getvalue()


def test_mnt6753_cli_proof_is_byte_exact(cli_run6, fixture6):
    rc, out, _ = cli_run6
    got, want = out.read_bytes(), fixture6["output"].read_bytes()
    assert rc == 0 and len(got) == 960  # 192 + 576 + 192: the G2 point has 2 * 3 components
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest(), (
        "proof bytes differ from the oracle's")


def test_mnt6753_cli_prints_the_reference_binarys_phases(cli_run6):
    _, _, printed = cli_run6
    for label in ("load params:", "load inputs:", "cpu:", "store:",
                  "Total time from input to output:"):
        assert label in printed, label


def test_mnt6753_cli_proof_points_are_on_their_curves(cli_run6):
    """The proof's three points as the writer lays them out: G1, G2 over Fq3, G1."""
    _, out, _ = cli_run6
    data = out.read_bytes()
    model = mnt6753.get("cpu")
    from snark_challenge_prover_tpu_torch.host.curves import host_curve
    hc = host_curve("MNT6753")
    fq = model.Fq.spec
    ints = [fq.from_mont(int.from_bytes(data[i : i + 96], "little")) for i in range(0, 960, 96)]
    assert all(v < fq.p for v in ints)
    assert hc.g1.is_on_curve((ints[0], ints[1]))
    assert hc.g2.is_on_curve((tuple(ints[2:5]), tuple(ints[5:8])))
    assert hc.g1.is_on_curve((ints[8], ints[9]))


def test_mnt6753_writer_encodes_identity_as_zeros():
    z1, z3 = np.zeros(24, np.int32), np.zeros((3, 24), np.int32)
    assert port_ser.write_proof(None, (z1, z1, z1), (z3, z3, z3), (z1, z1, z1)) == b"\x00" * 960


# ---- MNT4753 on a step radix-2 and on a geometric sequence domain ---------------
@pytest.fixture(scope="module")
def base4():
    return orc.generate_fixture("MNT4753", LOG2D, seed=11)


def _sized(base, n):
    """The base fixture's points and scalars tiled to d + 1 = n (m = n + 2,
    as the oracle's fixtures have it), with cc = ca * cb on the domain."""
    cur, params, inputs = base
    tile = lambda xs, count: [xs[i % len(xs)] for i in range(count)]
    d, m, p = n - 1, n + 2, cur.fr_spec.p
    P = {"d": d, "m": m, "A": tile(params["A"], m + 1), "B1": tile(params["B1"], m + 1),
         "B2": tile(params["B2"], m + 1), "L": tile(params["L"], m - 1), "H": tile(params["H"], d)}
    ca, cb = tile(inputs["ca"], n), tile(inputs["cb"][::-1], n)
    I = {"w": tile(inputs["w"], m + 1), "ca": ca, "cb": cb,
         "cc": [a * b % p for a, b in zip(ca, cb)], "r": inputs["r"]}
    return P, I


def _domain_points(spec, kind, n):
    """The domain's points from the field's roots, independently of the
    port's classes: step 2^k + 2^r is [w^(2i), i < 2^k] + [w z^j, j < 2^r]
    with w a 2^(k+1)-th and z a 2^r-th root of unity; geometric is [2^i]."""
    p = spec.p
    if kind == "GeometricSequenceDomain":
        return [pow(2, i, p) for i in range(n)]
    big = 1 << (n.bit_length() - 1)
    w, z = spec.get_root_of_unity(2 * big), spec.get_root_of_unity(n - big)
    return [pow(w, 2 * i, p) for i in range(big)] + [w * pow(z, j, p) % p for j in range(n - big)]


def _poly_mul(a, b, p):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def _exact_h(points, ca, cb, cc, p):
    """H = (A B - C) / Z, A, B, C interpolating ca, cb, cc on the points and
    Z = prod (x - x_i); n coefficients (the top one zero)."""
    n = len(points)
    Z = [1]
    for x in points:
        Z = _poly_mul(Z, [-x % p, 1], p)

    def interpolate(vals):
        out = [0] * n
        for j, xj in enumerate(points):
            basis, denom = [1], 1
            for k, xk in enumerate(points):
                if k != j:
                    basis = _poly_mul(basis, [-xk % p, 1], p)
                    denom = denom * (xj - xk) % p
            c = vals[j] * pow(denom, -1, p) % p
            out = [(o + c * b) % p for o, b in zip(out, basis)]
        return out

    num = _poly_mul(interpolate(ca), interpolate(cb), p)
    for i, c in enumerate(interpolate(cc)):
        num[i] = (num[i] - c) % p
    h = [0] * (len(num) - n)
    for i in range(len(h) - 1, -1, -1):  # long division by the monic Z
        h[i] = num[i + n]
        for k in range(n + 1):
            num[i + k] = (num[i + k] - h[i] * Z[k]) % p
    assert not any(num), "Z does not divide A B - C"
    return h + [0] * (n - len(h))


def _proof_bytes(cur, params, inputs, h):
    """tools/oracle.py's ``prove`` with the quotient ``h`` given."""
    d, w = params["d"], inputs["w"]
    At = cur.g1.msm(w, params["A"])
    Bt1 = cur.g1.msm(w, params["B1"])
    Bt2 = cur.g2.msm(w, params["B2"])
    Ht = cur.g1.msm(h[:d], params["H"])
    Lt = cur.g1.msm(w[2:], params["L"])
    C = cur.g1.add(cur.g1.add(Ht, Lt), cur.g1.mul(inputs["r"], Bt1))
    buf = io.BytesIO()
    orc.write_g1(buf, cur, At)
    orc.write_g2(buf, cur, Bt2)
    orc.write_g1(buf, cur, C)
    return buf.getvalue()


@pytest.mark.parametrize("n, kind", [(12, "StepRadix2Domain"), (7, "GeometricSequenceDomain")])
def test_prove_files_byte_exact_on_step_and_sequence_domains(base4, tmp_path, n, kind):
    from snark_challenge_prover_tpu_torch.ops.fft import get_evaluation_domain

    cur = base4[0]
    model = mnt4753.get("cpu")
    assert type(get_evaluation_domain(model.Fr, n)).__name__ == kind
    params, inputs = _sized(base4, n)
    orc.write_params_file(tmp_path / "params", cur, params)
    orc.write_input_file(tmp_path / "input", cur, inputs)
    points = _domain_points(cur.fr_spec, kind, n)
    assert len(set(points)) == n
    h = _exact_h(points, inputs["ca"], inputs["cb"], inputs["cc"], cur.fr_spec.p)
    want = _proof_bytes(cur, params, inputs, h)
    prover = ChallengeProver(model, msm_window=4, verbose=False)
    got = prover.prove_files(tmp_path / "params", tmp_path / "input", tmp_path / "proof")
    assert (tmp_path / "proof").read_bytes() == got and len(got) == 768
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest(), (
        f"proof bytes at d + 1 = {n} ({kind}) differ from the exact-integer ones")
