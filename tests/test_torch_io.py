"""The port's two readers of the challenge files agree word for word.

``DeviceReader`` (what the prover reads through on a CUDA model) runs here
on CPU tensors, with chunks of 40 bytes (smaller than one 96-byte element,
so chunk edges cut elements and the 16-byte header), 1000 bytes and the
default 64 MB, against the numpy reader: on both committed fixtures, on a
generated params file whose every query holds identity points (all
zeros), and on files cut short or with a byte too many, where both must
raise the same error."""

from pathlib import Path

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu_torch.io import serialization as ser

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

TESTDATA = Path(ser.__file__).resolve().parents[1] / "testdata"
DEG = {"MNT4753": 2, "MNT6753": 3}
CHUNKS = [40, 1000, 64 << 20]


def _same(got, want):
    """A reader's tensors (or tuples of them) equal the numpy reader's arrays."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def _check_params(path, deg, chunk):
    want = ser.read_params(path, deg)
    got = ser.DeviceReader("cpu", chunk_bytes=chunk).read_params(path, deg)
    assert (got.d, got.m) == (want.d, want.m)
    for k in ("A", "B1", "B2", "L", "H"):
        _same(getattr(got, k), getattr(want, k))
    return want


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("curve", sorted(DEG))
def test_device_reader_equals_numpy_reader_on_the_fixtures(curve, chunk):
    params = _check_params(TESTDATA / f"{curve}-3.params", DEG[curve], chunk)
    assert params.B2[0].shape == (DEG[curve], 24, params.m + 1)
    path = TESTDATA / f"{curve}-3.input"
    want = ser.read_input(path, params.d, params.m)
    got = ser.DeviceReader("cpu", chunk_bytes=chunk).read_input(path, params.d, params.m)
    for k in ("w", "ca", "cb", "cc", "r"):
        _same(getattr(got, k), getattr(want, k))
    assert got.r.shape == (24, 1)


def _generated_params(path, d, m, deg, seed):
    """Random words in the params layout, with identity points (all zeros)
    at the first, a middle and the last place of every query."""
    rng = np.random.default_rng(seed)
    blocks = []
    for count, width in ((m + 1, 2), (m + 1, 2), (m + 1, 2 * deg), (m - 1, 2), (d, 2)):
        b = rng.integers(0, 2**32, size=(count, width * 24), dtype=np.uint32)
        b[[0, count // 2, count - 1]] = 0
        blocks.append(b)
    path.write_bytes(np.array([d, m], "<u8").tobytes() + b"".join(b.tobytes() for b in blocks))


@pytest.mark.parametrize("curve", sorted(DEG))
def test_device_reader_equals_numpy_reader_with_identity_points(curve, tmp_path):
    path = tmp_path / "params"
    _generated_params(path, 11, 13, DEG[curve], seed=len(curve) + DEG[curve])
    params = _check_params(path, DEG[curve], 40)
    for k in ("A", "B1", "B2", "L", "H"):
        for coord in getattr(params, k):
            assert not coord[..., 0].any() and not coord[..., -1].any()


@pytest.mark.parametrize("kind", ["params", "input"])
@pytest.mark.parametrize("change, message", [
    (lambda b: b[:-1], "file shorter than its header says"),
    (lambda b: b[:10], "file shorter than its header says"),
    (lambda b: b + b"\0", "trailing bytes: 1"),
    (lambda b: b + bytes(97), "trailing bytes: 97"),
])
def test_short_and_long_files_raise_in_both_readers(tmp_path, kind, change, message):
    path = tmp_path / kind
    path.write_bytes(change((TESTDATA / f"MNT4753-3.{kind}").read_bytes()))
    dev = ser.DeviceReader("cpu", chunk_bytes=40)
    args = (path, 2) if kind == "params" else (path, 7, 10)  # G2 degree; the fixture's d, m
    with pytest.raises(ValueError, match=message):
        getattr(dev, f"read_{kind}")(*args)
    if kind == "params" and len(path.read_bytes()) < ser.HEADER_BYTES:
        return  # the numpy reader's struct.error: no header to read
    with pytest.raises(ValueError, match=message):
        getattr(ser, f"read_{kind}")(*args)


def test_device_reader_refuses_a_chunk_of_no_bytes():
    with pytest.raises(ValueError):
        ser.DeviceReader("cpu", chunk_bytes=0)
