"""The port's stage-1 field-arithmetic stream (``cli_fixnum.py``) and its
Pedersen hash with Schnorr signatures (``pedersen.py``) against the JAX
package's:

  * ``cli_fixnum.main --device cpu`` on a two-chunk stream writes the JAX
    ``cli_fixnum``'s output byte for byte, and that output is a * b * 2^-768
    mod q of the Python integers, q(MNT4753) then q(MNT6753) in each chunk;
  * ``PedersenSchnorr`` from the same seed makes the JAX package's
    coefficients, hashes, keys and signatures, and the verdicts agree (a
    flipped message bit and another key rejected);
  * ``hash_batch_device`` on the CPU (the staged MSM with one-bit windows
    in plain PyTorch) equals the host hash row for row."""

import random
import struct

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu import cli_fixnum as jax_cli_fixnum
from snark_challenge_prover_tpu import pedersen as jax_pedersen
from snark_challenge_prover_tpu_torch import cli_fixnum, pedersen
from snark_challenge_prover_tpu_torch.models.primes import P_MNT4_Q, P_MNT4_R

torch.set_num_threads(1)

CHUNKS = (24, 10)  # n of each chunk: n / 2 products a curve
Q6 = P_MNT4_R  # q(MNT6753) is r(MNT4753): the cycle


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A stream of two chunks of random Montgomery words below 2^751 (below
    both moduli), and its path."""
    rng = np.random.default_rng(5)
    path = tmp_path_factory.mktemp("fixnum") / "inputs"
    with open(path, "wb") as f:
        for n in CHUNKS:
            f.write(struct.pack("<Q", n))
            w = rng.integers(0, 1 << 32, size=(2 * n, 24), dtype=np.uint32)
            w[:, 23] &= 0x7FFF
            f.write(w.astype("<u4").tobytes())
    return path


def expected(path) -> bytes:
    """The products of the stream over Python integers."""
    data, out, off = path.read_bytes(), [], 0
    ints = lambda count: [int.from_bytes(data[off + 96 * i : off + 96 * (i + 1)], "little")
                          for i in range(count)]
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        off += 8
        for q in (P_MNT4_Q, Q6):
            a = ints(n // 2)
            off += 48 * n
            b = ints(n // 2)
            off += 48 * n
            rinv = pow(1 << 768, -1, q)
            out += [(x * y * rinv % q).to_bytes(96, "little") for x, y in zip(a, b)]
    return b"".join(out)


def test_fixnum_stream_equals_jax_and_integers(stream, tmp_path):
    assert cli_fixnum.main([str(stream), str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_cli_fixnum.main([str(stream), str(tmp_path / "jax")]) == 0
    got = (tmp_path / "port").read_bytes()
    assert len(got) == 96 * sum(CHUNKS)
    assert got == (tmp_path / "jax").read_bytes()
    assert got == expected(stream)


def test_fixnum_short_stream_raises(stream, tmp_path):
    short = tmp_path / "short"
    short.write_bytes(stream.read_bytes()[:-96])
    with pytest.raises(ValueError, match="shorter"):
        cli_fixnum.main([str(short), str(tmp_path / "out"), "--device", "cpu"])


@pytest.fixture(scope="module")
def schnorr():
    """Both packages' PedersenSchnorr from one seed: (jax, port)."""
    return (jax_pedersen.PedersenSchnorr("MNT4753", random.Random(7), max_input_size=1600),
            pedersen.PedersenSchnorr("MNT4753", random.Random(7), max_input_size=1600))


def test_coefficients_and_hash_equal_jax(schnorr):
    jp, pp = schnorr
    assert pp.coeffs == jp.coeffs
    assert (pp.r, pp.q, pp.gen) == (jp.r, jp.q, jp.gen)
    rng = random.Random(2)
    for length in (0, 1, 64, 300):
        bits = [rng.random() < 0.5 for _ in range(length)]
        acc, shift = pp.hash_bits(bits)
        assert (acc, shift) == jp.hash_bits(bits)
        assert pp.digest_scalar(acc) == jp.digest_scalar(acc)
        assert pp.hash_bits(bits, acc, shift) == jp.hash_bits(bits, acc, shift)


def test_sign_and_verify_equal_jax(schnorr):
    jp, pp = schnorr
    msg = [random.Random(1).random() < 0.5 for _ in range(64)]
    (sk_j, pk_j), (sk, pk) = jp.keygen(), pp.keygen()
    assert (sk, pk) == (sk_j, pk_j)
    sig = pp.sign(sk, msg)
    assert sig == jp.sign(sk_j, msg)
    bad = list(msg)
    bad[3] = not bad[3]
    _, pk2 = pp.keygen()
    _, pk2_j = jp.keygen()
    assert pk2 == pk2_j
    cases = ((pk, msg), (pk, bad), (pk2, msg))
    verdicts = [pp.verify(k, m, sig) for k, m in cases]
    assert verdicts == [jp.verify(k, m, sig) for k, m in cases] == [True, False, False]


def test_device_batch_hash_on_cpu_equals_host(schnorr):
    _, pp = schnorr
    rng = random.Random(3)
    N = 96
    bits = [[rng.randrange(2) for _ in range(N)] for _ in range(3)] + [[0] * N, [1] * N]
    got = pedersen.hash_batch_device("MNT4753", pp.coeffs[:N], bits, device="cpu")
    assert got == [pp.hash_bits([bool(b) for b in row])[0] for row in bits]
    with pytest.raises(ValueError):
        pedersen.hash_batch_device("MNT4753", pp.coeffs[:N], [[2] * N], device="cpu")
