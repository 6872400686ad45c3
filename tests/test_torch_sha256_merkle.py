"""The port's SHA256 and Merkle-path gadgets (``gadgets/sha256_gadget.py``,
``gadgets/merkle_tree.py``) against the JAX package's: ``host_compress``
against hashlib; the compression gadget, the two-to-one gadget and
``MerkleAuthPathGadget`` at depth 2, each built and filled with both
packages from the same seeded words, equal term for term (every
constraint's terms and annotation, and the assignment) and satisfied, with
the outputs equal to the host mirrors; a wrong sibling leaves the path
unsatisfied under the original root."""

import hashlib
import random
import struct

import pytest
import torch

from snark_challenge_prover_tpu.gadgets import merkle_tree as jax_merkle
from snark_challenge_prover_tpu.gadgets import protoboard as jax_pb
from snark_challenge_prover_tpu.gadgets import sha256_gadget as jax_sha
from snark_challenge_prover_tpu_torch.gadgets import merkle_tree, protoboard, sha256_gadget
from snark_challenge_prover_tpu_torch.models.primes import P_MNT4_R
from test_torch_verifier_gadget import summary

torch.set_num_threads(1)

JAX = (jax_pb, jax_sha, jax_merkle)
PORT = (protoboard, sha256_gadget, merkle_tree)


def words(data: bytes):
    return list(struct.unpack(f">{len(data) // 4}I", data))


@pytest.mark.parametrize("size", [0, 3, 55, 64, 100])
def test_host_compress_is_sha256(size):
    """sha256 of a message = the compression over its padded blocks."""
    msg = bytes((7 * i + 1) % 256 for i in range(size))
    padded = msg + b"\x80" + b"\x00" * ((55 - size) % 64) + struct.pack(">Q", 8 * size)
    state = sha256_gadget.IV
    for i in range(0, len(padded), 64):
        state = sha256_gadget.host_compress(state, words(padded[i : i + 64]))
    assert struct.pack(">8I", *state) == hashlib.sha256(msg).digest()
    state_j = jax_sha.IV
    for i in range(0, len(padded), 64):
        state_j = jax_sha.host_compress(state_j, words(padded[i : i + 64]))
    assert state_j == state


def compression(pkg, state_vals, block_vals):
    pbm, sha, _ = pkg
    pb = pbm.Protoboard(P_MNT4_R)
    state = [sha.Word.allocate(pb, f"s{i}") for i in range(8)]
    block = [sha.Word.allocate(pb, f"m{i}") for i in range(16)]
    for w in state + block:
        w.boolify(pb)
    g = sha.Sha256CompressionGadget(pb, state, block)
    for w, v in zip(state + block, state_vals + block_vals):
        w.set_value(pb, v)
    g.generate_r1cs_witness()
    return pb, g.output_values()


def two_to_one(pkg, left_vals, right_vals):
    pbm, sha, _ = pkg
    pb = pbm.Protoboard(P_MNT4_R)
    left = [sha.Word.allocate(pb, f"l{i}") for i in range(8)]
    right = [sha.Word.allocate(pb, f"r{i}") for i in range(8)]
    for w in left + right:
        w.boolify(pb)
    g = sha.Sha256TwoToOneGadget(pb, left, right)
    for w, v in zip(left + right, left_vals + right_vals):
        w.set_value(pb, v)
    g.generate_r1cs_witness()
    return pb, g.output_values()


def test_compression_gadget_equals_jax():
    rng = random.Random(11)
    sv = [rng.getrandbits(32) for _ in range(8)]
    bv = [rng.getrandbits(32) for _ in range(16)]
    (pb_j, out_j), (pb, out) = (compression(pkg, sv, bv) for pkg in (JAX, PORT))
    assert summary(pb) == summary(pb_j)
    assert out == out_j == sha256_gadget.host_compress(sv, bv)
    assert pb.is_satisfied()
    assert 20000 < pb.num_constraints < 40000


def test_two_to_one_gadget_equals_jax():
    rng = random.Random(12)
    lv = [rng.getrandbits(32) for _ in range(8)]
    rv = [rng.getrandbits(32) for _ in range(8)]
    (pb_j, out_j), (pb, out) = (two_to_one(pkg, lv, rv) for pkg in (JAX, PORT))
    assert summary(pb) == summary(pb_j)
    assert out == out_j == sha256_gadget.host_two_to_one(lv, rv)
    assert pb.is_satisfied()


DEPTH = 2


@pytest.fixture(scope="module")
def path_values():
    rng = random.Random(13)
    leaf = [rng.getrandbits(32) for _ in range(8)]
    address = rng.randrange(1 << DEPTH)
    path = [[rng.getrandbits(32) for _ in range(8)] for _ in range(DEPTH)]
    return leaf, address, path


def merkle_path(pkg, leaf, address, path):
    pbm, _, mt = pkg
    pb = pbm.Protoboard(P_MNT4_R)
    g = mt.MerkleAuthPathGadget(pb, DEPTH)
    root = g.set_witness(leaf, address, path)
    return pb, g, root


def test_merkle_auth_path_equals_jax(path_values):
    leaf, address, path = path_values
    (pb_j, _, root_j), (pb, _, root) = (merkle_path(pkg, leaf, address, path)
                                        for pkg in (JAX, PORT))
    assert summary(pb) == summary(pb_j)
    assert root == root_j == merkle_tree.host_merkle_root(leaf, address, path)
    assert root == jax_merkle.host_merkle_root(leaf, address, path)
    assert pb.is_satisfied()


def test_wrong_sibling_leaves_the_path_unsatisfied(path_values):
    leaf, address, path = path_values
    root = merkle_tree.host_merkle_root(leaf, address, path)
    for level in range(DEPTH):
        bad = [list(lvl) for lvl in path]
        bad[level][0] ^= 1
        pb, g, _ = merkle_path(PORT, leaf, address, bad)
        assert pb.is_satisfied()  # the recomputed (wrong) root
        for w, v in zip(g.root, root):
            w.set_value(pb, v)
        assert not pb.is_satisfied()


def test_word_checks_raise():
    pb = protoboard.Protoboard(P_MNT4_R)
    with pytest.raises(ValueError):
        sha256_gadget.Word([0] * 31)
    with pytest.raises(ValueError):
        sha256_gadget.Word.constant(5).set_value(pb, 4)
    with pytest.raises(ValueError):
        sha256_gadget.Sha256TwoToOneGadget(pb, [sha256_gadget.Word.constant(0)] * 7,
                                           [sha256_gadget.Word.constant(0)] * 8)
