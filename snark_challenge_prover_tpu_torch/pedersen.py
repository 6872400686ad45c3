"""Pedersen hash + Schnorr signature demo (misc/pedersen.cpp parity).

Counterpart of the JAX package's ``pedersen.py`` on the port's host curves
and staged MSM.  The reference ships a Pedersen-style bit hash over the
INNER curve's G1 (MNT6753 G1 when proving over MNT4753: the cycle makes its
coordinates native to the outer circuit's field) with a Schnorr signature
on top (libsnark/misc/pedersen.cpp:33-156, camlsnark_pedersen_test:158-195).

Host path, exact integers:
  hash(acc0, bits) = acc0 + sum_{i: bits[i]} coeffs[i]
  digest_scalar    = x-coordinate of the affine accumulator
  sign: r = k*G; e = H(r, msg); s = k - x*e;  verify: r' = s*G + e*pk.
(The reference's update_with_g1 reads `Y = p.X()`, a transcription slip that
hashes X twice; as the JAX package does, this hashes X and Y, which changes
the demo's digests, not its structure.)

Device path: the bit-controlled accumulation is a multi-scalar
multiplication with 0/1 scalars, so hashing a BATCH of messages is one call
of the staged MSM (``ops/msm.msm_multi_staged``, one-bit windows) over the
coefficient strip, one row a message.
"""

from __future__ import annotations

import random

import torch

from .host.curves import host_curve
from .utils.bigint import ints_to_words, words_to_ints


class PedersenSchnorr:
    """The reference pedersen.cpp over host exact ints, inner-curve G1."""

    def __init__(self, outer: str = "MNT4753", rng=None, max_input_size=2048):
        inner = "MNT6753" if outer == "MNT4753" else "MNT4753"
        self.hc = host_curve(inner)
        self.g = self.hc.g1
        self.gen = self.hc.g1_gen
        self.r = self.hc.fr_spec.p  # inner group order
        self.q = self.hc.g1.F.p    # coordinate field
        rng = rng or random.Random(0)
        # coeffs: multiples of the generator (pedersen.cpp:164-168 draws each
        # independently; as the JAX package does, walk base + i*step from two
        # random multiples, far cheaper than max_input_size scalar products)
        base = self.g.mul(rng.randrange(1, self.r), self.gen)
        step = self.g.mul(rng.randrange(1, self.r), self.gen)
        self.coeffs = []
        P = base
        for _ in range(max_input_size):
            self.coeffs.append(P)
            P = self.g.add(P, step)
        self._rng = rng

    # ---- hash (pedersen.cpp:34-74) -------------------------------------
    def hash_bits(self, bits, acc=None, shift=0):
        acc = acc if acc is not None else self.gen
        for i, b in enumerate(bits):
            if b:
                acc = self.g.add(acc, self.coeffs[shift + i])
        return acc, shift + len(bits)

    def _point_bits(self, P):
        n = 753
        x, y = P
        return [bool((x >> i) & 1) for i in range(n)] + [bool((y >> i) & 1) for i in range(n)]

    def digest_scalar(self, acc) -> int:
        """x-coordinate as a scalar (pedersen.cpp:99-104; safe because the
        cycle fields share a bit length)."""
        return acc[0] % self.r

    # ---- Schnorr (pedersen.cpp:106-156) --------------------------------
    def keygen(self):
        sk = self._rng.randrange(1, self.r)
        return sk, self.g.mul(sk, self.gen)

    def sign(self, sk: int, msg_bits):
        k = self._rng.randrange(1, self.r)
        r_pt = self.g.mul(k, self.gen)
        acc, shift = self.hash_bits(self._point_bits(r_pt))
        acc, _ = self.hash_bits(msg_bits, acc, shift)
        e = self.digest_scalar(acc)
        s = (k - sk * e) % self.r
        return (s, e)

    def verify(self, pk, msg_bits, sig) -> bool:
        s, e = sig
        r_pt = self.g.add(self.g.mul(s, self.gen), self.g.mul(e, pk))
        acc, shift = self.hash_bits(self._point_bits(r_pt))
        acc, _ = self.hash_bits(msg_bits, acc, shift)
        return self.digest_scalar(acc) == e


def hash_batch_device(outer: str, coeffs, bit_matrix, device="cuda"):
    """M messages hashed at once: one staged MSM of M rows over the
    coefficient strip, with each message's bits as its one-bit scalars.

    coeffs: host affine points (the hash coefficients, N of them)
    bit_matrix: M rows of N 0/1 ints, the message bits
    device: the inner curve's model's; the card unless the caller passes "cpu".
    Returns M host affine accumulators (acc0 = the generator), None for the
    identity."""
    from .models import mnt4753, mnt6753
    from .ops.msm import msm_multi_staged

    inner = (mnt6753 if outer == "MNT4753" else mnt4753).get(device)
    G1, Fq = inner.G1, inner.Fq
    hc = host_curve(inner.name)
    bits = torch.as_tensor(bit_matrix, dtype=torch.int32)
    M, N = bits.shape
    if N != len(coeffs):
        raise ValueError(f"{N} bits a message for {len(coeffs)} coefficients")
    if ((bits != 0) & (bits != 1)).any():
        raise ValueError("message bits must be 0 or 1")
    x, y = (torch.from_numpy(ints_to_words([Fq.spec.to_mont(P[i]) for P in coeffs])).to(Fq.device)
            for i in (0, 1))
    pts = tuple(t.unsqueeze(-2).expand(t.shape[:-1] + (M, N)) for t in G1.from_affine(x, y))
    scalars = torch.zeros((24, M, N), dtype=torch.int32)
    scalars[0] = bits
    X, Y, Z = (words_to_ints(t.cpu().numpy()) for t in msm_multi_staged(
        G1, pts, scalars.to(Fq.device), c=1, scalar_bits=1))
    q = Fq.p
    out = []
    for xm, ym, zm in zip(X, Y, Z):
        x_, y_, z_ = (Fq.spec.from_mont(v) for v in (xm, ym, zm))
        P = None if z_ == 0 else (x_ * pow(z_, -1, q) % q, y_ * pow(z_, -1, q) % q)
        out.append(hc.g1.add(P, hc.g1_gen))
    return out
