"""Proving key, verification key and proof (de)serialisation.

Counterpart of the JAX package's ``io/keys.py``: the framework's own binary
format (the reference's iostream key format, r1cs_gg_ppzksnark.hpp:70-356,
is libsnark-internal and outside the challenge's byte-exactness contract),
built from the wire format's primitives: 96-byte little-endian field
elements and 8-byte little-endian counts.  For the same key the bytes are
the JAX package's.

  pk:    SCPK1 | curve | 5 single points | 5 query blocks | R1CS
  vk:    SCVK1 | curve | GT element | delta_g2 | ABC points
  proof: the challenge's wire format (``groth16_full.Proof.to_bytes``)

A query block is the JAX package's shape header and then each component's
elements.  That package holds a query coordinate as 16-bit limb planes,
(48, N) or (deg, 48, N); the port holds (24, N) or (deg, 24, N) 32-bit
words.  Both are the same 96 little-endian bytes an element, so the port
writes the JAX shape and reads it back into words, on the model's device.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..host.curves import host_curve
from ..ops.field import resolve_device
from ..proof_systems.groth16_full import Proof, ProvingKey, VerificationKey
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint, R1CSConstraintSystem
from .serialization import FQ_BYTES, N_WORDS, bytes_to_words, words_to_bytes

_PK_MAGIC = b"SCPK1\x00"
_VK_MAGIC = b"SCVK1\x00"
_PLANES = 2 * N_WORDS  # the JAX package's 16-bit limbs an element
_WRITE_CHUNK = 1 << 18  # elements a copy from the device when writing


class _W:
    def __init__(self):
        self.parts = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def raw(self, b: bytes):
        self.parts.append(b)

    def fq(self, v: int):
        self.parts.append(int(v).to_bytes(FQ_BYTES, "little"))

    def text(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.raw(b)

    def words(self, x: torch.Tensor):
        """(24, N) or (deg, 24, N) words: the JAX planes' shape, then each
        component's elements."""
        shape = list(x.shape)
        shape[-2] = _PLANES
        self.u64(len(shape))
        for s in shape:
            self.u64(s)
        for comp in x.reshape(-1, N_WORDS, x.shape[-1]):
            for i in range(0, comp.shape[-1], _WRITE_CHUNK):
                self.raw(words_to_bytes(comp[:, i : i + _WRITE_CHUNK].cpu().numpy()))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes):
        self.d = memoryview(data)
        self.off = 0

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.d, self.off)
        self.off += 8
        return v

    def raw(self, n: int):
        if self.off + n > len(self.d):
            raise ValueError("key or proof data shorter than its header says")
        b = self.d[self.off : self.off + n]
        self.off += n
        return b

    def fq(self) -> int:
        return int.from_bytes(self.raw(FQ_BYTES), "little")

    def text(self) -> str:
        return bytes(self.raw(self.u64())).decode()

    def words(self, device) -> torch.Tensor:
        """A block the JAX package wrote as planes -> words on ``device``."""
        ndim = self.u64()
        shape = [self.u64() for _ in range(ndim)]
        if ndim not in (2, 3) or shape[-2] != _PLANES:
            raise ValueError(f"query block of shape {shape}, not (48, N) or (deg, 48, N)")
        n = shape[-1]
        # a copy: the words of one element are a read-only view of ``data``
        comps = [torch.from_numpy(np.array(bytes_to_words(self.raw(n * FQ_BYTES)))
                                  .reshape(N_WORDS, n))
                 for _ in range(shape[0] if ndim == 3 else 1)]
        out = torch.stack(comps) if ndim == 3 else comps[0]
        return out.to(device)


def _deg(curve: str) -> int:
    return len(host_curve(curve).g2_gen[0])


# ---------------------------------------------------------------------------
# host affine points (exact integers, None the identity)
# ---------------------------------------------------------------------------

def _w_g1(w: _W, P):
    w.fq(0 if P is None else P[0])
    w.fq(0 if P is None else P[1])


def _r_g1(r: _R):
    x, y = r.fq(), r.fq()
    return None if y == 0 else (x, y)


def _w_g2(w: _W, P, deg: int):
    for c in ((0,) * 2 * deg if P is None else P[0] + P[1]):
        w.fq(c)


def _r_g2(r: _R, deg: int):
    x = tuple(r.fq() for _ in range(deg))
    y = tuple(r.fq() for _ in range(deg))
    return None if not any(y) else (x, y)


# ---------------------------------------------------------------------------
# R1CS
# ---------------------------------------------------------------------------

_TERM = struct.Struct("<Q96s")  # a linear combination's term: index, coefficient


def _w_cs(w: _W, cs: R1CSConstraintSystem):
    w.u64(cs.primary_input_size)
    w.u64(cs.auxiliary_input_size)
    w.u64(len(cs.constraints))
    count, term = struct.Struct("<Q").pack, _TERM.pack
    for cons in cs.constraints:
        for lc in (cons.a, cons.b, cons.c):
            terms = sorted(lc.collate(cs.p).items())
            w.raw(count(len(terms)))
            w.raw(b"".join([term(i, c.to_bytes(FQ_BYTES, "little")) for i, c in terms]))


def _r_cs(r: _R, p: int) -> R1CSConstraintSystem:
    cs = R1CSConstraintSystem(p)
    cs.primary_input_size = r.u64()
    cs.auxiliary_input_size = r.u64()
    for _ in range(r.u64()):
        lcs = []
        for _ in range(3):
            block = r.raw(r.u64() * _TERM.size)
            lcs.append(LC([(i, int.from_bytes(c, "little")) for i, c in _TERM.iter_unpack(block)]))
        cs.add_constraint(R1CSConstraint(*lcs))
    return cs


def _check_end(r: _R, what: str):
    if r.off != len(r.d):
        raise ValueError(f"trailing {what} bytes")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def write_proving_key(pk: ProvingKey) -> bytes:
    deg = _deg(pk.curve)
    w = _W()
    w.raw(_PK_MAGIC)
    w.text(pk.curve)
    _w_g1(w, pk.alpha_g1)
    _w_g1(w, pk.beta_g1)
    _w_g2(w, pk.beta_g2, deg)
    _w_g1(w, pk.delta_g1)
    _w_g2(w, pk.delta_g2, deg)
    for x, y in (pk.A_query, pk.B_query_g2, pk.B_query_g1, pk.H_query, pk.L_query):
        w.words(x)
        w.words(y)
    _w_cs(w, pk.constraint_system)
    return w.bytes()


def read_proving_key(data: bytes, device="cuda") -> ProvingKey:
    """The key with its queries on ``device`` (the card unless asked)."""
    dev = resolve_device(device)
    r = _R(data)
    if r.raw(len(_PK_MAGIC)) != _PK_MAGIC:
        raise ValueError("not a proving key: bad magic")
    curve = r.text()
    hc = host_curve(curve)
    deg = _deg(curve)
    singles = (_r_g1(r), _r_g1(r), _r_g2(r, deg), _r_g1(r), _r_g2(r, deg))
    blocks = [(r.words(dev), r.words(dev)) for _ in range(5)]
    cs = _r_cs(r, hc.fr_spec.p)
    _check_end(r, "proving-key")
    return ProvingKey(curve, *singles, A_query=blocks[0], B_query_g2=blocks[1],
                      B_query_g1=blocks[2], H_query=blocks[3], L_query=blocks[4],
                      constraint_system=cs)


def write_verification_key(vk: VerificationKey) -> bytes:
    deg = _deg(vk.curve)
    w = _W()
    w.raw(_VK_MAGIC)
    w.text(vk.curve)
    for comps in vk.alpha_g1_beta_g2:  # GT: a pair of Fq^deg elements
        for c in comps:
            w.fq(c)
    _w_g2(w, vk.delta_g2, deg)
    w.u64(len(vk.ABC_g1))
    for P in vk.ABC_g1:
        _w_g1(w, P)
    return w.bytes()


def read_verification_key(data: bytes) -> VerificationKey:
    r = _R(data)
    if r.raw(len(_VK_MAGIC)) != _VK_MAGIC:
        raise ValueError("not a verification key: bad magic")
    curve = r.text()
    deg = _deg(curve)
    gt = tuple(tuple(r.fq() for _ in range(deg)) for _ in range(2))
    delta_g2 = _r_g2(r, deg)
    ABC = [_r_g1(r) for _ in range(r.u64())]
    _check_end(r, "verification-key")
    return VerificationKey(curve=curve, alpha_g1_beta_g2=gt, delta_g2=delta_g2, ABC_g1=ABC)


def read_proof(data: bytes, curve: str) -> Proof:
    """The wire format's bytes (Montgomery, the identity as zeros) -> Proof."""
    spec = host_curve(curve).fq_spec
    deg = _deg(curve)
    r = _R(data)

    def point(k):
        vals = [spec.from_mont(r.fq()) for _ in range(2 * k)]
        if not any(vals[k:]):
            return None
        return (vals[0], vals[1]) if k == 1 else (tuple(vals[:k]), tuple(vals[k:]))

    A, B, C = point(1), point(deg), point(1)
    _check_end(r, "proof")
    return Proof(g_A=A, g_B=B, g_C=C)
