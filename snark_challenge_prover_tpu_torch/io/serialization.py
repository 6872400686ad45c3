"""Challenge wire format: raw little-endian Montgomery bytes.

Layouts (libsnark/serialization.hpp):
  * field element  = 96 bytes LE Montgomery (12 x 64-bit limbs; the port's
    24 x 32-bit words are the identical byte string since R = 2^768)
  * G1             = affine (x, y); zero encoded as (0, 0); readers treat
    y == 0 as the identity and set Z = 1 otherwise (hpp:84-92)
  * G2             = (x, y) with extension-degree base-field components each
  * size_t         = 8 bytes LE

File layouts (libsnark/main.cpp:50-83):
  params: d, m, A[m+1] G1, B1[m+1] G1, B2[m+1] G2, L[m-1] G1, H[d] G1
  input:  w[m+1] Fr, ca[d+1] Fr, cb[d+1] Fr, cc[d+1] Fr, r Fr
  output: A G1, B G2, C G1

Two readers give the same ``int32[24, count]`` word arrays (``(deg, 24,
count)`` for G2 coordinates; the device layout of ``ops/limbs.py``):

  * ``read_params`` / ``read_input``: numpy on the host.  The prover uses
    them on the CPU (``device="cpu"``); the tests hold the other reader to
    them.
  * ``DeviceReader``: the counterpart of the JAX package's native loader
    (``io/native.py`` over ``native/sc_runtime.cpp``).  It reads a file once,
    in fixed-size chunks, into a few reused pinned host buffers, copies each
    chunk to one raw ``uint8`` tensor on the device while the next chunk is
    read, and unpacks there with views and one copy a block.  On a CUDA
    model the prover reads through it and only through it: a failure to pin,
    copy or unpack raises.

The key generator writes both files from word tensors on its device
(``write_params`` / ``write_input``): the words are the wire format's
bytes, so a block is interleaved on the device and copied out a chunk at a
time.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

FQ_BYTES = 96
N_WORDS = 24
HEADER_BYTES = 16  # d, m: two size_t


def bytes_to_words(buf) -> np.ndarray:
    """count * 96 bytes -> int32[24, count] word rows."""
    raw = np.frombuffer(buf, dtype="<u4")
    if raw.size % N_WORDS:
        raise ValueError("buffer not a multiple of the element size")
    return np.ascontiguousarray(raw.reshape(-1, N_WORDS).T).view(np.int32)


def words_to_bytes(words: np.ndarray) -> bytes:
    """int32[24, count] -> count * 96 bytes."""
    w = np.asarray(words).reshape(N_WORDS, -1)
    return np.ascontiguousarray(w.T).view(np.uint32).astype("<u4").tobytes()


class Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.off = 0

    def size_t(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.off)
        self.off += 8
        return v

    def fq_block(self, count: int) -> np.ndarray:
        """count field elements -> int32[24, count] Montgomery words."""
        nbytes = count * FQ_BYTES
        if self.off + nbytes > len(self.data):
            raise ValueError("file shorter than its header says")
        out = bytes_to_words(self.data[self.off : self.off + nbytes])
        self.off += nbytes
        return out

    def g1_block(self, count: int):
        """count G1 points -> (x, y), each (24, count); x and y interleave."""
        raw = self.fq_block(2 * count)
        return np.ascontiguousarray(raw[:, 0::2]), np.ascontiguousarray(raw[:, 1::2])

    def g2_block(self, count: int, deg: int):
        """count G2 points -> (x, y), each (deg, 24, count)."""
        raw = self.fq_block(2 * deg * count)  # per point: x_c0..x_cd, y_c0..
        per = raw.reshape(N_WORDS, count, 2, deg)
        x = np.ascontiguousarray(np.moveaxis(per[:, :, 0, :], -1, 0))
        y = np.ascontiguousarray(np.moveaxis(per[:, :, 1, :], -1, 0))
        return x, y


class Writer:
    def __init__(self):
        self.chunks = []

    def g1(self, x, y, z):
        """One affine G1 point (z == 0 -> (0, 0)); arrays of 24 words."""
        if not np.asarray(z).any():
            self.chunks.append(b"\x00" * (2 * FQ_BYTES))
            return
        self.chunks.append(words_to_bytes(x) + words_to_bytes(y))

    def g2(self, x, y, z):
        """One affine G2 point; components (deg, 24)."""
        x, y, z = (np.asarray(t).reshape(-1, N_WORDS) for t in (x, y, z))
        if not z.any():
            self.chunks.append(b"\x00" * (2 * x.shape[0] * FQ_BYTES))
            return
        for comps in (x, y):
            self.chunks.extend(words_to_bytes(c) for c in comps)

    def bytes(self) -> bytes:
        return b"".join(self.chunks)


@dataclass
class Groth16Params:
    """Challenge proving parameters (main.cpp:42-61) as word arrays: numpy
    arrays from ``read_params``, tensors on the reader's device from
    ``DeviceReader.read_params``."""

    d: int
    m: int
    A: tuple   # (x, y), each (24, m+1)
    B1: tuple
    B2: tuple  # (x, y), each (deg, 24, m+1)
    L: tuple
    H: tuple


@dataclass
class Groth16Input:
    """Witness, precomputed domain evaluations and blinding r
    (main.cpp:63-83) as word arrays: numpy arrays from ``read_input``,
    tensors on the reader's device from ``DeviceReader.read_input``."""

    w: np.ndarray   # (24, m+1) Montgomery words
    ca: np.ndarray  # (24, d+1)
    cb: np.ndarray
    cc: np.ndarray
    r: np.ndarray   # (24, 1)


def read_params_bytes(data, g2_deg: int) -> Groth16Params:
    r = Reader(data)
    d = r.size_t()
    m = r.size_t()
    A = r.g1_block(m + 1)
    B1 = r.g1_block(m + 1)
    B2 = r.g2_block(m + 1, g2_deg)
    L = r.g1_block(m - 1)
    H = r.g1_block(d)
    if r.off != len(r.data):
        raise ValueError(f"params trailing bytes: {len(r.data) - r.off}")
    return Groth16Params(d, m, A, B1, B2, L, H)


def read_input_bytes(data, d: int, m: int) -> Groth16Input:
    r = Reader(data)
    w = r.fq_block(m + 1)
    ca = r.fq_block(d + 1)
    cb = r.fq_block(d + 1)
    cc = r.fq_block(d + 1)
    rr = r.fq_block(1)
    if r.off != len(r.data):
        raise ValueError(f"input trailing bytes: {len(r.data) - r.off}")
    return Groth16Input(w, ca, cb, cc, rr)


def _read_file(path) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint8)


def read_params(path, g2_deg: int) -> Groth16Params:
    return read_params_bytes(_read_file(path), g2_deg)


def read_input(path, d: int, m: int) -> Groth16Input:
    return read_input_bytes(_read_file(path), d, m)


def _params_elements(d: int, m: int, g2_deg: int) -> int:
    """96-byte elements after the params header: A, B1 (2 each a point),
    B2 (2 * deg), L and H (main.cpp:50-61)."""
    return 2 * (m + 1) * 2 + 2 * g2_deg * (m + 1) + 2 * (m - 1) + 2 * d


def _check_size(size: int, want: int, what: str):
    """The numpy reader's two checks, from the file's size alone."""
    if size < want:
        raise ValueError("file shorter than its header says")
    if size > want:
        raise ValueError(f"{what} trailing bytes: {size - want}")


class _Blocks:
    """Consecutive blocks of a (elements, 24) int32 view, unpacked on its
    device with one copy a block."""

    def __init__(self, elems: torch.Tensor):
        self.elems = elems
        self.off = 0

    def _take(self, count: int) -> torch.Tensor:
        out = self.elems[self.off : self.off + count]
        self.off += count
        return out

    def fq_block(self, count: int) -> torch.Tensor:
        """(count, 24) -> (24, count)."""
        return self._take(count).t().contiguous()

    def g1_block(self, count: int):
        """x and y interleave: (count, 2, 24) -> (x, y), each (24, count)."""
        xy = self._take(2 * count).view(count, 2, N_WORDS).permute(1, 2, 0).contiguous()
        return xy[0], xy[1]

    def g2_block(self, count: int, deg: int):
        """(count, 2, deg, 24) -> (x, y), each (deg, 24, count)."""
        xy = self._take(2 * deg * count).view(count, 2, deg, N_WORDS).permute(1, 2, 3, 0)
        xy = xy.contiguous()
        return xy[0], xy[1]


class DeviceReader:
    """The challenge files read straight onto ``device``.

    ``upload`` reads a file once, ``chunk_bytes`` at a time, into two
    reused host buffers (pinned for a CUDA device) and copies
    each chunk into one raw ``uint8`` tensor on the device with
    ``non_blocking=True``, so that reading chunk i + 1 overlaps the copy of
    chunk i; a buffer is refilled only after the event of its last copy.
    ``read_params`` / ``read_input`` then unpack on the device: the header
    (16 bytes, the only bytes brought back), the size checks of the numpy
    reader, an ``int32`` view of the body (every block starts at a multiple
    of 4 bytes) and one transposing copy a block.  The words equal the
    numpy reader's.  Nothing falls back to the numpy reader: a failure to
    pin, copy or unpack raises."""

    def __init__(self, device, chunk_bytes: int = 64 << 20):
        if chunk_bytes < 1:
            raise ValueError("DeviceReader needs chunk_bytes >= 1")
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=self._cuda)
                      for _ in range(2)]
        self._copied = [None, None]  # CUDA event of the last copy out of each buffer

    def upload(self, path) -> torch.Tensor:
        """The file's bytes as one ``uint8`` tensor on the device."""
        with open(path, "rb", buffering=0) as f:
            size = os.fstat(f.fileno()).st_size
            raw = torch.empty(size, dtype=torch.uint8, device=self.device)
            off, i = 0, 0
            while off < size:
                j = i % len(self._bufs)
                if self._copied[j] is not None:
                    self._copied[j].synchronize()
                n = min(size - off, self._bufs[j].numel())
                buf = self._bufs[j][:n]
                view, got = memoryview(buf.numpy()), 0
                while got < n:
                    k = f.readinto(view[got:])
                    if not k:
                        raise ValueError(f"{path}: file ended at {off + got} of {size} bytes")
                    got += k
                raw[off : off + n].copy_(buf, non_blocking=True)
                if self._cuda:
                    self._copied[j] = torch.cuda.Event()
                    self._copied[j].record()
                off += n
                i += 1
        return raw

    @staticmethod
    def _elements(raw: torch.Tensor, start: int, count: int) -> torch.Tensor:
        """``count`` 96-byte elements from byte ``start`` as an (count, 24) int32 view."""
        return raw[start : start + count * FQ_BYTES].view(torch.int32).view(count, N_WORDS)

    def read_params(self, path, g2_deg: int) -> Groth16Params:
        raw = self.upload(path)
        if raw.numel() < HEADER_BYTES:
            raise ValueError("file shorter than its header says")
        d, m = struct.unpack("<QQ", raw[:HEADER_BYTES].cpu().numpy().tobytes())
        if m < 1:
            raise ValueError(f"params header: m = {m}, at least 1 expected")
        count = _params_elements(d, m, g2_deg)
        _check_size(raw.numel(), HEADER_BYTES + count * FQ_BYTES, "params")
        r = _Blocks(self._elements(raw, HEADER_BYTES, count))
        A = r.g1_block(m + 1)
        B1 = r.g1_block(m + 1)
        B2 = r.g2_block(m + 1, g2_deg)
        L = r.g1_block(m - 1)
        H = r.g1_block(d)
        return Groth16Params(d, m, A, B1, B2, L, H)

    def read_input(self, path, d: int, m: int) -> Groth16Input:
        raw = self.upload(path)
        count = (m + 1) + 3 * (d + 1) + 1
        _check_size(raw.numel(), count * FQ_BYTES, "input")
        r = _Blocks(self._elements(raw, 0, count))
        w = r.fq_block(m + 1)
        ca, cb, cc = (r.fq_block(d + 1) for _ in range(3))
        return Groth16Input(w, ca, cb, cc, r.fq_block(1))


def write_proof(path, A, B, C) -> bytes:
    """A, C: affine G1 (x, y, z word arrays); B: affine G2.  Writes the
    file when ``path`` is given; returns the bytes either way."""
    w = Writer()
    w.g1(*A)
    w.g2(*B)
    w.g1(*C)
    data = w.bytes()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


# points a chunk of the writers: 2^18 G1 points are 48 MB of file
_WRITE_POINTS = 1 << 18


def _write_rows(f, rows: torch.Tensor):
    """A contiguous int32 tensor's bytes, brought to the host."""
    f.write(rows.cpu().numpy().tobytes())


def write_g1_block(f, x: torch.Tensor, y: torch.Tensor):
    """Affine G1 points (x, y), each (24, count) Montgomery words on any
    device, x then y a point; an identity stored as (0, 0) gives 192 zero
    bytes.  The interleaving runs on the words' device, a chunk at a time."""
    for i in range(0, x.shape[-1], _WRITE_POINTS):
        part = torch.stack([x[:, i : i + _WRITE_POINTS], y[:, i : i + _WRITE_POINTS]])
        _write_rows(f, part.permute(2, 0, 1).contiguous())  # (count, 2, 24)


def write_g2_block(f, x: torch.Tensor, y: torch.Tensor):
    """Affine G2 points, x and y each (deg, 24, count): per point x's
    components, then y's."""
    for i in range(0, x.shape[-1], _WRITE_POINTS):
        part = torch.stack([x[..., i : i + _WRITE_POINTS], y[..., i : i + _WRITE_POINTS]])
        _write_rows(f, part.permute(3, 0, 1, 2).contiguous())  # (count, 2, deg, 24)


def write_params(path, d: int, m: int, A, B1, B2, L, H):
    """The params file (main.cpp:50-61 layout) from affine queries (x, y)
    of word tensors (identities stored as (0, 0)): A and B1 of m + 1
    points, B2 of m + 1 G2 points, L of m - 1 and H of d."""
    counts = {"A": (A, m + 1), "B1": (B1, m + 1), "B2": (B2, m + 1), "L": (L, m - 1), "H": (H, d)}
    for key, (q, count) in counts.items():
        if q[0].shape[-1] != count:
            raise ValueError(f"params {key}: {q[0].shape[-1]} points, {count} expected")
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", d, m))
        write_g1_block(f, *A)
        write_g1_block(f, *B1)
        write_g2_block(f, *B2)
        write_g1_block(f, *L)
        write_g1_block(f, *H)


def write_input(path, w: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor,
                r: torch.Tensor):
    """The input file (main.cpp:63-83 layout) from Montgomery word tensors
    (24, count) on any device: w (m + 1), ca, cb, cc (d + 1 each), r (1)."""
    with open(path, "wb") as f:
        for block in (w, ca, cb, cc, r):
            _write_rows(f, block.reshape(N_WORDS, -1).t().contiguous())
