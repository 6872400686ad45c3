"""libsnark's iostream bytes for Groth16 keys and proofs: the layout behind
the caml string entry points (caml_mnt4753.cpp:644-660
proving_key_to_string / of_string, verification_key_*, proof_*).

Counterpart of the JAX package's ``io/caml_serialization.py``, on the port's
``groth16_full`` objects.  The reference builds with BINARY_OUTPUT and
MONTGOMERY_OUTPUT and without point compression, so libsnark writes:

  * an Fq element: its 12 64-bit Montgomery limbs, 96 bytes little-endian
    (libff bigint.tcc operator<<, fp.tcc:779-790);
  * Fq2 / Fq3 / Fq4 / Fq6: the components one after the other (no
    separator under BINARY_OUTPUT, libff serialization.hpp:64-65);
  * a G1 / G2 point: '1' for the identity, '0' otherwise, then affine x
    and y (mnt4753_g1.cpp:389-403); the identity as x = 0, y = 1;
  * vector<T>: its size in ASCII decimal and "\\n", then the elements
    (mnt4753_g1.cpp:452-461); sparse_vector<T>: the domain size, the
    number of indices, the indices, each a line, then the value vector
    (sparse_vector.tcc:272-288); accumulation_vector<T>: the first
    element, then the rest as a sparse vector (accumulation_vector.tcc:63-69);
    knowledge_commitment<T1, T2>: g then h (knowledge_commitment.tcc:121);
  * an R1CS: the input sizes and the number of constraints, each a line,
    then a, b, c of each constraint as (#terms, then index and coefficient
    a term) and an is_square character (r1cs.tcc:67-76, 254-264;
    variable.tcc:411-421);
  * the proving key: alpha_g1 beta_g1 beta_g2 delta_g1 delta_g2 A_query
    B_query (a sparse vector of knowledge commitments, G2 then G1, the
    identity entries dropped as libsnark's generator drops them) H_query
    L_query and the constraint system (r1cs_gg_ppzksnark.tcc:52-97); the
    verification key: alpha_g1_beta_g2 delta_g2 ABC_g1 (tcc:99-119); the
    proof: A B C (tcc:165-185).

The port's R = 2^768 is libsnark's for twelve 64-bit limbs, so a query
coordinate's 96 bytes are its 24 Montgomery words as they stand: whole
queries are written and read as numpy records, with no conversion a point.
The port stores the identity as (0, 0); the bytes hold it as '1', x = 0
and y = Montgomery 1.  The single points and the verification key are
host affine integers (None for the identity), as in ``groth16_full``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.curves import host_curve
from ..ops.field import resolve_device
from ..proof_systems.groth16_full import Proof, ProvingKey, VerificationKey
from ..relations.r1cs import LinearCombination, R1CSConstraint, R1CSConstraintSystem
from ..utils.bigint import N_WORDS, int_to_words

FQ_BYTES = 96
_ZERO, _ONE = ord("0"), ord("1")


def _specs(curve: str):
    """(Fq spec, Fr spec, G2 degree) of a curve."""
    hc = host_curve(curve)
    return hc.fq_spec, hc.fr_spec, hc.g2.F.deg


class Writer:
    def __init__(self):
        self.parts = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def size(self, n: int):
        self.parts.append(str(int(n)).encode() + b"\n")

    def fq_mont(self, spec, v_canonical: int):
        self.parts.append(spec.to_mont(v_canonical).to_bytes(FQ_BYTES, "little"))

    def ext(self, spec, comps):
        for c in comps:
            self.fq_mont(spec, c)

    def g1(self, spec, P):
        """A host affine point (None: the identity)."""
        zero = P is None or (P[0] == 0 and P[1] == 0)
        x, y = (0, 1) if zero else P
        self.raw(b"1" if zero else b"0")
        self.fq_mont(spec, x)
        self.fq_mont(spec, y)

    def g2(self, spec, P, deg: int):
        """A host affine point over Fq^deg (None: the identity).  A point of
        zero components is flagged as the identity and written as it is,
        as the JAX package's writer does."""
        if P is None:
            comps_x, comps_y, zero = (0,) * deg, (1,) + (0,) * (deg - 1), True
        else:
            comps_x, comps_y = (list(P[0]), list(P[1])) if deg > 1 else ([P[0]], [P[1]])
            zero = not any(comps_x) and not any(comps_y)
        self.raw(b"1" if zero else b"0")
        self.ext(spec, comps_x)
        self.ext(spec, comps_y)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.off = 0

    def take(self, n: int) -> memoryview:
        if self.off + n > len(self.data):
            raise ValueError("the bytes end inside an element")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def char(self) -> int:
        return self.take(1)[0]

    def size(self) -> int:
        end = bytes(self.data[self.off : self.off + 32]).find(b"\n")
        if end < 0:
            raise ValueError("a size line does not end")
        n = int(bytes(self.take(end)))
        self.off += 1
        return n

    def fq_canonical(self, spec) -> int:
        return spec.from_mont(int.from_bytes(self.take(FQ_BYTES), "little"))

    def ext(self, spec, deg: int):
        return tuple(self.fq_canonical(spec) for _ in range(deg))

    def g1(self, spec):
        zero = self.char() == _ONE
        x, y = self.fq_canonical(spec), self.fq_canonical(spec)
        return None if zero else (x, y)

    def g2(self, spec, deg: int):
        zero = self.char() == _ONE
        x, y = self.ext(spec, deg), self.ext(spec, deg)
        if deg == 1:
            x, y = x[0], y[0]
        return None if zero else (x, y)


# ---------------------------------------------------------------------------
# whole queries: numpy records straight from and to the Montgomery words
# ---------------------------------------------------------------------------

def _word_bytes(w: np.ndarray) -> np.ndarray:
    """int32[24, N] words -> uint8[N, 96], little-endian."""
    return np.ascontiguousarray(w.T).view(np.uint32).astype("<u4").view(np.uint8)


def _words_of(b: np.ndarray) -> np.ndarray:
    """uint8[N, 96] little-endian -> int32[24, N] words."""
    return np.ascontiguousarray(np.ascontiguousarray(b).view("<u4").astype(np.uint32).T).view(np.int32)


def _records(spec, pair, deg: int) -> np.ndarray:
    """An affine query (x, y), each int32[24, N] or [deg, 24, N] Montgomery
    words with the identity as (0, 0) -> its points' bytes, uint8[N, 1 + 2
    deg 96]: the flag, x's components, y's, the identity as x = 0, y = 1."""
    x, y = (t.cpu().numpy().reshape(deg, N_WORDS, -1) for t in pair)
    n = x.shape[-1]
    zero = ~(x.any(axis=(0, 1)) | y.any(axis=(0, 1)))
    one = np.zeros((deg, N_WORDS, 1), np.int32)
    one[0, :, 0] = int_to_words(spec.to_mont(1))
    y = np.where(zero, one, y)
    rec = np.empty((n, _record_width(deg)), np.uint8)
    rec[:, 0] = np.where(zero, _ONE, _ZERO)
    for k, w in enumerate(list(x) + list(y)):
        rec[:, 1 + k * FQ_BYTES : 1 + (k + 1) * FQ_BYTES] = _word_bytes(w)
    return rec


def _parse_records(rec: np.ndarray, deg: int):
    """Points' bytes, uint8[n, 1 + 2 deg 96] -> (x, y) words, int32[24, n]
    or [deg, 24, n], the identity as (0, 0)."""
    zero = rec[:, 0] == _ONE
    comps = [np.where(zero, np.int32(0), _words_of(rec[:, 1 + k * FQ_BYTES : 1 + (k + 1) * FQ_BYTES]))
             for k in range(2 * deg)]
    x, y = np.stack(comps[:deg]), np.stack(comps[deg:])
    return (x[0], y[0]) if deg == 1 else (x, y)


def _record_width(deg: int) -> int:
    return 1 + 2 * deg * FQ_BYTES


def _read_records(r: Reader, n: int, deg: int):
    width = _record_width(deg)
    return _parse_records(np.frombuffer(r.take(n * width), np.uint8).reshape(n, width), deg)


def _write_vector(w: Writer, spec, pair, deg: int = 1):
    rec = _records(spec, pair, deg)
    w.size(len(rec))
    w.raw(rec.tobytes())


def _read_vector(r: Reader, device, deg: int = 1):
    x, y = _read_records(r, r.size(), deg)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


# ---------------------------------------------------------------------------
# linear combinations and constraint systems (variable.tcc, r1cs.tcc)
# ---------------------------------------------------------------------------

def _write_lc(w: Writer, spec, lc: LinearCombination):
    w.size(len(lc.terms))
    for idx, coeff in lc.terms:
        w.size(idx)
        w.fq_mont(spec, coeff % spec.p)


def _read_lc(r: Reader, spec) -> LinearCombination:
    terms = []
    for _ in range(r.size()):
        idx = r.size()
        terms.append((idx, r.fq_canonical(spec)))
    return LinearCombination(terms)


def write_constraint_system(w: Writer, spec, cs: R1CSConstraintSystem):
    w.size(cs.primary_input_size)
    w.size(cs.auxiliary_input_size)
    w.size(len(cs.constraints))
    for c in cs.constraints:
        _write_lc(w, spec, c.a)
        _write_lc(w, spec, c.b)
        _write_lc(w, spec, c.c)
        w.raw(b"1" if c.is_square else b"0")


def read_constraint_system(r: Reader, spec) -> R1CSConstraintSystem:
    primary, aux, n = r.size(), r.size(), r.size()
    cs = R1CSConstraintSystem(spec.p, primary_input_size=primary, auxiliary_input_size=aux)
    for _ in range(n):
        a, b, c = _read_lc(r, spec), _read_lc(r, spec), _read_lc(r, spec)
        cs.add_constraint(R1CSConstraint(a, b, c, is_square=r.char() == _ONE))
    return cs


# ---------------------------------------------------------------------------
# proving key, verification key, proof (r1cs_gg_ppzksnark.tcc:52-185)
# ---------------------------------------------------------------------------

def proving_key_to_bytes(pk: ProvingKey) -> bytes:
    spec, fr_spec, deg = _specs(pk.curve)
    w = Writer()
    w.g1(spec, pk.alpha_g1)
    w.g1(spec, pk.beta_g1)
    w.g2(spec, pk.beta_g2, deg)
    w.g1(spec, pk.delta_g1)
    w.g2(spec, pk.delta_g2, deg)
    _write_vector(w, spec, pk.A_query)
    # B_query: a sparse vector of knowledge commitments (G2, G1), the
    # entries whose both halves are the identity dropped
    g2_rec, g1_rec = _records(spec, pk.B_query_g2, deg), _records(spec, pk.B_query_g1, 1)
    present = np.flatnonzero((g2_rec[:, 0] == _ZERO) | (g1_rec[:, 0] == _ZERO))
    w.size(len(g2_rec))   # domain size
    w.size(len(present))  # indices
    w.raw(b"".join(b"%d\n" % i for i in present))
    w.size(len(present))  # values
    w.raw(np.concatenate([g2_rec[present], g1_rec[present]], axis=1).tobytes())
    _write_vector(w, spec, pk.H_query)
    _write_vector(w, spec, pk.L_query)
    write_constraint_system(w, fr_spec, pk.constraint_system)
    return w.bytes()


def proving_key_from_bytes(curve: str, data: bytes, device="cuda") -> ProvingKey:
    """The proving key of ``proving_key_to_bytes``, its queries on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    spec, fr_spec, deg = _specs(curve)
    r = Reader(data)
    alpha_g1, beta_g1, beta_g2 = r.g1(spec), r.g1(spec), r.g2(spec, deg)
    delta_g1, delta_g2 = r.g1(spec), r.g2(spec, deg)
    A = _read_vector(r, dev)
    domain, n_idx = r.size(), r.size()
    idxs = np.array([r.size() for _ in range(n_idx)], np.int64)
    if r.size() != n_idx:
        raise ValueError("B_query: as many values as indices expected")
    width2 = _record_width(deg)
    rec = np.frombuffer(r.take(n_idx * (width2 + _record_width(1))), np.uint8).reshape(n_idx, -1)
    b2, b1 = _parse_records(rec[:, :width2], deg), _parse_records(rec[:, width2:], 1)

    def scatter(vals):
        out = np.zeros(vals.shape[:-1] + (domain,), np.int32)
        out[..., idxs] = vals
        return torch.from_numpy(out).to(dev)

    H, L = _read_vector(r, dev), _read_vector(r, dev)
    cs = read_constraint_system(r, fr_spec)
    return ProvingKey(curve=curve, alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
                      delta_g1=delta_g1, delta_g2=delta_g2, A_query=A,
                      B_query_g2=tuple(scatter(v) for v in b2),
                      B_query_g1=tuple(scatter(v) for v in b1),
                      H_query=H, L_query=L, constraint_system=cs)


def verification_key_to_bytes(vk: VerificationKey) -> bytes:
    spec, _, deg = _specs(vk.curve)
    w = Writer()
    for half in vk.alpha_g1_beta_g2:  # a GT element: its components in order
        w.ext(spec, list(half) if deg > 1 else [half])
    w.g2(spec, vk.delta_g2, deg)
    # ABC_g1: an accumulation vector, the first point then the rest as a
    # sparse vector over all of its indices
    w.g1(spec, vk.ABC_g1[0])
    rest = vk.ABC_g1[1:]
    w.size(len(rest))
    w.size(len(rest))
    for i in range(len(rest)):
        w.size(i)
    w.size(len(rest))
    for P in rest:
        w.g1(spec, P)
    return w.bytes()


def verification_key_from_bytes(curve: str, data: bytes) -> VerificationKey:
    spec, _, deg = _specs(curve)
    r = Reader(data)
    c0, c1 = r.ext(spec, deg), r.ext(spec, deg)
    delta_g2 = r.g2(spec, deg)
    first = r.g1(spec)
    domain, n_idx = r.size(), r.size()
    idxs = [r.size() for _ in range(n_idx)]
    vals = [r.g1(spec) for _ in range(r.size())]
    rest = [None] * domain
    for i, v in zip(idxs, vals):
        rest[i] = v
    return VerificationKey(curve=curve,
                           alpha_g1_beta_g2=(c0, c1) if deg > 1 else (c0[0], c1[0]),
                           delta_g2=delta_g2, ABC_g1=[first] + rest)


def proof_to_bytes_caml(curve: str, proof: Proof) -> bytes:
    spec, _, deg = _specs(curve)
    w = Writer()
    w.g1(spec, proof.g_A)
    w.g2(spec, proof.g_B, deg)
    w.g1(spec, proof.g_C)
    return w.bytes()


def proof_from_bytes_caml(curve: str, data: bytes) -> Proof:
    spec, _, deg = _specs(curve)
    r = Reader(data)
    return Proof(g_A=r.g1(spec), g_B=r.g2(spec, deg), g_C=r.g1(spec))
