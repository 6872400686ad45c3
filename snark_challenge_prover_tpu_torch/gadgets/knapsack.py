"""Knapsack (subset-sum) CRH + set-commitment gadgets.

Counterpart of the JAX package's ``gadgets/knapsack.py`` (the same
coefficients, so the same digests), on the port's protoboard.

Capability parity with gadgetlib1/gadgets/hashes/knapsack
(knapsack_gadget.{hpp,tcc}) and gadgetlib1/gadgets/set_commitment
(set_commitment_gadget.{hpp,tcc}) — the hash/accumulator pair the
multi-predicate PCD uses to authenticate verification keys inside the
step circuit (mp_pcd_circuits.hpp): a vk enters as WITNESS wires and a
set-membership proof shows its digest lies in the committed vk set.

knapsack_CRH_with_field_out_gadget (dimension 1, the reference's
knapsack_dimension<FieldT>::dimension): H(b_0..b_{m-1}) =
sum_i a_i * b_i over Fr, with pseudorandom public coefficients a_i —
ONE R1CS constraint per digest element, which is why libsnark can
afford to hash whole verification keys in-circuit (SHA256 would cost
~27k constraints per block).  Coefficients here derive from SHA256
counters (the reference seeds its coefficient vector from a PRG the
same way, knapsack_gadget.tcc knapsack_coefficients).

set_commitment_gadget: a Merkle tree over knapsack digests; each level
re-hashes [left_bits || right_bits] with child order chosen by an
address bit.  Membership proofs carry the sibling digests + address
bits as witnesses.
"""

from __future__ import annotations

import hashlib

from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .basic_gadgets import generate_boolean_r1cs_constraint
from .protoboard import Gadget, PBVariable, PBVariableArray, Protoboard


def knapsack_coefficients(p: int, n: int, seed: bytes = b"snark-tpu-knapsack"):
    """Deterministic public coefficients a_0..a_{n-1} in Fr — the PRG
    expansion of knapsack_gadget.tcc's coefficient vector."""
    out = []
    i = 0
    while len(out) < n:
        h = hashlib.sha256(seed + i.to_bytes(8, "little")).digest()
        h += hashlib.sha256(h).digest()
        h += hashlib.sha256(h).digest()
        h += hashlib.sha256(h).digest()  # 128 bytes > 753 bits
        v = int.from_bytes(h[:96], "little") % p
        out.append(v)
        i += 1
    return out


def knapsack_hash_bits(p: int, bits) -> int:
    """Host evaluation: H(bits) = sum a_i * b_i mod p."""
    coeffs = knapsack_coefficients(p, len(bits))
    acc = 0
    for a, b in zip(coeffs, bits):
        if b:
            acc = (acc + a) % p
    return acc


def field_to_bits(p: int, x: int):
    """Fixed-width LSB-first bit vector covering Fr."""
    n = p.bit_length()
    return [(x >> i) & 1 for i in range(n)]


def knapsack_hash_fields(p: int, elems) -> int:
    """Hash a list of field elements (bit-concatenated, LSB-first)."""
    bits = []
    for e in elems:
        bits += field_to_bits(p, e % p)
    return knapsack_hash_bits(p, bits)


class KnapsackCRHGadget(Gadget):
    """digest = sum a_i * bit_i: one constraint (bitness enforced by the
    callers that allocate the bits)."""

    def __init__(self, pb: Protoboard, bits, digest: PBVariable,
                 annotation: str = "knapsack"):
        super().__init__(pb, annotation)
        self.bits = bits
        self.digest = digest
        coeffs = knapsack_coefficients(pb.p, len(bits))
        acc = LC.constant(0)
        for a, b in zip(coeffs, bits):
            acc = acc + (b.lc(a) if isinstance(b, PBVariable) else LC.constant(a * b))
        pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1), acc, digest.lc()),
            f"{annotation}.sum",
        )

    def generate_r1cs_witness(self):
        vals = [self.pb.val(b) if isinstance(b, PBVariable) else b
                for b in self.bits]
        self.pb.set_val(self.digest, knapsack_hash_bits(self.pb.p, vals))


class FieldBitsGadget(Gadget):
    """LSB-first bit decomposition of a field wire (packing + bitness +
    strict canonical bound via the standard big-endian comparison trick
    is NOT applied — matching packing_gadget semantics, which the
    reference's set_commitment path uses)."""

    def __init__(self, pb: Protoboard, packed, annotation: str = "bits"):
        super().__init__(pb, annotation)
        n = pb.p.bit_length()
        self.packed = packed
        self.bits = PBVariableArray.allocate(pb, n, f"{annotation}.b")
        for b in self.bits:
            generate_boolean_r1cs_constraint(pb, b, annotation)
        acc = LC.constant(0)
        for i, b in enumerate(self.bits):
            acc = acc + b.lc(1 << i)
        pk = packed.lc() if isinstance(packed, PBVariable) else packed
        pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1), acc, pk), f"{annotation}.pack"
        )

    def generate_r1cs_witness(self):
        v = (self.pb.lc_val(self.packed.lc())
             if isinstance(self.packed, PBVariable)
             else self.pb.lc_val(self.packed))
        for i, b in enumerate(self.bits):
            self.pb.set_val(b, (v >> i) & 1)


def merkle_knapsack_root(p: int, leaves) -> int:
    """Host Merkle root over knapsack digests (power-of-two leaf count,
    parent = H(bits(left) || bits(right)))."""
    level = [v % p for v in leaves]
    assert level and (len(level) & (len(level) - 1)) == 0
    while len(level) > 1:
        level = [
            knapsack_hash_fields(p, [level[2 * i], level[2 * i + 1]])
            for i in range(len(level) // 2)
        ]
    return level[0]


def merkle_knapsack_path(p: int, leaves, index: int):
    """(address_bits LSB-first, sibling digests leaf->root)."""
    level = [v % p for v in leaves]
    path = []
    bits = []
    idx = index
    while len(level) > 1:
        sib = level[idx ^ 1]
        path.append(sib)
        bits.append(idx & 1)
        level = [
            knapsack_hash_fields(p, [level[2 * i], level[2 * i + 1]])
            for i in range(len(level) // 2)
        ]
        idx >>= 1
    return bits, path


class SetCommitmentGadget(Gadget):
    """Prove a leaf digest is in the tree under `root`:
    set_commitment_gadget parity.  The leaf digest, address bits and
    sibling digests are wires; every level hashes
    [bits(child order-selected), bits(other)] with the knapsack CRH."""

    def __init__(self, pb: Protoboard, depth: int, leaf: PBVariable,
                 root, annotation: str = "setc"):
        super().__init__(pb, annotation)
        self.depth = depth
        self.leaf = leaf
        self.address_bits = [pb.allocate_var(f"{annotation}.addr{k}")
                             for k in range(depth)]
        self.siblings = [pb.allocate_var(f"{annotation}.sib{k}")
                         for k in range(depth)]
        self._subs = []
        cur = leaf
        for k in range(depth):
            ab = self.address_bits[k]
            generate_boolean_r1cs_constraint(pb, ab, f"{annotation}.a{k}")
            sib = self.siblings[k]
            # left = ab ? sib : cur ; right = ab ? cur : sib
            left = pb.allocate_var(f"{annotation}.l{k}")
            right = pb.allocate_var(f"{annotation}.r{k}")
            pb.add_r1cs_constraint(
                R1CSConstraint(ab.lc(), sib.lc() - cur.lc(),
                               left.lc() - cur.lc()),
                f"{annotation}.sel_l{k}",
            )
            pb.add_r1cs_constraint(
                R1CSConstraint(ab.lc(), cur.lc() - sib.lc(),
                               right.lc() - sib.lc()),
                f"{annotation}.sel_r{k}",
            )
            lb = FieldBitsGadget(pb, left, f"{annotation}.lb{k}")
            rb = FieldBitsGadget(pb, right, f"{annotation}.rb{k}")
            parent = pb.allocate_var(f"{annotation}.h{k}")
            crh = KnapsackCRHGadget(
                pb, list(lb.bits) + list(rb.bits), parent,
                f"{annotation}.crh{k}",
            )
            self._subs.append((ab, sib, left, right, lb, rb, crh, parent))
            cur = parent
        # root binding
        r = root.lc() if isinstance(root, PBVariable) else root
        pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1), cur.lc(), r),
            f"{annotation}.root",
        )

    def generate_r1cs_witness(self, address_bits, siblings):
        pb = self.pb
        for var, val in zip(self.address_bits, address_bits):
            pb.set_val(var, int(val))
        for var, val in zip(self.siblings, siblings):
            pb.set_val(var, int(val) % pb.p)
        cur = pb.val(self.leaf)
        for (ab, sib, left, right, lb, rb, crh, parent) in self._subs:
            a = pb.val(ab)
            s = pb.val(sib)
            lv, rv = (s, cur) if a else (cur, s)
            pb.set_val(left, lv)
            pb.set_val(right, rv)
            lb.generate_r1cs_witness()
            rb.generate_r1cs_witness()
            crh.generate_r1cs_witness()
            cur = pb.val(parent)
