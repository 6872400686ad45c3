"""Merkle tree authentication-path gadget —
gadgetlib1/gadgets/merkle_tree parity (merkle_tree_check_read_gadget):
prove that a leaf digest sits at a given address under a given root,
hashing with the SHA256 two-to-one gadget at every level.

Counterpart of the JAX package's ``gadgets/merkle_tree.py``, on the port's
protoboard and ``gadgets/sha256_gadget.py``.

The per-level child ordering is selected by the address bit with one
constraint per digest bit (digest_selector_gadget semantics)."""

from __future__ import annotations

from .protoboard import Gadget, PBVariable, Protoboard
from .basic_gadgets import generate_boolean_r1cs_constraint
from .sha256_gadget import Sha256TwoToOneGadget, Word, host_two_to_one
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint


def _select_word(pb: Protoboard, sel: PBVariable, a: Word, b: Word, wit):
    """out = sel ? b : a, bitwise: out_i - a_i = sel * (b_i - a_i)."""
    out = Word.allocate(pb, "sel")
    for i in range(32):
        ai = a.bits[i].lc() if isinstance(a.bits[i], PBVariable) else LC.constant(a.bits[i])
        bi = b.bits[i].lc() if isinstance(b.bits[i], PBVariable) else LC.constant(b.bits[i])
        pb.add_r1cs_constraint(
            R1CSConstraint(sel.lc(), bi - ai, out.bits[i].lc() - ai),
            "digest_select",
        )

    def w():
        src = b if pb.val(sel) else a
        out.set_value(pb, src.value(pb))

    wit.append(w)
    return out


class MerkleAuthPathGadget(Gadget):
    """merkle_tree_check_read_gadget: given leaf digest words, address
    bits (LSB first: bit k chooses left/right at level k from the leaf),
    and per-level sibling digests, computes the root and constrains it
    to equal `root_words`."""

    def __init__(self, pb: Protoboard, depth: int, annotation: str = "merkle"):
        super().__init__(pb, annotation)
        self.depth = depth
        self.leaf = [Word.allocate(pb, f"leaf{i}") for i in range(8)]
        self.address_bits = [pb.allocate_var(f"addr{k}") for k in range(depth)]
        self.path = [
            [Word.allocate(pb, f"path{k}.{i}") for i in range(8)]
            for k in range(depth)
        ]
        self.root = [Word.allocate(pb, f"root{i}") for i in range(8)]
        self._level_wits = []  # per level: select witnesses (run before hasher k)
        self._hashers = []
        self._build()

    def _build(self):
        pb = self.pb
        for bit in self.address_bits:
            generate_boolean_r1cs_constraint(pb, bit)
        cur = self.leaf
        for k in range(self.depth):
            sel = self.address_bits[k]  # 1 => current node is the RIGHT child
            wits = []
            left = [
                _select_word(pb, sel, cur[i], self.path[k][i], wits)
                for i in range(8)
            ]
            right = [
                _select_word(pb, sel, self.path[k][i], cur[i], wits)
                for i in range(8)
            ]
            self._level_wits.append(wits)
            h = Sha256TwoToOneGadget(pb, left, right, f"level{k}")
            self._hashers.append(h)
            cur = h.out
        # root equality: one linear constraint per word
        for i in range(8):
            pb.add_r1cs_constraint(
                R1CSConstraint(
                    cur[i].packed_lc() - self.root[i].packed_lc(),
                    LC.constant(1),
                    LC.constant(0),
                ),
                "root_eq",
            )
        self._top = cur

    def generate_r1cs_constraints(self):
        pass  # emitted in _build

    def set_witness(self, leaf_words, address: int, path_digests):
        """Assign leaf/address/path and run all internal witnesses;
        returns the computed root words (also assigned to self.root)."""
        pb = self.pb
        for w, v in zip(self.leaf, leaf_words):
            w.set_value(pb, v)
        for k in range(self.depth):
            pb.set_val(self.address_bits[k], (address >> k) & 1)
            for w, v in zip(self.path[k], path_digests[k]):
                w.set_value(pb, v)
        # level-by-level: level-k selections read hasher k-1's outputs,
        # so each level's selects run right before its hasher
        cur = leaf_words
        for k, h in enumerate(self._hashers):
            for w in self._level_wits[k]:
                w()
            h.generate_r1cs_witness()
            cur = h.output_values()
        for w, v in zip(self.root, cur):
            w.set_value(pb, v)
        return cur


def host_merkle_root(leaf_words, address: int, path_digests):
    """Host mirror of the authentication-path computation."""
    cur = list(leaf_words)
    for k, sib in enumerate(path_digests):
        if (address >> k) & 1:
            cur = host_two_to_one(list(sib), cur)
        else:
            cur = host_two_to_one(cur, list(sib))
    return cur
