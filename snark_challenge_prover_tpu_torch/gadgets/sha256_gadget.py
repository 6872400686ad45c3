"""SHA256 as R1CS gadgets — gadgetlib1/gadgets/hashes/sha256 parity.

Counterpart of the JAX package's ``gadgets/sha256_gadget.py`` (the same
constraints in the same order), on the port's protoboard.  It implements
the SHA256 compression function over boolean protoboard variables
(words = 32 bits, LSB-first internally), exactly the gadget set the
reference library builds Merkle trees from:

  * xor2/xor3 bit gadgets (1 constraint each xor)
  * Ch / Maj round functions (1 / 2 constraints per bit)
  * modular additions as one packing constraint + boolean carry bits
  * sigma rotations as free bit rewiring
  * `Sha256CompressionGadget` (libsnark sha256_compression_function_gadget)
  * `Sha256TwoToOneGadget` (sha256_two_to_one_hash_gadget: a single
    compression over left||right, the Merkle-tree node hash)

Constraint counts come out at the same order as the reference (~27k per
compression).  `host_compress` is the exact host mirror used for witness
generation and is validated against hashlib in tests.
"""

from __future__ import annotations

from .basic_gadgets import generate_boolean_r1cs_constraint as generate_boolean_constraint
from .protoboard import Gadget, PBVariable, Protoboard
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint

# SHA256 constants (FIPS 180-4)
IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def host_compress(state: list[int], block_words: list[int]) -> list[int]:
    """The exact SHA256 compression function on host ints (FIPS 180-4);
    the gadget witness mirror."""
    w = list(block_words)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[i] + w[i]) & 0xFFFFFFFF
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & 0xFFFFFFFF
        h, g, f, e, d, c, b, a = (
            g, f, e, (d + t1) & 0xFFFFFFFF, c, b, a, (t1 + t2) & 0xFFFFFFFF
        )
    return [
        (x + y) & 0xFFFFFFFF
        for x, y in zip(state, [a, b, c, d, e, f, g, h])
    ]


# ---------------------------------------------------------------------------
# bit plumbing: a "bit" is a PBVariable or a Python int 0/1
# ---------------------------------------------------------------------------

def _bit_lc(bit) -> LC:
    if isinstance(bit, PBVariable):
        return bit.lc()
    return LC.constant(int(bit))


def _bit_val(pb, bit) -> int:
    return pb.val(bit) if isinstance(bit, PBVariable) else int(bit)


class Word:
    """32 bits, LSB-first.  Rotations/shifts are free rewiring."""

    def __init__(self, bits):
        if len(bits) != 32:
            raise ValueError(f"a word has 32 bits, not {len(bits)}")
        self.bits = list(bits)

    @classmethod
    def allocate(cls, pb: Protoboard, annotation: str = "") -> "Word":
        return cls([pb.allocate_var(f"{annotation}.{i}") for i in range(32)])

    @classmethod
    def constant(cls, value: int) -> "Word":
        return cls([(value >> i) & 1 for i in range(32)])

    def rotr(self, n: int) -> "Word":
        return Word([self.bits[(i + n) % 32] for i in range(32)])

    def shr(self, n: int) -> "Word":
        return Word([self.bits[i + n] if i + n < 32 else 0 for i in range(32)])

    def packed_lc(self) -> LC:
        out = LC()
        for i, b in enumerate(self.bits):
            if isinstance(b, PBVariable):
                out = out + b.lc(1 << i)
            elif b:
                out = out + LC.constant(1 << i)
        return out

    def value(self, pb: Protoboard) -> int:
        return sum(_bit_val(pb, b) << i for i, b in enumerate(self.bits))

    def set_value(self, pb: Protoboard, value: int):
        for i, b in enumerate(self.bits):
            if isinstance(b, PBVariable):
                pb.set_val(b, (value >> i) & 1)
            elif b != (value >> i) & 1:
                raise ValueError(f"bit {i} of the word is the constant {b}")

    def boolify(self, pb: Protoboard):
        for b in self.bits:
            if isinstance(b, PBVariable):
                generate_boolean_constraint(pb, b)


class _BitOps:
    """xor/ch/maj bit gadgets with constant-bit short-circuits."""

    def __init__(self, pb: Protoboard):
        self.pb = pb
        self._wit = []  # deferred witness closures, in constraint order

    def xor2(self, a, b):
        pb = self.pb
        if not isinstance(a, PBVariable) and not isinstance(b, PBVariable):
            return int(a) ^ int(b)
        if not isinstance(a, PBVariable):
            a, b = b, a
        if not isinstance(b, PBVariable):
            if int(b) == 0:
                return a
            # a ^ 1 = 1 - a: representable as an LC only; allocate to keep
            # bits as variables (rare: only from shr-introduced constants)
            out = pb.allocate_var("xor_const")
            pb.add_r1cs_constraint(
                R1CSConstraint(_bit_lc(a), LC.constant(1),
                               LC.constant(1) - out.lc()),
                "xor1",
            )
            self._wit.append(lambda: pb.set_val(out, 1 - pb.val(a)))
            return out
        # out = a + b - 2ab  <=>  (2a) * b = a + b - out
        out = pb.allocate_var("xor")
        pb.add_r1cs_constraint(
            R1CSConstraint(a.lc(2), b.lc(), a.lc() + b.lc() - out.lc()),
            "xor2",
        )
        self._wit.append(
            lambda: pb.set_val(out, pb.val(a) ^ pb.val(b))
        )
        return out

    def xor3(self, a, b, c):
        return self.xor2(self.xor2(a, b), c)

    def ch(self, e, f, g):
        """ch = g + e*(f - g): 1 constraint."""
        pb = self.pb
        out = pb.allocate_var("ch")
        pb.add_r1cs_constraint(
            R1CSConstraint(_bit_lc(e), _bit_lc(f) - _bit_lc(g),
                           out.lc() - _bit_lc(g)),
            "ch",
        )
        self._wit.append(
            lambda: pb.set_val(
                out,
                (_bit_val(pb, e) & _bit_val(pb, f))
                ^ ((1 - _bit_val(pb, e)) & _bit_val(pb, g)),
            )
        )
        return out

    def maj(self, a, b, c):
        """t = b*c; maj = t + a*(b + c - 2t): 2 constraints."""
        pb = self.pb
        t = pb.allocate_var("maj_t")
        pb.add_r1cs_constraint(
            R1CSConstraint(_bit_lc(b), _bit_lc(c), t.lc()), "maj_bc"
        )
        out = pb.allocate_var("maj")
        pb.add_r1cs_constraint(
            R1CSConstraint(
                _bit_lc(a), _bit_lc(b) + _bit_lc(c) - t.lc(2),
                out.lc() - t.lc(),
            ),
            "maj",
        )

        def wit():
            bv, cv, av = _bit_val(pb, b), _bit_val(pb, c), _bit_val(pb, a)
            pb.set_val(t, bv & cv)
            pb.set_val(out, (av & bv) ^ (av & cv) ^ (bv & cv))

        self._wit.append(wit)
        return out

    def xor_word(self, *words):
        n = len(words)
        bits = []
        for i in range(32):
            if n == 2:
                bits.append(self.xor2(words[0].bits[i], words[1].bits[i]))
            else:
                bits.append(
                    self.xor3(words[0].bits[i], words[1].bits[i], words[2].bits[i])
                )
        return Word(bits)

    def add_mod32(self, lcs_and_words, consts: int = 0):
        """Sum of words/LCs + constant, mod 2^32: allocate a result word
        and carry bits; ONE packing constraint + booleanity."""
        pb = self.pb
        k = len(lcs_and_words) + (1 if consts else 0)
        ncarry = max(1, (k - 1).bit_length())
        total = LC.constant(consts % pb.p)
        for w in lcs_and_words:
            total = total + (w.packed_lc() if isinstance(w, Word) else w)
        out = Word.allocate(pb, "sum")
        out.boolify(pb)
        carries = [pb.allocate_var("carry") for _ in range(ncarry)]
        for cv in carries:
            generate_boolean_constraint(pb, cv)
        rhs = out.packed_lc()
        for j, cv in enumerate(carries):
            rhs = rhs + cv.lc(1 << (32 + j))
        pb.add_r1cs_constraint(
            R1CSConstraint(total, LC.constant(1), rhs), "add_mod32"
        )
        words = [w for w in lcs_and_words]

        def wit():
            s = consts
            for w in words:
                s += w.value(pb) if isinstance(w, Word) else pb.lc_val(w)
            out.set_value(pb, s & 0xFFFFFFFF)
            c = s >> 32
            for j, cv in enumerate(carries):
                pb.set_val(cv, (c >> j) & 1)

        self._wit.append(wit)
        return out

    def run_witness(self):
        for fn in self._wit:
            fn()


class Sha256CompressionGadget(Gadget):
    """sha256_compression_function_gadget: new_state = compress(state,
    block).  `state_words` and `block_words` are lists of 8/16 Words
    whose bit values the caller sets before generate_r1cs_witness."""

    def __init__(self, pb: Protoboard, state_words, block_words,
                 annotation: str = "sha256"):
        super().__init__(pb, annotation)
        if len(state_words) != 8 or len(block_words) != 16:
            raise ValueError("the compression takes 8 state words and 16 block words")
        self.state = state_words
        self.block = block_words
        self.ops = _BitOps(pb)
        self._build()

    def _build(self):
        ops = self.ops
        w = list(self.block)
        for i in range(16, 64):
            s0 = ops.xor_word(
                w[i - 15].rotr(7), w[i - 15].rotr(18), w[i - 15].shr(3)
            )
            s1 = ops.xor_word(
                w[i - 2].rotr(17), w[i - 2].rotr(19), w[i - 2].shr(10)
            )
            w.append(ops.add_mod32([w[i - 16], s0, w[i - 7], s1]))
        a, b, c, d, e, f, g, h = self.state
        for i in range(64):
            S1 = ops.xor_word(e.rotr(6), e.rotr(11), e.rotr(25))
            ch = Word([ops.ch(e.bits[j], f.bits[j], g.bits[j]) for j in range(32)])
            t1 = ops.add_mod32([h, S1, ch, w[i]], consts=K[i])
            S0 = ops.xor_word(a.rotr(2), a.rotr(13), a.rotr(22))
            maj = Word([ops.maj(a.bits[j], b.bits[j], c.bits[j]) for j in range(32)])
            t2 = ops.add_mod32([S0, maj])
            h, g, f = g, f, e
            e = ops.add_mod32([d, t1])
            d, c, b = c, b, a
            a = ops.add_mod32([t1, t2])
        self.out = [
            ops.add_mod32([s, v])
            for s, v in zip(self.state, [a, b, c, d, e, f, g, h])
        ]

    def generate_r1cs_constraints(self):
        pass  # constraints are emitted during _build

    def generate_r1cs_witness(self):
        """Caller must have set state/block word values first."""
        self.ops.run_witness()

    def output_values(self):
        return [w.value(self.pb) for w in self.out]


class Sha256TwoToOneGadget(Gadget):
    """sha256_two_to_one_hash_gadget: h = compress(IV, left || right) —
    the Merkle node hash (one compression, no padding, as in libsnark)."""

    def __init__(self, pb: Protoboard, left_words, right_words,
                 annotation: str = "sha256_2to1"):
        super().__init__(pb, annotation)
        if len(left_words) != 8 or len(right_words) != 8:
            raise ValueError("each half of the two-to-one hash is 8 words")
        iv = [Word.constant(v) for v in IV]
        self.inner = Sha256CompressionGadget(
            pb, iv, list(left_words) + list(right_words), annotation
        )
        self.out = self.inner.out

    def generate_r1cs_constraints(self):
        pass

    def generate_r1cs_witness(self):
        self.inner.generate_r1cs_witness()

    def output_values(self):
        return self.inner.output_values()


def host_two_to_one(left_words: list[int], right_words: list[int]) -> list[int]:
    return host_compress(IV, list(left_words) + list(right_words))
