"""Core gadget library.

Counterpart of the JAX package's ``gadgets/basic_gadgets.py``, on the
port's protoboard; gadgets allocate, constrain and fill in the same order.

Capability parity with gadgetlib1/gadgets/basic_gadgets.{hpp,tcc}: the
building blocks the reference's 21.5k-line gadget tree is assembled
from — boolean constraints, bit packing/unpacking, multiplication,
inner products, disjunction/conjunction, and comparison.  Each gadget
contributes constraints (generate_r1cs_constraints) and an assignment
strategy (generate_r1cs_witness), exactly the reference's two-phase
protocol.
"""

from __future__ import annotations

from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .protoboard import Gadget, PBVariable, PBVariableArray, Protoboard, _as_lc


def generate_boolean_r1cs_constraint(pb: Protoboard, var, annotation: str = ""):
    """x * (1 - x) = 0 (basic_gadgets.tcc generate_boolean_r1cs_constraint)."""
    lc = _as_lc(var)
    pb.add_r1cs_constraint(
        R1CSConstraint(lc, LC.constant(1) - lc, LC()), annotation or "boolean"
    )


class PackingGadget(Gadget):
    """bits <-> packed field element: packed = sum_i bits[i] 2^i
    (basic_gadgets.tcc packing_gadget).  One packing constraint; with
    enforce_bitness, one booleanity constraint per bit."""

    def __init__(self, pb, bits: PBVariableArray, packed: PBVariable,
                 annotation: str = "packing"):
        super().__init__(pb, annotation)
        self.bits = bits
        self.packed = packed

    def _packing_lc(self) -> LC:
        out = LC()
        for i, b in enumerate(self.bits):
            out = out + b.lc(1 << i)
        return out

    def generate_r1cs_constraints(self, enforce_bitness: bool = True):
        self.pb.add_r1cs_constraint(
            R1CSConstraint(self._packing_lc(), LC.constant(1), self.packed.lc()),
            f"{self.annotation}/pack",
        )
        if enforce_bitness:
            for i, b in enumerate(self.bits):
                generate_boolean_r1cs_constraint(
                    self.pb, b, f"{self.annotation}/bit{i}"
                )

    def generate_r1cs_witness_from_packed(self):
        v = self.pb.val(self.packed)
        for i, b in enumerate(self.bits):
            self.pb.set_val(b, (v >> i) & 1)

    def generate_r1cs_witness_from_bits(self):
        acc = 0
        for i, b in enumerate(self.bits):
            acc += self.pb.val(b) << i
        self.pb.set_val(self.packed, acc)


class MultiplicationGadget(Gadget):
    """result = a * b (mul via one constraint)."""

    def __init__(self, pb, a, b, result: PBVariable, annotation: str = "mul"):
        super().__init__(pb, annotation)
        self.a, self.b, self.result = a, b, result

    def generate_r1cs_constraints(self):
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_as_lc(self.a), _as_lc(self.b), self.result.lc()),
            self.annotation,
        )

    def generate_r1cs_witness(self):
        self.pb.set_val(
            self.result,
            self.pb.lc_val(_as_lc(self.a)) * self.pb.lc_val(_as_lc(self.b)),
        )


class InnerProductGadget(Gadget):
    """result = <A, B> via running partial sums
    (basic_gadgets.tcc inner_product_gadget: n constraints)."""

    def __init__(self, pb, A: PBVariableArray, B: PBVariableArray,
                 result: PBVariable, annotation: str = "ip"):
        assert len(A) == len(B)
        super().__init__(pb, annotation)
        self.A, self.B, self.result = A, B, result
        self.partials = PBVariableArray.allocate(pb, len(A) - 1, f"{annotation}/S")

    def generate_r1cs_constraints(self):
        n = len(self.A)
        for i in range(n):
            prev = LC() if i == 0 else self.partials[i - 1].lc()
            cur = self.result.lc() if i == n - 1 else self.partials[i].lc()
            self.pb.add_r1cs_constraint(
                R1CSConstraint(self.A[i].lc(), self.B[i].lc(), cur - prev),
                f"{self.annotation}/{i}",
            )

    def generate_r1cs_witness(self):
        acc = 0
        p = self.pb.p
        for i in range(len(self.A)):
            acc = (acc + self.pb.val(self.A[i]) * self.pb.val(self.B[i])) % p
            if i < len(self.A) - 1:
                self.pb.set_val(self.partials[i], acc)
        self.pb.set_val(self.result, acc)


class DisjunctionGadget(Gadget):
    """output = OR(inputs) for boolean inputs (basic_gadgets.tcc
    disjunction_gadget): inv * sum = 1 - output and (1-output)*sum = 0."""

    def __init__(self, pb, inputs: PBVariableArray, output: PBVariable,
                 annotation: str = "or"):
        super().__init__(pb, annotation)
        self.inputs = inputs
        self.output = output
        self.inv = pb.allocate_var(f"{annotation}/inv")

    def generate_r1cs_constraints(self):
        s = self.inputs.lc_sum()
        self.pb.add_r1cs_constraint(
            R1CSConstraint(self.inv.lc(), s, self.output.lc()),
            f"{self.annotation}/inv",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(LC.constant(1) - self.output.lc(), s, LC()),
            f"{self.annotation}/zero",
        )

    def generate_r1cs_witness(self):
        p = self.pb.p
        s = sum(self.pb.val(v) for v in self.inputs) % p
        self.pb.set_val(self.output, 1 if s else 0)
        self.pb.set_val(self.inv, pow(s, -1, p) if s else 0)


class ConjunctionGadget(Gadget):
    """output = AND(inputs) for boolean inputs: output = 1 iff
    sum = n (basic_gadgets.tcc conjunction_gadget)."""

    def __init__(self, pb, inputs: PBVariableArray, output: PBVariable,
                 annotation: str = "and"):
        super().__init__(pb, annotation)
        self.inputs = inputs
        self.output = output
        self.inv = pb.allocate_var(f"{annotation}/inv")

    def generate_r1cs_constraints(self):
        n = len(self.inputs)
        defect = LC.constant(n) - self.inputs.lc_sum()  # n - sum
        self.pb.add_r1cs_constraint(
            R1CSConstraint(self.inv.lc(), defect, LC.constant(1) - self.output.lc()),
            f"{self.annotation}/inv",
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(self.output.lc(), defect, LC()),
            f"{self.annotation}/zero",
        )

    def generate_r1cs_witness(self):
        p = self.pb.p
        n = len(self.inputs)
        s = sum(self.pb.val(v) for v in self.inputs)
        defect = (n - s) % p
        self.pb.set_val(self.output, 1 if defect == 0 else 0)
        self.pb.set_val(self.inv, pow(defect, -1, p) if defect else 0)


class ComparisonGadget(Gadget):
    """less / less_or_eq for n-bit values A, B (basic_gadgets.tcc
    comparison_gadget): decompose 2^n + B - A into bits; the top bit is
    less_or_eq; AND with a nonzero test for strict less."""

    def __init__(self, pb, n: int, A, B, less: PBVariable,
                 less_or_eq: PBVariable, annotation: str = "cmp"):
        super().__init__(pb, annotation)
        self.n = n
        self.A, self.B = A, B
        self.less, self.less_or_eq = less, less_or_eq
        self.alpha = PBVariableArray.allocate(pb, n, f"{annotation}/alpha")
        self.alpha.append(less_or_eq)  # top bit
        self.alpha_packed = pb.allocate_var(f"{annotation}/alpha_packed")
        self.not_all_zeros = pb.allocate_var(f"{annotation}/naz")
        self.pack = PackingGadget(pb, self.alpha, self.alpha_packed,
                                  f"{annotation}/pack")
        self.nzero = DisjunctionGadget(
            pb, PBVariableArray(self.alpha[: self.n]), self.not_all_zeros,
            f"{annotation}/naz"
        )

    def generate_r1cs_constraints(self):
        self.pack.generate_r1cs_constraints(enforce_bitness=True)
        self.nzero.generate_r1cs_constraints()
        # alpha_packed = 2^n + B - A
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                LC.constant(1 << self.n) + _as_lc(self.B) - _as_lc(self.A),
                LC.constant(1),
                self.alpha_packed.lc(),
            ),
            f"{self.annotation}/defn",
        )
        # less = less_or_eq AND not_all_zeros
        self.pb.add_r1cs_constraint(
            R1CSConstraint(
                self.less_or_eq.lc(), self.not_all_zeros.lc(), self.less.lc()
            ),
            f"{self.annotation}/less",
        )

    def generate_r1cs_witness(self):
        pb = self.pb
        a = pb.lc_val(_as_lc(self.A))
        b = pb.lc_val(_as_lc(self.B))
        pb.set_val(self.alpha_packed, (1 << self.n) + b - a)
        self.pack.generate_r1cs_witness_from_packed()
        self.nzero.generate_r1cs_witness()
        pb.set_val(
            self.less, 1 if pb.val(self.less_or_eq) and pb.val(self.not_all_zeros) else 0
        )
