"""gadgetlib2-style circuit DSL + adapter (libsnark/gadgetlib2 parity).

The reference carries TWO gadget DSLs: gadgetlib1 (our
gadgets/protoboard.py mirrors it) and gadgetlib2 — a separate API
originating from SCIPR's dev infrastructure with camelCase semantics
(Variable objects independent of any protoboard, `addRank1Constraint`,
`addUnaryConstraint`, `enforceBooleanity`, `val()` assignment access,
`isSatisfied`) plus a GadgetLibAdapter (gadgetlib2/adapters.{hpp,cpp})
converting its constraint systems into libsnark R1CS.

This module provides the same surface over this framework's types:
gl2 Variables allocate indices lazily at first protoboard use (the
reference's Variable is protoboard-independent too), and
`GadgetLibAdapter.convert(pb)` emits a relations.r1cs constraint
system + assignment ready for any of the proof_systems.

Counterpart of the JAX package's ``gadgets/gadgetlib2.py``, converting to
the port's ``relations/r1cs.py``.  Variable identities come from a counter
of this module's own, so the raw ids differ from the JAX package's; the
converted systems, whose indices follow first use on a protoboard, do not.
"""

from __future__ import annotations

import itertools

from ..relations.r1cs import (
    LinearCombination as R1CSLC,
    R1CSConstraint,
    R1CSConstraintSystem,
)

_var_ids = itertools.count(1)


class Variable:
    """gadgetlib2::Variable — identity exists independent of any
    protoboard (variable.hpp)."""

    __slots__ = ("name", "_id")

    def __init__(self, name: str = ""):
        self.name = name
        self._id = next(_var_ids)

    # arithmetic sugar -> LinearCombination
    def __add__(self, other):
        return LinearCombination(self) + other

    def __radd__(self, other):
        return LinearCombination(self) + other

    def __sub__(self, other):
        return LinearCombination(self) - other

    def __rsub__(self, other):
        return LinearCombination(other) - LinearCombination(self)

    def __mul__(self, k: int):
        return LinearCombination(self) * k

    __rmul__ = __mul__


class LinearCombination:
    """gadgetlib2::LinearCombination: terms + a free constant."""

    __slots__ = ("terms", "constant")

    def __init__(self, x=None):
        self.terms = {}
        self.constant = 0
        if isinstance(x, Variable):
            self.terms[x] = 1
        elif isinstance(x, LinearCombination):
            self.terms = dict(x.terms)
            self.constant = x.constant
        elif isinstance(x, int):
            self.constant = x
        elif x is not None:
            raise TypeError(type(x))

    def _merge(self, other, sign):
        other = (
            other
            if isinstance(other, LinearCombination)
            else LinearCombination(other)
        )
        out = LinearCombination(self)
        for v, c in other.terms.items():
            out.terms[v] = out.terms.get(v, 0) + sign * c
        out.constant += sign * other.constant
        return out

    def __add__(self, other):
        return self._merge(other, 1)

    __radd__ = __add__

    def __sub__(self, other):
        return self._merge(other, -1)

    def __mul__(self, k: int):
        out = LinearCombination()
        out.terms = {v: c * k for v, c in self.terms.items()}
        out.constant = self.constant * k
        return out

    __rmul__ = __mul__


class Protoboard:
    """gadgetlib2::Protoboard (protoboard.hpp:37-102)."""

    def __init__(self, p: int):
        self.p = p
        self._vals: dict[Variable, int] = {}
        self._index: dict[Variable, int] = {}
        self.constraints = []  # (a, b, c, name)
        self._num_inputs = 0

    # ---- assignment ----------------------------------------------------
    def val(self, x):
        if isinstance(x, Variable):
            return self._vals.get(x, 0)
        acc = x.constant
        for v, c in x.terms.items():
            acc += c * self._vals.get(v, 0)
        return acc % self.p

    def setVal(self, var: Variable, value: int):
        self._vals[var] = value % self.p
        self._touch(var)

    def _touch(self, var):
        if var not in self._index:
            self._index[var] = len(self._index) + 1

    # ---- constraints ---------------------------------------------------
    def addRank1Constraint(self, a, b, c, name: str = ""):
        a, b, c = (LinearCombination(x) for x in (a, b, c))
        for lc in (a, b, c):
            for v in lc.terms:
                self._touch(v)
        self.constraints.append((a, b, c, name))

    def addUnaryConstraint(self, a, name: str = ""):
        """a == 0  (protoboard.hpp:74)."""
        self.addRank1Constraint(a, LinearCombination(1), LinearCombination(0),
                                name)

    def enforceBooleanity(self, var: Variable):
        self.addRank1Constraint(
            LinearCombination(var),
            LinearCombination(1) - LinearCombination(var),
            LinearCombination(0),
            f"booleanity {var.name}",
        )

    def setPublicAmount(self, n: int):
        """First n allocated variables become the primary input (the
        adapter consumes this split)."""
        self._num_inputs = n

    def isSatisfied(self) -> bool:
        p = self.p
        for a, b, c, _ in self.constraints:
            if self.val(a) * self.val(b) % p != self.val(c):
                return False
        return True


class GadgetLibAdapter:
    """adapters.hpp GadgetLibAdapter: gl2 objects -> relations.r1cs."""

    def convert_lc(self, pb: Protoboard, lc: LinearCombination) -> R1CSLC:
        terms = []
        if lc.constant:
            terms.append((0, lc.constant % pb.p))
        for v, c in lc.terms.items():
            terms.append((pb._index[v], c % pb.p))
        return R1CSLC(terms)

    def convert(self, pb: Protoboard):
        """-> (R1CSConstraintSystem, primary, auxiliary)."""
        n = len(pb._index)
        cs = R1CSConstraintSystem(
            pb.p,
            primary_input_size=pb._num_inputs,
            auxiliary_input_size=n - pb._num_inputs,
        )
        for a, b, c, _name in pb.constraints:
            cs.add_constraint(
                R1CSConstraint(
                    self.convert_lc(pb, a),
                    self.convert_lc(pb, b),
                    self.convert_lc(pb, c),
                )
            )
        assignment = [0] * n
        for v, idx in pb._index.items():
            assignment[idx - 1] = pb._vals.get(v, 0)
        primary = assignment[: pb._num_inputs]
        auxiliary = assignment[pb._num_inputs :]
        return cs, primary, auxiliary
