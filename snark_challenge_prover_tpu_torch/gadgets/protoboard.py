"""The protoboard: allocate variables, assign them, add R1CS constraints,
and extract the constraint system with its primary/auxiliary split.

Counterpart of the JAX package's ``gadgets/protoboard.py`` (gadgetlib1's
protoboard.hpp:31-65 and pb_variable.hpp), on the port's
``relations/r1cs.py``.  Circuits are built on the host, in order, as in the
reference.
"""

from __future__ import annotations

import gc
from contextlib import contextmanager

from ..relations.r1cs import (
    LinearCombination as LC,
    R1CSConstraint,
    R1CSConstraintSystem,
)


@contextmanager
def collector_paused():
    """Python's cyclic garbage collector paused while a large circuit is
    built: the build allocates millions of small linear combinations that
    all stay alive, and the collector's repeated full passes over them
    otherwise take most of its time (a 340 k-constraint verifier gadget
    builds in about a quarter of the time without them)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


class PBVariable:
    """A protoboard variable handle (pb_variable.hpp).  Index 0 is the
    constant ONE; allocate() hands out 1, 2, ..."""

    __slots__ = ("index",)

    def __init__(self, index: int = 0):
        self.index = index

    def lc(self, coeff: int = 1) -> LC:
        return LC.of_var(self.index, coeff)

    # arithmetic sugar producing linear combinations
    def __add__(self, other):
        return self.lc() + _as_lc(other)

    def __sub__(self, other):
        return self.lc() - _as_lc(other)

    def __mul__(self, scalar: int):
        return self.lc(scalar)

    __rmul__ = __mul__


ONE = PBVariable(0)


def _as_lc(x) -> LC:
    if isinstance(x, LC):
        return x
    if isinstance(x, PBVariable):
        return x.lc()
    if isinstance(x, int):
        return LC.constant(x)
    raise TypeError(type(x))


class PBVariableArray(list):
    """pb_variable_array<FieldT>: a list of variables with bulk allocate."""

    @classmethod
    def allocate(cls, pb: "Protoboard", n: int, annotation: str = ""):
        return cls(pb.allocate_var(f"{annotation}[{i}]") for i in range(n))

    def lc_sum(self) -> LC:
        out = LC()
        for v in self:
            out = out + v.lc()
        return out


class Protoboard:
    """protoboard<FieldT> (protoboard.hpp:31-65)."""

    def __init__(self, p: int):
        self.p = p
        self._values: list[int] = []       # assignment, index 1..n at [i-1]
        self._num_inputs = 0
        self.constraints: list[R1CSConstraint] = []
        self.annotations: list[str] = []

    # ---- variables --------------------------------------------------------
    def allocate_var(self, annotation: str = "") -> PBVariable:
        self._values.append(0)
        return PBVariable(len(self._values))

    @property
    def num_variables(self) -> int:
        return len(self._values)

    def val(self, var: PBVariable) -> int:
        if var.index == 0:
            return 1
        return self._values[var.index - 1]

    def set_val(self, var: PBVariable, value: int):
        if var.index == 0:
            raise ValueError("cannot assign ONE")
        self._values[var.index - 1] = value % self.p

    def lc_val(self, lc: LC) -> int:
        return lc.evaluate(self._values, self.p)

    # ---- constraints -------------------------------------------------------
    def add_r1cs_constraint(self, constraint: R1CSConstraint, annotation: str = ""):
        self.constraints.append(constraint)
        self.annotations.append(annotation)

    def set_input_sizes(self, primary_input_size: int):
        """First `primary_input_size` allocated variables become public
        (protoboard.hpp set_input_sizes)."""
        self._num_inputs = primary_input_size

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def is_satisfied(self) -> bool:
        return self.get_constraint_system().is_satisfied(
            self.primary_input(), self.auxiliary_input()
        )

    # ---- extraction ---------------------------------------------------------
    def get_constraint_system(self) -> R1CSConstraintSystem:
        cs = R1CSConstraintSystem(
            self.p,
            primary_input_size=self._num_inputs,
            auxiliary_input_size=self.num_variables - self._num_inputs,
        )
        cs.constraints = list(self.constraints)
        return cs

    def primary_input(self) -> list:
        return self._values[: self._num_inputs]

    def auxiliary_input(self) -> list:
        return self._values[self._num_inputs :]


class Gadget:
    """gadget<FieldT> base (gadgetlib1/gadget.hpp): holds the pb and an
    annotation prefix; subclasses implement generate_r1cs_constraints /
    generate_r1cs_witness."""

    def __init__(self, pb: Protoboard, annotation: str = ""):
        self.pb = pb
        self.annotation = annotation

    def generate_r1cs_constraints(self):
        raise NotImplementedError

    def generate_r1cs_witness(self):
        raise NotImplementedError
