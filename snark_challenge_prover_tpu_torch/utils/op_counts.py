"""Field and group operation counters: the reference's PROFILE_OP_COUNTS.

libff counts every Fq add / sub / mul / sqr / inv and every G1 / G2 add /
dbl at run time in static members (fp.hpp:46-52, mnt4753_g1.cpp:19-20) and
prints them with print_cumulative_op_counts.  The port runs its loops on
the host, so it counts at run time too: each call records itself when it
is made, and a loop's body records once per pass.  There is no loop scope
to declare (the JAX package counts at trace time and needs one).

Keys are the JAX package's: ``"<field>.add|sub|mul|sqr|inv"`` for the
prime fields (an extension's operations record as their base-field
operations) and ``"<group>.add|dbl"`` for the curve groups, the names
those models give (``MNT4753.Fq``, ``MNT6753.G2``, ...).  Counts are per
element or per point, taken from tensor shapes alone: counting never reads
a value back from the card.  ``double(P, times)`` counts ``times`` a point.
On the card a group kernel makes its field products inside one launch, so
the group hook also records, a point, the field operations that the plain
version of the formula records on the CPU (``ops/cuda_group.formula_ops``):
a call reports the same on the card and on the CPU.

Usage::

    with op_counts.counting() as c:
        prover(...)
    c.print_report()

Outside a ``counting()`` scope a hook costs one ``None`` check.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field


@dataclass
class OpCounter:
    counts: Counter = field(default_factory=Counter)

    def add(self, key: str, n: int = 1):
        self.counts[key] += n

    def report(self) -> dict:
        return dict(sorted(self.counts.items()))

    def print_report(self):
        """print_cumulative_op_counts flavour (profiling.cpp)."""
        for k, v in sorted(self.counts.items()):
            print(f"  {k:>12}: {v}")


_active: OpCounter | None = None


def active() -> OpCounter | None:
    return _active


def record(key: str, n: int = 1) -> None:
    if _active is not None:
        _active.add(key, n)


@contextlib.contextmanager
def counting():
    """Count the operations made in this scope (a scope inside another
    counts apart, and the outer one goes on after it)."""
    global _active
    prev = _active
    _active = OpCounter()
    try:
        yield _active
    finally:
        _active = prev
