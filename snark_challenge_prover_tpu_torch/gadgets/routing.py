"""Routing-network gadgets: prove in R1CS that N output packets are a
permutation of N input packets.

Counterpart of the JAX package's ``gadgets/routing.py`` (gadgetlib1's
benes_routing_gadget.hpp and as_waksman_routing_gadget.hpp, with the
routing algorithms of libsnark/common/routing_algorithms), with the same
switches in the same order and the same witness:

  * ``BenesRoutingGadget``: a power-of-two number of packets, 2 log2(N) - 1
    columns of N/2 two-input switches;
  * ``ASWaksmanRoutingGadget``: any number of packets, one switch fewer a
    level (the first and last connections are straight wires).

A switch with bit b costs one boolean constraint and, per line of a packet,
b (in1 - in0) = out0 - in0 and out1 = in0 + in1 - out0.  The witness is
the classical routing: a 2-colouring of the graph that links input pairs
and output pairs, walked along its alternating cycles, then the two
subnetworks in turn.  A gadget allocates its own outputs (``.outputs``).
"""

from __future__ import annotations

from collections import deque

from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .protoboard import Gadget, PBVariable, Protoboard


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


class _Switch:
    """One 2x2 crossbar: bit=0 straight (out0=in0), bit=1 crossed."""

    __slots__ = ("bit", "in0", "in1", "out0", "out1")

    def __init__(self, pb: Protoboard, in0, in1, annotation=""):
        self.bit = pb.allocate_var(f"{annotation}.bit")
        self.in0 = in0
        self.in1 = in1
        self.out0 = [pb.allocate_var(f"{annotation}.o0") for _ in in0]
        self.out1 = [pb.allocate_var(f"{annotation}.o1") for _ in in1]

    def constrain(self, pb: Protoboard):
        b = self.bit
        pb.add_r1cs_constraint(
            R1CSConstraint(b.lc(), LC.constant(1) - b.lc(), LC.constant(0)),
            "switch bit boolean",
        )
        for a0, a1, o0, o1 in zip(self.in0, self.in1, self.out0, self.out1):
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), a1 - a0, o0 - a0),
                "switch select",
            )
            pb.add_r1cs_constraint(
                R1CSConstraint(LC.constant(1), a0 + a1 - o0.lc(), o1.lc()),
                "switch complement",
            )

    def witness(self, pb: Protoboard, crossed: bool):
        pb.set_val(self.bit, 1 if crossed else 0)
        v0 = [pb.lc_val(_as_lc(x)) for x in self.in0]
        v1 = [pb.lc_val(_as_lc(x)) for x in self.in1]
        lo, hi = (v1, v0) if crossed else (v0, v1)
        for var, val in zip(self.out0, lo):
            pb.set_val(var, val)
        for var, val in zip(self.out1, hi):
            pb.set_val(var, val)


def _as_lc(x):
    return x.lc() if isinstance(x, PBVariable) else x


class _Node:
    """One recursion level: input switch column, two subnets, output
    switch column."""

    __slots__ = ("n", "in_sw", "out_sw", "top", "bottom", "outputs")


class BenesRoutingGadget(Gadget):
    """benes_routing_gadget: route num_packets (a power of two) packets
    of `lines` field elements each.  generate_r1cs_witness takes the
    permutation sigma with outputs[j] = inputs[sigma[j]]."""

    def __init__(self, pb: Protoboard, inputs, annotation: str = "benes"):
        super().__init__(pb, annotation)
        self.num_packets = len(inputs)
        if not _is_pow2(self.num_packets):
            raise ValueError(
                "Benes networks need a power-of-two packet count; "
                "the AS-Waksman variant (reference parity gap) covers "
                "other sizes"
            )
        self.inputs = [list(p) for p in inputs]
        self.root = self._build(self.inputs, annotation)
        self.outputs = self.root.outputs if self.num_packets > 1 else self.inputs

    # ---- topology ------------------------------------------------------
    def _build(self, ins, ann) -> _Node:
        pb = self.pb
        node = _Node()
        n = node.n = len(ins)
        if n == 1:
            node.in_sw = node.out_sw = None
            node.top = node.bottom = None
            node.outputs = ins
            return node
        if n == 2:
            sw = _Switch(pb, ins[0], ins[1], f"{ann}.sw")
            node.in_sw = [sw]
            node.out_sw = None
            node.top = node.bottom = None
            node.outputs = [sw.out0, sw.out1]
            return node
        half = n // 2
        node.in_sw = [
            _Switch(pb, ins[2 * i], ins[2 * i + 1], f"{ann}.in{i}")
            for i in range(half)
        ]
        node.top = self._build([s.out0 for s in node.in_sw], f"{ann}.T")
        node.bottom = self._build([s.out1 for s in node.in_sw], f"{ann}.B")
        node.out_sw = [
            _Switch(
                pb, node.top.outputs[i], node.bottom.outputs[i], f"{ann}.out{i}"
            )
            for i in range(half)
        ]
        node.outputs = []
        for s in node.out_sw:
            node.outputs.append(s.out0)
            node.outputs.append(s.out1)
        return node

    def generate_r1cs_constraints(self):
        def rec(node):
            if node is None:
                return
            for sw in (node.in_sw or []) + (node.out_sw or []):
                sw.constrain(self.pb)
            rec(node.top)
            rec(node.bottom)

        rec(self.root)

    # ---- routing + witness --------------------------------------------
    def generate_r1cs_witness(self, sigma):
        """sigma: outputs[j] carries inputs[sigma[j]]."""
        n = self.num_packets
        assert sorted(sigma) == list(range(n)), "not a permutation"
        self._route(self.root, list(sigma))

    def _route(self, node, sigma):
        """Set node's switches so its outputs realize sigma, recursing."""
        pb = self.pb
        n = node.n
        if n == 1:
            return
        if n == 2:
            node.in_sw[0].witness(pb, crossed=(sigma[0] == 1))
            return
        half = n // 2
        # 2-coloring: route[x] = True if input x travels the top subnet.
        # Input pair (2i, 2i+1) must split across subnets; output pair
        # (2o, 2o+1) likewise.  Walk alternating cycles.
        via_top = [None] * n  # per input index
        inv = [0] * n  # inv[x] = output position of input x
        for j, x in enumerate(sigma):
            inv[x] = j
        for start in range(n):
            if via_top[start] is not None:
                continue
            x, top = start, True
            while via_top[x] is None:
                via_top[x] = top
                # the input-pair partner must take the other subnet...
                part_in = x ^ 1
                via_top[part_in] = not top
                # ...and the source sharing part_in's OUTPUT pair must
                # take the complement of part_in's subnet, i.e. `top`
                # again — continue the alternating cycle there
                part_out = inv[part_in] ^ 1
                x = sigma[part_out]
        # input switch settings: crossed iff in[2i] goes bottom
        for i in range(half):
            node.in_sw[i].witness(pb, crossed=not via_top[2 * i])
        # subnet permutations: top subnet position i holds the top-routed
        # packet of input switch i; it must exit the top subnet at
        # position o = output-switch index of its destination.
        sig_top = [0] * half
        sig_bot = [0] * half
        for x in range(n):
            i = x // 2  # input switch
            o = inv[x] // 2  # output switch
            if via_top[x]:
                sig_top[o] = i
            else:
                sig_bot[o] = i
        self._route(node.top, sig_top)
        self._route(node.bottom, sig_bot)
        # output switches: out0 (= outputs[2o]) comes from top iff the
        # packet destined for 2o routed top
        for o in range(half):
            src = sigma[2 * o]
            node.out_sw[o].witness(pb, crossed=not via_top[src])


def route_benes(pb: Protoboard, inputs, sigma, annotation="benes"):
    """Convenience: build + constrain + witness in one call; returns the
    gadget (read .outputs)."""
    g = BenesRoutingGadget(pb, inputs, annotation)
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness(sigma)
    return g


# ---------------------------------------------------------------------------
# AS-Waksman: arbitrary N (as_waksman_routing_gadget.hpp /
# as_waksman_routing_algorithm.cpp structure)
# ---------------------------------------------------------------------------

class _WNode:
    __slots__ = ("n", "in_sw", "out_sw", "top", "bottom", "outputs")


class ASWaksmanRoutingGadget(Gadget):
    """as_waksman_routing_gadget: route ANY number of packets with
    floor(N/2) input switches, ceil(N/2)-1 output switches per level —
    one switch per level fewer than Benes (the first/last connections
    are fixed straight wires), and defined for non-power-of-two N:

      N even: input switches pair (2i, 2i+1); both subnets size N/2;
              output switches pair (2o, 2o+1) for o < N/2-1; outputs
              N-2 / N-1 come straight from the top / bottom subnet.
      N odd:  input N-1 goes straight into the bottom subnet (size
              ceil(N/2); top floor(N/2)); output switches pair
              (2o, 2o+1) for o < floor(N/2); output N-1 comes straight
              from the bottom subnet.

    Routing is the same alternating-cycle 2-coloring as Benes, seeded
    by the straight wires' forced subnet assignments."""

    def __init__(self, pb: Protoboard, inputs, annotation: str = "asw"):
        super().__init__(pb, annotation)
        self.num_packets = len(inputs)
        self.inputs = [list(p) for p in inputs]
        self.root = self._build(self.inputs, annotation)
        self.outputs = self.root.outputs

    def _build(self, ins, ann) -> _WNode:
        pb = self.pb
        node = _WNode()
        n = node.n = len(ins)
        if n == 1:
            node.in_sw = node.out_sw = None
            node.top = node.bottom = None
            node.outputs = ins
            return node
        if n == 2:
            sw = _Switch(pb, ins[0], ins[1], f"{ann}.sw")
            node.in_sw = [sw]
            node.out_sw = None
            node.top = node.bottom = None
            node.outputs = [sw.out0, sw.out1]
            return node
        half, odd = n // 2, n % 2
        node.in_sw = [
            _Switch(pb, ins[2 * i], ins[2 * i + 1], f"{ann}.in{i}")
            for i in range(half)
        ]
        top_in = [s.out0 for s in node.in_sw]
        bot_in = [s.out1 for s in node.in_sw]
        if odd:
            bot_in.append(ins[-1])  # straight wire into the bottom subnet
        node.top = self._build(top_in, f"{ann}.T")
        node.bottom = self._build(bot_in, f"{ann}.B")
        n_out_sw = half - 1 + odd  # ceil(n/2) - 1
        node.out_sw = [
            _Switch(
                pb, node.top.outputs[o], node.bottom.outputs[o], f"{ann}.out{o}"
            )
            for o in range(n_out_sw)
        ]
        node.outputs = []
        for s in node.out_sw:
            node.outputs.append(s.out0)
            node.outputs.append(s.out1)
        if odd:
            node.outputs.append(node.bottom.outputs[half])
        else:
            node.outputs.append(node.top.outputs[half - 1])
            node.outputs.append(node.bottom.outputs[half - 1])
        return node

    def generate_r1cs_constraints(self):
        def rec(node):
            if node is None:
                return
            for sw in (node.in_sw or []) + (node.out_sw or []):
                sw.constrain(self.pb)
            rec(node.top)
            rec(node.bottom)

        rec(self.root)

    def generate_r1cs_witness(self, sigma):
        n = self.num_packets
        assert sorted(sigma) == list(range(n)), "not a permutation"
        self._route(self.root, list(sigma))

    def _route(self, node, sigma):
        pb = self.pb
        n = node.n
        if n == 1:
            return
        if n == 2:
            node.in_sw[0].witness(pb, crossed=(sigma[0] == 1))
            return
        half, odd = n // 2, n % 2
        inv = [0] * n
        for j, x in enumerate(sigma):
            inv[x] = j
        n_out_sw = half - 1 + odd

        # 2-color with forced seeds from the straight wires
        via_top = [None] * n
        forced = []
        if odd:
            forced.append((n - 1, False))          # straight input -> bottom
            forced.append((sigma[n - 1], False))   # straight output <- bottom
        else:
            forced.append((sigma[n - 2], True))    # fixed top straight
            forced.append((sigma[n - 1], False))   # fixed bottom straight

        def partners(x):
            out = []
            if x < 2 * half:
                out.append(x ^ 1)  # input-pair partner
            j = inv[x]
            if j < 2 * n_out_sw:
                out.append(sigma[j ^ 1])  # output-pair co-source
            return out

        def propagate(x, color):
            if via_top[x] is not None:
                if via_top[x] != color:
                    raise AssertionError("AS-Waksman coloring conflict")
                return
            via_top[x] = color
            dq = deque([x])
            while dq:
                y = dq.popleft()
                for z in partners(y):
                    want = not via_top[y]
                    if via_top[z] is None:
                        via_top[z] = want
                        dq.append(z)
                    elif via_top[z] != want:
                        raise AssertionError("AS-Waksman coloring conflict")

        for x, color in forced:
            propagate(x, color)
        for x in range(n):
            if via_top[x] is None:
                propagate(x, True)

        # input switches
        for i in range(half):
            node.in_sw[i].witness(pb, crossed=not via_top[2 * i])

        # subnet permutations
        top_size = half
        bot_size = half + odd
        sig_top = [None] * top_size
        sig_bot = [None] * bot_size
        for x in range(n):
            i = x // 2 if x < 2 * half else half  # subnet input position
            j = inv[x]
            if j < 2 * n_out_sw:
                o = j // 2
            elif odd:
                o = half  # straight bottom output
            else:
                o = half - 1  # fixed last pair positions
            if via_top[x]:
                sig_top[o] = i
            else:
                sig_bot[o] = i
        assert None not in sig_top and None not in sig_bot
        self._route(node.top, sig_top)
        self._route(node.bottom, sig_bot)

        # output switches
        for o in range(n_out_sw):
            node.out_sw[o].witness(pb, crossed=not via_top[sigma[2 * o]])


def route_as_waksman(pb: Protoboard, inputs, sigma, annotation="asw"):
    g = ASWaksmanRoutingGadget(pb, inputs, annotation)
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness(sigma)
    return g
