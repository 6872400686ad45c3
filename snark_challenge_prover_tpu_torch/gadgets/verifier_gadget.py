"""In-circuit SNARK verifier: Groth16 verification as an R1CS gadget.

Counterpart of the JAX package's ``gadgets/verifier_gadget.py``, on the
port's gadgets and host pairing; the verification key and proof are the
port's ``proof_systems/groth16_full`` objects.

Capability parity with gadgetlib1's verifier gadgets
(libsnark/gadgetlib1/gadgets/verifiers/r1cs_ppzksnark_verifier_gadget.hpp)
— the top of the recursive-composition stack: a circuit over this
curve's Fr that verifies a proof made over the cycle partner (whose Fq
IS this Fr, mnt4753/mnt6753 being an amicable pair).  This is the
building block from which libsnark's PCD (r1cs_pcd/) is assembled.

Layout (the reference's "hardcoded vk" variant — vk elements enter as
circuit constants; the proof and public input are wires):

  * input accumulation acc = IC_0 + sum_i x_i * IC_i with in-circuit
    scalar multiplication: per bit, one unconditional G1 add gadget on
    running wires plus a 2-constraint select (the reference's
    G1_multiscalar_mul; incomplete-addition exceptional cases are
    negligible for honest vks, as there);
  * three ReducedPairingGadgets: e(A, B), e(acc, G2one), e(C, delta);
  * two GT multiplications and a componentwise linear pin against the
    constant e(alpha, beta).

Satisfiable exactly when the verifier accepts: filling the witness from
an INVALID proof leaves the final equality pins violated.

Input-encoding note (as in the reference, whose verifier gadget
consumes primary inputs as BIT wires): the per-input packing constraint
identifies bit patterns modulo the circuit field p, so callers doing
recursion should treat the BITS as the canonical public interface (the
packed wire is a convenience binding).

Cost: ~190k constraints (3 pairings at ~62k + the 753-bit scalar-mul
chains) on MNT4753 — same order as the reference's verifier gadget.
"""

from __future__ import annotations

from ..host.curves import HostCurve
from ..proof_systems.ate_pairing import AtePairing
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from .curve_gadgets import G1AddGadget, G1DoubleGadget
from .field_ext_gadgets import ExtVariable
from .pairing_gadgets import ReducedPairingGadget
from .protoboard import PBVariable, Protoboard


def _c(x):
    return LC.constant(x)


class G1ScalarMulGadget:
    """acc_out = acc_in + s * P for a FIXED base point P and a wire
    scalar s (bit wires supplied): double-and-add over the fixed base's
    precomputed multiples — per bit one add gadget + one coordinate
    select (2 constraints); the doubled bases are circuit constants, so
    no doubling gadgets are needed (fixed-base windowing, as the
    reference's multiscalar gadget does for vk queries)."""

    def __init__(self, pb: Protoboard, hc: HostCurve, base, acc_in,
                 nbits: int, annotation="smul"):
        self.pb = pb
        self.hc = hc
        self.bits = [pb.allocate_var(f"{annotation}.bit{i}")
                     for i in range(nbits)]
        for b in self.bits:
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), _c(1) - b.lc(), _c(0)),
                f"{annotation} bool",
            )
        self.adds = []
        self.sel_x = []
        self.sel_y = []
        acc = acc_in  # (x wire/lc, y wire/lc)
        P = base
        g1 = hc.g1
        for i in range(nbits):
            # candidate = acc + P_i (unconditional add gadget)
            cx = pb.allocate_var(f"{annotation}.cx{i}")
            cy = pb.allocate_var(f"{annotation}.cy{i}")
            add = G1AddGadget(
                pb,
                acc,
                (_c(P[0]), _c(P[1])),
                (cx, cy),
                f"{annotation}.add{i}",
            )
            add.generate_r1cs_constraints()
            self.adds.append((add, P))
            # select: next = bit ? cand : acc   (per coordinate)
            nx = pb.allocate_var(f"{annotation}.nx{i}")
            ny = pb.allocate_var(f"{annotation}.ny{i}")
            b = self.bits[i]
            ax = acc[0].lc() if isinstance(acc[0], PBVariable) else acc[0]
            ay = acc[1].lc() if isinstance(acc[1], PBVariable) else acc[1]
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), cx.lc() - ax, nx.lc() - ax),
                f"{annotation} selx",
            )
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), cy.lc() - ay, ny.lc() - ay),
                f"{annotation} sely",
            )
            self.sel_x.append((nx, cx))
            self.sel_y.append((ny, cy))
            acc = (nx, ny)
            P = g1.add(P, P)  # constant doubling on host
        self.acc_out = acc

    def generate_r1cs_witness(self, scalar: int, acc_in_val):
        pb = self.pb
        g1 = self.hc.g1
        acc_val = acc_in_val
        for i in range(len(self.bits)):
            bit = (scalar >> i) & 1
            pb.set_val(self.bits[i], bit)
            add, P = self.adds[i]
            cand = g1.add(acc_val, P)
            nx, cx = self.sel_x[i]
            ny, cy = self.sel_y[i]
            pb.set_val(cx, cand[0])
            pb.set_val(cy, cand[1])
            # the add gadget's slope witness
            den = (P[0] - acc_val[0]) % pb.p
            lam = (P[1] - acc_val[1]) * pow(den, -1, pb.p) % pb.p
            pb.set_val(add.lam, lam)
            if bit:
                acc_val = cand
            pb.set_val(nx, acc_val[0])
            pb.set_val(ny, acc_val[1])
        return acc_val


class Groth16VerifierGadget:
    """The full in-circuit verifier for ONE proof against a hardcoded
    vk.  `primary` enters as scalar wires (bit decompositions inside);
    the proof enters as point wires."""

    def __init__(self, pb: Protoboard, hc: HostCurve, vk,
                 num_inputs: int, annotation="g16v"):
        self.pb = pb
        self.hc = hc
        self.vk = vk
        engine = AtePairing(hc)
        self.engine = engine
        deg = hc.g2.F.deg
        nbits = 753

        # proof wires
        self.A = (pb.allocate_var("pA.x"), pb.allocate_var("pA.y"))
        self.B = (
            ExtVariable.allocate(pb, deg, "pB.x"),
            ExtVariable.allocate(pb, deg, "pB.y"),
        )
        self.C = (pb.allocate_var("pC.x"), pb.allocate_var("pC.y"))
        # public-input scalar wires
        self.inputs = [pb.allocate_var(f"x{i}") for i in range(num_inputs)]

        # ---- IC accumulation ------------------------------------------
        # acc starts at IC_0 (a constant, never the identity for honest
        # vks); each input contributes x_i * IC_i via a scalar-mul chain
        self.smuls = []
        acc = (_c(vk.ABC_g1[0][0]), _c(vk.ABC_g1[0][1]))
        for i in range(num_inputs):
            sm = G1ScalarMulGadget(
                pb, hc, vk.ABC_g1[i + 1], acc, nbits, f"{annotation}.ic{i}"
            )
            # bind the bit decomposition to the input wire
            pack = LC()
            for j, b in enumerate(sm.bits):
                pack = pack + b.lc(1 << j)
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), pack, self.inputs[i].lc()),
                f"{annotation} pack{i}",
            )
            self.smuls.append(sm)
            acc = sm.acc_out
        self.acc = acc

        # ---- the three pairings ---------------------------------------
        self.pair_AB = ReducedPairingGadget(
            pb, hc, self.A, self.B, f"{annotation}.eAB"
        )
        g2one = hc.g2_gen  # vk pairs acc with the plain G2 generator

        def const_g2(Q):
            F = hc.g2.F
            return (
                ExtVariable.constant(list(F.components(Q[0]))),
                ExtVariable.constant(list(F.components(Q[1]))),
            )

        self.pair_acc = ReducedPairingGadget(
            pb, hc, self.acc, const_g2(g2one), f"{annotation}.eacc"
        )
        self.pair_C = ReducedPairingGadget(
            pb, hc, self.C, const_g2(vk.delta_g2), f"{annotation}.eC"
        )

        # ---- combine + pin --------------------------------------------
        gt = self.pair_AB.gt
        b = self.pair_AB.b
        # rhs = e(acc, 1) * e(C, delta)   [with the SAME ops object: reuse
        # pair_AB's so the fill ordering is one list]
        # pairing gadgets each own an ops object; collect their fill order
        # fill order: acc and C pairings first (the rhs combination and
        # equality pins live in pair_AB's ops object and read their results)
        self._fill_order = [self.pair_acc.b, self.pair_C.b, self.pair_AB.b]
        rhs = self._cross_mul(self.pair_acc.result, self.pair_C.result,
                              f"{annotation}.rhs")
        # lhs = e(A,B); pin lhs == alpha_beta * rhs componentwise; the
        # constant-GT multiplication is free (linear)
        self.alpha_beta = vk.alpha_g1_beta_g2
        final = self._const_gt_mul(self.alpha_beta, rhs,
                                   f"{annotation}.fin")
        for comp_l, comp_r in zip(
            list(self.pair_AB.result[0].comps)
            + list(self.pair_AB.result[1].comps),
            list(final[0].comps) + list(final[1].comps),
        ):
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), comp_l - comp_r, _c(0)),
                f"{annotation} verify",
            )

    # GT ops across ops objects: use pair_AB's for the glue
    def _cross_mul(self, X, Y, ann):
        from .pairing_gadgets import _GTOps

        return _GTOps(self.pair_AB.b).mul(X, Y, ann)

    def _const_gt_mul(self, const_gt, Y, ann):
        """constant GT element * wire GT element: linear in Y? No — GT
        mul is bilinear, so constant*wire is LINEAR componentwise; do it
        for free."""
        b = self.pair_AB.b
        F = b.F
        p = b.pb.p
        a0 = F.components(const_gt[0])
        a1 = F.components(const_gt[1])

        # (a0 + a1 v)(y0 + y1 v) = (a0*y0 + u*a1*y1) + (a0*y1 + a1*y0) v
        def const_ext_mul(ac, yv: ExtVariable):
            from .field_ext_gadgets import ext_const_mul_lc

            return ExtVariable(
                ext_const_mul_lc(b.deg, b.nr, ac, yv)
            )

        t0 = const_ext_mul(a0, Y[0])
        t1 = const_ext_mul(a1, Y[1])
        t2 = const_ext_mul(a0, Y[1])
        t3 = const_ext_mul(a1, Y[0])
        c0 = b.add(t0, b.mul_u(t1))
        c1 = b.add(t2, t3)
        return (c0, c1)

    def generate_r1cs_witness(self, primary, proof):
        """Fill from host values; satisfiable iff the proof verifies."""
        pb = self.pb
        hc = self.hc
        pb.set_val(self.A[0], proof.g_A[0])
        pb.set_val(self.A[1], proof.g_A[1])
        self.B[0].set(pb, proof.g_B[0])
        self.B[1].set(pb, proof.g_B[1])
        pb.set_val(self.C[0], proof.g_C[0])
        pb.set_val(self.C[1], proof.g_C[1])
        acc_val = self.vk.ABC_g1[0]
        for i, (x, sm) in enumerate(zip(primary, self.smuls)):
            pb.set_val(self.inputs[i], x)
            acc_val = sm.generate_r1cs_witness(x, acc_val)
        for b_ in self._fill_order:
            b_.fill()


class G1VarScalarMulGadget:
    """acc_out = acc_in + s * B for a WIRE base point B: double-and-add
    where both the running accumulator and the running base multiple are
    wires — per bit one add gadget, one doubling gadget and a
    2-constraint coordinate select.  The variable-base analogue of
    G1ScalarMulGadget, needed when the vk itself is a witness
    (r1cs_ppzksnark_verifier_gadget's G1_multiscalar_mul over a
    verification_key_variable)."""

    def __init__(self, pb: Protoboard, hc: HostCurve, base, acc_in,
                 nbits: int, annotation="vsmul"):
        self.pb = pb
        self.hc = hc
        self.bits = [pb.allocate_var(f"{annotation}.bit{i}")
                     for i in range(nbits)]
        for b in self.bits:
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), _c(1) - b.lc(), _c(0)),
                f"{annotation} bool",
            )
        self.steps = []
        acc = acc_in
        cur = base  # wire pair: the running 2^i * B
        a_coeff = hc.g1.a
        for i in range(nbits):
            cx = pb.allocate_var(f"{annotation}.cx{i}")
            cy = pb.allocate_var(f"{annotation}.cy{i}")
            add = G1AddGadget(pb, acc, cur, (cx, cy), f"{annotation}.add{i}")
            add.generate_r1cs_constraints()
            nx = pb.allocate_var(f"{annotation}.nx{i}")
            ny = pb.allocate_var(f"{annotation}.ny{i}")
            b = self.bits[i]
            ax = acc[0].lc() if isinstance(acc[0], PBVariable) else acc[0]
            ay = acc[1].lc() if isinstance(acc[1], PBVariable) else acc[1]
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), cx.lc() - ax, nx.lc() - ax),
                f"{annotation} selx",
            )
            pb.add_r1cs_constraint(
                R1CSConstraint(b.lc(), cy.lc() - ay, ny.lc() - ay),
                f"{annotation} sely",
            )
            if i + 1 < nbits:
                dx = pb.allocate_var(f"{annotation}.dx{i}")
                dy = pb.allocate_var(f"{annotation}.dy{i}")
                dbl = G1DoubleGadget(pb, a_coeff, cur, (dx, dy),
                                     f"{annotation}.dbl{i}")
                dbl.generate_r1cs_constraints()
            else:
                dbl, dx, dy = None, None, None
            self.steps.append((add, (cx, cy), (nx, ny), dbl, (dx, dy)))
            acc = (nx, ny)
            if dbl is not None:
                cur = (dx, dy)
        self.acc_out = acc

    def generate_r1cs_witness(self, scalar: int, base_val, acc_in_val):
        pb = self.pb
        g1 = self.hc.g1
        acc_val = acc_in_val
        cur_val = base_val
        for i, (add, (cx, cy), (nx, ny), dbl, (dx, dy)) in enumerate(self.steps):
            bit = (scalar >> i) & 1
            pb.set_val(self.bits[i], bit)
            cand = g1.add(acc_val, cur_val)
            pb.set_val(cx, cand[0])
            pb.set_val(cy, cand[1])
            den = (cur_val[0] - acc_val[0]) % pb.p
            lam = (cur_val[1] - acc_val[1]) * pow(den, -1, pb.p) % pb.p
            pb.set_val(add.lam, lam)
            if bit:
                acc_val = cand
            pb.set_val(nx, acc_val[0])
            pb.set_val(ny, acc_val[1])
            if dbl is not None:
                nxt = g1.add(cur_val, cur_val)
                dbl.generate_r1cs_witness()
                cur_val = nxt
        return acc_val


def vk_field_elements(hc: HostCurve, vk, num_inputs: int):
    """The vk flattened to a canonical field-element list — the digest
    preimage for set-commitment authentication (mp_pcd_circuits hashes
    the translation vk bits the same way)."""
    out = []
    for i in range(num_inputs + 1):
        out += [vk.ABC_g1[i][0], vk.ABC_g1[i][1]]
    F = hc.g2.F
    out += list(F.components(vk.delta_g2[0]))
    out += list(F.components(vk.delta_g2[1]))
    out += list(F.components(vk.alpha_g1_beta_g2[0]))
    out += list(F.components(vk.alpha_g1_beta_g2[1]))
    return [v % hc.g2.F.p for v in out]


class Groth16VerifierGadgetVarVK:
    """In-circuit Groth16 verifier where the vk enters as WIRES — the
    r1cs_ppzksnark_verification_key_variable form the multi-predicate
    PCD requires (mp_pcd_circuits.hpp: incoming proofs verify against a
    witness vk whose digest is then authenticated against a committed
    vk set).  `.vk_digest` is the knapsack-CRH digest wire of the vk's
    canonical field-element flattening (vk_field_elements)."""

    def __init__(self, pb: Protoboard, hc: HostCurve, num_inputs: int,
                 annotation="g16vv"):
        from .knapsack import FieldBitsGadget, KnapsackCRHGadget

        self.pb = pb
        self.hc = hc
        self.num_inputs = num_inputs
        engine = AtePairing(hc)
        self.engine = engine
        deg = hc.g2.F.deg
        nbits = 753

        # ---- vk wires --------------------------------------------------
        self.ABC = [
            (pb.allocate_var(f"{annotation}.abc{i}.x"),
             pb.allocate_var(f"{annotation}.abc{i}.y"))
            for i in range(num_inputs + 1)
        ]
        self.delta = (
            ExtVariable.allocate(pb, deg, f"{annotation}.delta.x"),
            ExtVariable.allocate(pb, deg, f"{annotation}.delta.y"),
        )
        self.alpha_beta = (
            ExtVariable.allocate(pb, deg, f"{annotation}.ab.c0"),
            ExtVariable.allocate(pb, deg, f"{annotation}.ab.c1"),
        )

        # ---- proof + input wires --------------------------------------
        self.A = (pb.allocate_var(f"{annotation}.pA.x"),
                  pb.allocate_var(f"{annotation}.pA.y"))
        self.B = (
            ExtVariable.allocate(pb, deg, f"{annotation}.pB.x"),
            ExtVariable.allocate(pb, deg, f"{annotation}.pB.y"),
        )
        self.C = (pb.allocate_var(f"{annotation}.pC.x"),
                  pb.allocate_var(f"{annotation}.pC.y"))
        self.inputs = [pb.allocate_var(f"{annotation}.x{i}")
                       for i in range(num_inputs)]

        # ---- IC accumulation (variable bases) -------------------------
        self.smuls = []
        acc = self.ABC[0]
        for i in range(num_inputs):
            sm = G1VarScalarMulGadget(
                pb, hc, self.ABC[i + 1], acc, nbits, f"{annotation}.ic{i}"
            )
            pack = LC()
            for j, b in enumerate(sm.bits):
                pack = pack + b.lc(1 << j)
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), pack, self.inputs[i].lc()),
                f"{annotation} pack{i}",
            )
            self.smuls.append(sm)
            acc = sm.acc_out
        self.acc = acc

        # ---- the three pairings (delta is wires now) ------------------
        self.pair_AB = ReducedPairingGadget(
            pb, hc, self.A, self.B, f"{annotation}.eAB"
        )
        g2one = hc.g2_gen

        def const_g2(Q):
            F = hc.g2.F
            return (
                ExtVariable.constant(list(F.components(Q[0]))),
                ExtVariable.constant(list(F.components(Q[1]))),
            )

        self.pair_acc = ReducedPairingGadget(
            pb, hc, self.acc, const_g2(g2one), f"{annotation}.eacc"
        )
        self.pair_C = ReducedPairingGadget(
            pb, hc, self.C, self.delta, f"{annotation}.eC"
        )

        # ---- combine + pin (alpha_beta is wires: full GT mul) ---------
        from .pairing_gadgets import _GTOps

        self._fill_order = [self.pair_acc.b, self.pair_C.b, self.pair_AB.b]
        gtops = _GTOps(self.pair_AB.b)
        rhs = gtops.mul(self.pair_acc.result, self.pair_C.result,
                        f"{annotation}.rhs")
        final = gtops.mul(self.alpha_beta, rhs, f"{annotation}.fin")
        for comp_l, comp_r in zip(
            list(self.pair_AB.result[0].comps)
            + list(self.pair_AB.result[1].comps),
            list(final[0].comps) + list(final[1].comps),
        ):
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), comp_l - comp_r, _c(0)),
                f"{annotation} verify",
            )

        # ---- vk digest (knapsack over the canonical flattening) -------
        vk_wires = []
        for (x, y) in self.ABC:
            vk_wires += [x, y]
        for ext in (self.delta[0], self.delta[1],
                    self.alpha_beta[0], self.alpha_beta[1]):
            for c in ext.comps:
                w = pb.allocate_var(f"{annotation}.vkw")
                pb.add_r1cs_constraint(
                    R1CSConstraint(_c(1), c, w.lc()), f"{annotation} vkpin"
                )
                vk_wires.append(w)
        self._vk_comp_wires = vk_wires
        self._bit_gadgets = [
            FieldBitsGadget(pb, w, f"{annotation}.vkb{i}")
            for i, w in enumerate(vk_wires)
        ]
        all_bits = []
        for g in self._bit_gadgets:
            all_bits += list(g.bits)
        self.vk_digest = pb.allocate_var(f"{annotation}.vkdig")
        self._crh = KnapsackCRHGadget(pb, all_bits, self.vk_digest,
                                      f"{annotation}.vkcrh")

    def generate_r1cs_witness(self, vk, primary, proof):
        pb = self.pb
        hc = self.hc
        F = hc.g2.F
        for i, (x, y) in enumerate(self.ABC):
            pb.set_val(x, vk.ABC_g1[i][0])
            pb.set_val(y, vk.ABC_g1[i][1])
        self.delta[0].set(pb, F.components(vk.delta_g2[0]))
        self.delta[1].set(pb, F.components(vk.delta_g2[1]))
        self.alpha_beta[0].set(pb, F.components(vk.alpha_g1_beta_g2[0]))
        self.alpha_beta[1].set(pb, F.components(vk.alpha_g1_beta_g2[1]))
        pb.set_val(self.A[0], proof.g_A[0])
        pb.set_val(self.A[1], proof.g_A[1])
        self.B[0].set(pb, proof.g_B[0])
        self.B[1].set(pb, proof.g_B[1])
        pb.set_val(self.C[0], proof.g_C[0])
        pb.set_val(self.C[1], proof.g_C[1])
        acc_val = vk.ABC_g1[0]
        for i, (x, sm) in enumerate(zip(primary, self.smuls)):
            pb.set_val(self.inputs[i], x)
            acc_val = sm.generate_r1cs_witness(
                x, vk.ABC_g1[i + 1], acc_val
            )
        for b_ in self._fill_order:
            b_.fill()
        # vk component pins + digest
        elems = vk_field_elements(hc, vk, self.num_inputs)
        for w, v in zip(self._vk_comp_wires, elems):
            pb.set_val(w, v)
        for g in self._bit_gadgets:
            g.generate_r1cs_witness()
        self._crh.generate_r1cs_witness()
