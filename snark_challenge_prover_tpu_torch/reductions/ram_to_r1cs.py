"""RAM -> R1CS reduction: a TinyRAM execution as a constraint system, on
the host.

Counterpart of the JAX package's ``reductions/ram_to_r1cs.py`` (libsnark
reductions/ram_to_r1cs with gadgetlib1's tinyram cpu checkers): "program P
accepts the tape x within T steps" as an R1CS over MNT4753's Fr, with the
same constraints, variables and witness-fill closures in the same order, so
the constraint system equals the JAX package's term for term:

  * a CPU checker per step: the program counter one-hot, the operands, the
    ALU (bit-decomposed bitwise operations, carry and borrow adds, equality
    by an inverse witness, unsigned compares by the borrow), and the
    register, flag and pc updates;
  * memory consistency by routing: every memory row (the tape boot-stored
    at addresses 0..n-1, then one row a step) goes through an AS-Waksman
    network (``gadgets.routing``) into (address, timestamp) order, where
    adjacent rows are held to load-after-store continuity and to zero for
    memory never written;
  * the tape is the primary input;
  * ``answer`` freezes the machine as a pc self-loop, and the last step
    must decode ``answer`` with operand 0.

The program is compiled into the circuit (a constant instruction table
indexed by the pc one-hot), and only the opcodes of ``CIRCUIT_OPS`` are
constrained; others raise NotImplementedError when the circuit is built.
``ram_witness_map`` replays the simulator's trace into the state wires and
then runs the fill closures in the order they were made.
"""

from __future__ import annotations

import math

from ..gadgets.protoboard import PBVariable, Protoboard
from ..gadgets.routing import ASWaksmanRoutingGadget
from ..models.primes import FIELD_A
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from ..relations.tinyram import TinyRAMProgram, simulate

CIRCUIT_OPS = {
    "mov", "cmov", "add", "sub", "and", "or", "xor", "not", "cmpe",
    "cmpa", "cmpae", "jmp", "cjmp", "cnjmp", "storew", "loadw", "answer",
}

# iterated while building (the JAX package's are sets, whose order follows
# the interpreter's string hashes): a fixed order here
BITWISE = ("and", "or", "xor", "not")
WRITERS = {"mov", "cmov", "add", "sub", "and", "or", "xor", "not", "loadw"}
FLAG_SETTERS = ("add", "sub", "and", "or", "xor", "not", "cmpe", "cmpa",
                "cmpae")


def _c(x):
    return LC.constant(x)


class _Builder:
    """Protoboard helpers that register witness-fill closures."""

    def __init__(self, pb: Protoboard):
        self.pb = pb
        self.fillers = []
        self.env = {}

    def val(self, lc):
        return self.pb.lc_val(lc)

    def defer(self, fn):
        self.fillers.append(fn)

    def boolean(self, var, ann=""):
        v = var.lc() if isinstance(var, PBVariable) else var
        self.pb.add_r1cs_constraint(
            R1CSConstraint(v, _c(1) - v, _c(0)), f"bool {ann}"
        )

    def product(self, a_lc, b_lc, ann=""):
        t = self.pb.allocate_var(ann)
        self.pb.add_r1cs_constraint(R1CSConstraint(a_lc, b_lc, t.lc()), ann)
        self.defer(
            lambda: self.pb.set_val(t, self.val(a_lc) * self.val(b_lc))
        )
        return t

    def decompose(self, value_lc, nbits, ann=""):
        bits = [self.pb.allocate_var(f"{ann}.b{i}") for i in range(nbits)]
        for b in bits:
            self.boolean(b, ann)
        pack = LC()
        for i, b in enumerate(bits):
            pack = pack + b.lc(1 << i)
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), pack, value_lc), f"pack {ann}"
        )

        def fill():
            v = self.val(value_lc)
            for i, b in enumerate(bits):
                self.pb.set_val(b, (v >> i) & 1)

        self.defer(fill)
        return bits

    def inv_flag(self, d_lc, ann=""):
        """flag = [d == 0] with inverse witness: flag*d = 0 and
        d*dinv = 1-flag."""
        flag = self.pb.allocate_var(f"{ann}.z")
        dinv = self.pb.allocate_var(f"{ann}.zi")
        self.boolean(flag, ann)
        self.pb.add_r1cs_constraint(
            R1CSConstraint(flag.lc(), d_lc, _c(0)), f"{ann} z0"
        )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(d_lc, dinv.lc(), _c(1) - flag.lc()), f"{ann} z1"
        )

        def fill():
            d = self.val(d_lc)
            self.pb.set_val(flag, 1 if d == 0 else 0)
            self.pb.set_val(dinv, 0 if d == 0 else pow(d, -1, self.pb.p))

        self.defer(fill)
        return flag


def ram_to_r1cs(program: TinyRAMProgram, tape_len: int, T: int):
    """Build the circuit; returns (pb, handles) — fill with
    ram_witness_map, then pb.get_constraint_system() + primary/aux feed
    any r1cs ppzksnark (proof_systems/ram_ppzksnark.py wraps PGHR13 as
    the reference's ram_ppzksnark wraps r1cs_ppzksnark)."""
    ap = program.ap
    w = ap.w
    L = len(program.instructions)
    K = ap.k
    mask = ap.word_mask
    for ins in program.instructions:
        if ins.op not in CIRCUIT_OPS:
            raise NotImplementedError(f"opcode {ins.op} not circuit-supported")

    pb = Protoboard(_field_p())
    sb = _Builder(pb)

    tape_vars = [pb.allocate_var(f"tape{i}") for i in range(tape_len)]
    pb.set_input_sizes(tape_len)
    for tv in tape_vars:
        sb.decompose(tv.lc(), w, "tape")  # tape words must be words

    regs = [[pb.allocate_var(f"r{t}.{r}") for r in range(K)]
            for t in range(T + 1)]
    flag = [pb.allocate_var(f"flag{t}") for t in range(T + 1)]
    pc = [pb.allocate_var(f"pc{t}") for t in range(T + 1)]

    for r in range(K):
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), regs[0][r].lc(), _c(0)), "init reg"
        )
    pb.add_r1cs_constraint(R1CSConstraint(_c(1), flag[0].lc(), _c(0)),
                           "init flag")
    pb.add_r1cs_constraint(R1CSConstraint(_c(1), pc[0].lc(), _c(0)),
                           "init pc")

    mem_rows = []
    for i, tv in enumerate(tape_vars):
        mem_rows.append([_c(i), _c(i), _c(1), tv.lc()])

    final_sel_answer = None
    final_a2 = None

    for t in range(T):
        # ---- pc one-hot ------------------------------------------------
        sel = [pb.allocate_var(f"s{t}.{j}") for j in range(L)]
        for s in sel:
            sb.boolean(s, "sel")
        tot, pcsum = LC(), LC()
        for j, s in enumerate(sel):
            tot = tot + s.lc()
            pcsum = pcsum + s.lc(j)
        pb.add_r1cs_constraint(R1CSConstraint(_c(1), tot, _c(1)), "sel one")
        pb.add_r1cs_constraint(R1CSConstraint(_c(1), pcsum, pc[t].lc()),
                               "sel pc")

        def _mk_sel_fill(sel=sel, t=t):
            def fill():
                pcv = sb.val(pc[t].lc())
                for j, s in enumerate(sel):
                    pb.set_val(s, 1 if j == pcv else 0)
            return fill

        sb.defer(_mk_sel_fill())

        def opsel(opname, sel=sel):
            out = LC()
            for j, ins in enumerate(program.instructions):
                if ins.op == opname:
                    out = out + sel[j].lc()
            return out

        # ---- operands --------------------------------------------------
        a1, a2 = LC(), LC()
        for j, ins in enumerate(program.instructions):
            pa = sb.product(sel[j].lc(), regs[t][ins.arg1].lc(), f"a1_{t}_{j}")
            a1 = a1 + pa.lc()
            if ins.arg2_is_imm:
                a2 = a2 + sel[j].lc(ins.arg2 & mask)
            else:
                p2 = sb.product(sel[j].lc(), regs[t][ins.arg2].lc(),
                                f"a2_{t}_{j}")
                a2 = a2 + p2.lc()

        a1b = sb.decompose(a1, w, f"a1b{t}")
        a2b = sb.decompose(a2, w, f"a2b{t}")

        # ---- ALU -------------------------------------------------------
        and_bits = [sb.product(x.lc(), y.lc(), f"and{t}_{i}")
                    for i, (x, y) in enumerate(zip(a1b, a2b))]
        res_and, res_or, res_xor = LC(), LC(), LC()
        for i, (x, y, xy) in enumerate(zip(a1b, a2b, and_bits)):
            res_and = res_and + xy.lc(1 << i)
            res_or = res_or + x.lc(1 << i) + y.lc(1 << i) - xy.lc(1 << i)
            res_xor = res_xor + x.lc(1 << i) + y.lc(1 << i) - xy.lc(2 << i)
        res_not = _c(mask) - a2

        add_res = pb.allocate_var(f"addr{t}")
        add_carry = pb.allocate_var(f"addc{t}")
        sb.boolean(add_carry)

        def _fill_add(add_res=add_res, add_carry=add_carry, a1=a1, a2=a2):
            s = sb.val(a1) + sb.val(a2)
            pb.set_val(add_res, s & mask)
            pb.set_val(add_carry, s >> w)

        sb.defer(_fill_add)
        sb.decompose(add_res.lc(), w, f"addres{t}")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), a1 + a2,
                           add_res.lc() + add_carry.lc(1 << w)),
            "add",
        )

        sub_res = pb.allocate_var(f"subr{t}")
        sub_borrow = pb.allocate_var(f"subb{t}")
        sb.boolean(sub_borrow)

        def _fill_sub(sub_res=sub_res, sub_borrow=sub_borrow, a1=a1, a2=a2):
            s = sb.val(a1) - sb.val(a2)
            pb.set_val(sub_res, s & mask)
            pb.set_val(sub_borrow, 1 if s < 0 else 0)

        sb.defer(_fill_sub)
        sb.decompose(sub_res.lc(), w, f"subres{t}")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), a1 - a2 + sub_borrow.lc(1 << w),
                           sub_res.lc()),
            "sub",
        )

        eq = sb.inv_flag(a1 - a2, f"eq{t}")
        gt = sb.product(_c(1) - sub_borrow.lc(), _c(1) - eq.lc(), f"gt{t}")

        # ---- result selection -----------------------------------------
        cands = {
            "mov": a2, "cmov": a2, "add": add_res.lc(), "sub": sub_res.lc(),
            "and": res_and, "or": res_or, "xor": res_xor, "not": res_not,
        }
        result = LC()
        for opname, cand in cands.items():
            os_ = opsel(opname)
            if os_.terms:
                result = result + sb.product(os_, cand,
                                             f"res_{t}_{opname}").lc()
        load_val = pb.allocate_var(f"ldv{t}")

        def _fill_load(load_val=load_val, t=t):
            pb.set_val(load_val, sb.env["load_val"][t])

        sb.defer(_fill_load)
        os_load = opsel("loadw")
        if os_load.terms:
            result = result + sb.product(os_load, load_val.lc(),
                                         f"res_{t}_loadw").lc()

        # ---- register updates -----------------------------------------
        for r in range(K):
            wr = LC()
            cmov_wr = LC()
            for j, ins in enumerate(program.instructions):
                if ins.des == r and ins.op in WRITERS:
                    if ins.op == "cmov":
                        cmov_wr = cmov_wr + sel[j].lc()
                    else:
                        wr = wr + sel[j].lc()
            if cmov_wr.terms:
                wr = wr + sb.product(cmov_wr, flag[t].lc(),
                                     f"cmovw{t}_{r}").lc()
            delta = sb.product(wr, result - regs[t][r].lc(), f"wd{t}_{r}")
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), regs[t][r].lc() + delta.lc(),
                               regs[t + 1][r].lc()),
                "reg update",
            )

        # ---- flag update ----------------------------------------------
        rz = sb.inv_flag(result, f"rz{t}")
        flag_new = LC()
        for opname, vlc in (
            ("add", add_carry.lc()), ("sub", sub_borrow.lc()),
            ("cmpe", eq.lc()), ("cmpa", gt.lc()),
            ("cmpae", _c(1) - sub_borrow.lc()),
        ):
            os_ = opsel(opname)
            if os_.terms:
                flag_new = flag_new + sb.product(os_, vlc,
                                                 f"fl_{t}_{opname}").lc()
        os_bw = LC()
        for opname in BITWISE:
            os_bw = os_bw + opsel(opname)
        if os_bw.terms:
            flag_new = flag_new + sb.product(os_bw, rz.lc(),
                                             f"fl_{t}_bw").lc()
        keep = _c(1)
        for opname in FLAG_SETTERS:
            keep = keep - opsel(opname)
        flag_new = flag_new + sb.product(keep, flag[t].lc(),
                                         f"fl_{t}_keep").lc()
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), flag_new, flag[t + 1].lc()), "flag update"
        )

        # ---- pc update -------------------------------------------------
        taken = opsel("jmp") + opsel("answer")
        os_cj = opsel("cjmp")
        if os_cj.terms:
            taken = taken + sb.product(os_cj, flag[t].lc(), f"cj{t}").lc()
        os_cnj = opsel("cnjmp")
        if os_cnj.terms:
            taken = taken + sb.product(os_cnj, _c(1) - flag[t].lc(),
                                       f"cnj{t}").lc()
        target = LC()
        for j, ins in enumerate(program.instructions):
            if ins.op in ("jmp", "cjmp", "cnjmp"):
                target = target + sel[j].lc(ins.arg2)
            elif ins.op == "answer":
                target = target + sel[j].lc(j)
        pcd = sb.product(taken, target - pc[t].lc() - _c(1), f"pcd{t}")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), pc[t].lc() + _c(1) + pcd.lc(),
                           pc[t + 1].lc()),
            "pc update",
        )

        # ---- memory row ------------------------------------------------
        is_store = opsel("storew")
        is_mem = is_store + os_load
        addr = sb.product(is_mem, a2, f"maddr{t}")
        mval = pb.allocate_var(f"mval{t}")

        def _fill_mval(mval=mval, t=t):
            pb.set_val(mval, sb.env["mval"][t])

        sb.defer(_fill_mval)
        pb.add_r1cs_constraint(
            R1CSConstraint(is_store, a1 - mval.lc(), _c(0)), "store val"
        )
        if os_load.terms:
            pb.add_r1cs_constraint(
                R1CSConstraint(os_load, load_val.lc() - mval.lc(), _c(0)),
                "load val",
            )
        isv = pb.allocate_var(f"mst{t}")
        sb.boolean(isv)
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), is_store, isv.lc()), "is_store wire"
        )

        def _fill_isv(isv=isv, is_store=is_store):
            pb.set_val(isv, sb.val(is_store))

        sb.defer(_fill_isv)
        mem_rows.append([addr.lc(), _c(tape_len + t), isv.lc(), mval.lc()])

        if t == T - 1:
            final_sel_answer = opsel("answer")
            final_a2 = a2

    pb.add_r1cs_constraint(
        R1CSConstraint(_c(1), final_sel_answer, _c(1)), "final is answer"
    )
    pb.add_r1cs_constraint(R1CSConstraint(_c(1), final_a2, _c(0)),
                           "answer == 0")

    # ---- memory consistency via routing --------------------------------
    M = len(mem_rows)
    time_bits = max(1, math.ceil(math.log2(M + 1)))
    net = ASWaksmanRoutingGadget(pb, mem_rows, "memnet") if M > 1 else None
    if net is not None:
        net.generate_r1cs_constraints()

        def _fill_net(net=net, mem_rows=mem_rows):
            keyed = []
            for i, row in enumerate(mem_rows):
                keyed.append((sb.val(row[0]), sb.val(row[1]), i))
            order = [i for _, _, i in sorted(keyed)]
            net.generate_r1cs_witness(order)

        sb.defer(_fill_net)
        rows = net.outputs
        for i in range(1, M):
            prev = [x if isinstance(x, LC) else x.lc() for x in rows[i - 1]]
            cur = [x if isinstance(x, LC) else x.lc() for x in rows[i]]
            pa, pt_, _ps, pv = prev
            ca, ct, cs_, cv = cur
            same = sb.inv_flag(ca - pa, f"same{i}")
            # order: same -> time increases; else addr increases
            seldiff = sb.product(same.lc(), (ct - pt_) - (ca - pa),
                                 f"osel{i}")
            diff = pb.allocate_var(f"odiff{i}")
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), (ca - pa) + seldiff.lc() - _c(1),
                               diff.lc()),
                "order diff",
            )

            def _fill_diff(diff=diff, ca=ca, pa=pa, ct=ct, pt_=pt_,
                           same=same):
                if sb.val(same.lc()):
                    pb.set_val(diff, sb.val(ct) - sb.val(pt_) - 1)
                else:
                    pb.set_val(diff, sb.val(ca) - sb.val(pa) - 1)

            sb.defer(_fill_diff)
            sb.decompose(diff.lc(), w + time_bits, f"odb{i}")
            # continuity: loads copy the previous same-addr value, or 0
            spv = sb.product(same.lc(), pv, f"spv{i}")
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1) - cs_, cv - spv.lc(), _c(0)),
                "mem continuity",
            )

    handles = {
        "ap": ap, "T": T, "builder": sb, "tape_vars": tape_vars,
        "regs": regs, "flag": flag, "pc": pc, "tape_len": tape_len,
    }
    return pb, handles


def ram_witness_map(pb: Protoboard, handles, program: TinyRAMProgram, tape):
    """Fill the witness from a (successful) simulation; returns
    (accepted, primary, auxiliary)."""
    ap = handles["ap"]
    T = handles["T"]
    tape_len = handles["tape_len"]
    sb: _Builder = handles["builder"]
    assert len(tape) == tape_len

    boot = {i: tape[i] & ap.word_mask for i in range(tape_len)}
    accepted, answer, trace = simulate(
        program, tape, max_steps=T, init_mem=boot
    )
    if not accepted:
        raise ValueError("program does not accept within T steps")

    # tape (primary)
    for tv, v in zip(handles["tape_vars"], tape):
        pb.set_val(tv, v & ap.word_mask)

    # state wires; freeze after the answer step
    n_live = len(trace)
    for t in range(T + 1):
        row = trace[t] if t < n_live else trace[-1]
        for r in range(ap.k):
            pb.set_val(handles["regs"][t][r], row.regs[r])
        pb.set_val(handles["flag"][t], row.flag)
        pb.set_val(handles["pc"][t], row.pc)

    # per-step memory environment (replay, boot included)
    mem = {i: tape[i] & ap.word_mask for i in range(tape_len)}
    mvals, lvals = [], []
    for t in range(T):
        row = trace[t] if t < n_live else trace[-1]
        if t < n_live and row.mem_op is not None:
            a, is_store, v = row.mem_op
            if is_store:
                mem[a] = v
                mvals.append(v)
                lvals.append(0)
            else:
                mvals.append(v)
                lvals.append(v)
        else:
            mvals.append(mem.get(0, 0))  # no-op row reads addr 0
            lvals.append(0)
    sb.env["mval"] = mvals
    sb.env["load_val"] = lvals

    for fill in sb.fillers:
        fill()

    return accepted, pb.primary_input(), pb.auxiliary_input()


def _field_p():
    """The circuit's field: MNT4753's Fr, as the JAX package fixes it."""
    return FIELD_A.p
