"""RAM zkSNARK with incremental (PCD-based) proving — ram_zksnark parity.

Counterpart of the JAX package's ``proof_systems/ram_zksnark.py`` (libsnark
zk_proof_systems/zksnark/ram_zksnark: ram_zksnark.{hpp,tcc} and
ram_compliance_predicate.{hpp,tcc}): prove "TinyRAM program P accepts within
T steps" with proving time and space per step independent of T, by
expressing ONE machine step as a PCD compliance predicate and folding the
execution through the single-predicate PCD (``proof_systems/pcd.SPPCDProver``
≙ r1cs_sp_ppzkpcd), unlike ``proof_systems/ram_ppzksnark.py``, which
unrolls all T steps into one circuit.

  * the PCD message carries the machine state between steps (timestamp,
    pc, flag, registers, memory root, the has-accepted bit) as field wires;
    memory is a Merkle tree over the knapsack CRH (``gadgets/knapsack.py``),
    2^addr_depth words;
  * the compliance predicate is ONE TinyRAM CPU step (the pc one-hot
    decode, operand resolution, ALU and update selection of
    ``reductions/ram_to_r1cs.py``) plus two conditional Merkle walks for the
    step's loadw / storew against the incoming and outgoing roots;
  * ``generator`` builds the predicate and keys it through the PCD layer;
    ``prover`` runs the per-step witness map and proves each step;
    ``verifier`` checks the final message's proof and that it accepts.

The program is compiled into the predicate (a constant instruction table).
Where the JAX package sums over sets of opcode names, whose order follows
the interpreter's string hashes, the port sums in the fixed order of
``reductions/ram_to_r1cs.py``: the terms are the same, their order within a
combination may differ.

Two departures from the JAX package, both where it cannot run:

  * its prover hands each step's PCD prove an empty witness, while the
    predicate's witness is every wire beyond the message prefix, so the
    step circuit's fill raises at the first step.  The port hands over the
    step's full witness (the handler's wires beyond the prefix), as
    libsnark's prover does;
  * at arity 1 its step 0 has no inner proof and each later step feeds a
    proof of the outer curve to a verifier gadget that expects one of the
    partner curve.  The port's ``generator`` raises ValueError on arity >= 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gadgets.knapsack import (
    FieldBitsGadget,
    KnapsackCRHGadget,
    knapsack_hash_fields,
)
from ..gadgets.protoboard import PBVariable, Protoboard
from ..host.curves import host_curve
from ..relations.r1cs import LinearCombination as LC, R1CSConstraint
from ..relations.tinyram import TinyRAMProgram
from ..utils.profiling import Profiler
from .pcd import CompliancePredicate, R1CSPCDLocalData, R1CSPCDMessage, SPPCDProver

SUPPORTED_OPS = frozenset({
    "mov", "cmov", "add", "sub", "and", "or", "xor", "not", "cmpe",
    "cmpa", "cmpae", "jmp", "cjmp", "cnjmp", "storew", "loadw", "answer",
})
# summed over in these orders (the JAX package's are sets)
BITWISE = ("and", "or", "xor", "not")
WRITERS = frozenset({"mov", "cmov", "add", "sub", "and", "or", "xor", "not", "loadw"})
FLAG_SETTERS = ("add", "sub", "and", "or", "xor", "not", "cmpe", "cmpa", "cmpae")


def _c(x):
    return LC.constant(x)


def _lc(x):
    return x.lc() if isinstance(x, PBVariable) else x


def merkle_mem_root(p: int, mem: dict, depth: int) -> int:
    """Host root of the 2^depth-word memory (missing words are 0)."""
    level = [mem.get(i, 0) % p for i in range(1 << depth)]
    while len(level) > 1:
        level = [
            knapsack_hash_fields(p, [level[2 * i], level[2 * i + 1]])
            for i in range(len(level) // 2)
        ]
    return level[0]


def merkle_mem_path(p: int, mem: dict, depth: int, addr: int):
    level = [mem.get(i, 0) % p for i in range(1 << depth)]
    sibs = []
    idx = addr
    while len(level) > 1:
        sibs.append(level[idx ^ 1])
        level = [
            knapsack_hash_fields(p, [level[2 * i], level[2 * i + 1]])
            for i in range(len(level) // 2)
        ]
        idx >>= 1
    return sibs


class _MerkleWalkGadget:
    """Root computation (UNPINNED — the caller binds conditionally) from
    a leaf wire, shared address-bit wires and sibling wires."""

    def __init__(self, pb, depth, leaf_lc, addr_bits, siblings, ann):
        self.pb = pb
        self.depth = depth
        self.addr_bits = addr_bits
        self.siblings = siblings
        self._levels = []
        cur = leaf_lc
        for k in range(depth):
            ab = addr_bits[k]
            sib = siblings[k]
            left = pb.allocate_var(f"{ann}.l{k}")
            right = pb.allocate_var(f"{ann}.r{k}")
            pb.add_r1cs_constraint(
                R1CSConstraint(_lc(ab), _lc(sib) - cur, left.lc() - cur),
                f"{ann}.sl{k}",
            )
            pb.add_r1cs_constraint(
                R1CSConstraint(_lc(ab), cur - _lc(sib), right.lc() - _lc(sib)),
                f"{ann}.sr{k}",
            )
            lb = FieldBitsGadget(pb, left, f"{ann}.lb{k}")
            rb = FieldBitsGadget(pb, right, f"{ann}.rb{k}")
            parent = pb.allocate_var(f"{ann}.h{k}")
            crh = KnapsackCRHGadget(pb, list(lb.bits) + list(rb.bits),
                                    parent, f"{ann}.c{k}")
            self._levels.append((left, right, lb, rb, crh, parent))
            cur = parent.lc()
        self.root = cur

    def fill(self, leaf_val, addr, sib_vals):
        pb = self.pb
        cur = leaf_val % pb.p
        for k, (left, right, lb, rb, crh, parent) in enumerate(self._levels):
            a = (addr >> k) & 1
            s = sib_vals[k] % pb.p
            lv, rv = (s, cur) if a else (cur, s)
            pb.set_val(left, lv)
            pb.set_val(right, rv)
            lb.generate_r1cs_witness()
            rb.generate_r1cs_witness()
            crh.generate_r1cs_witness()
            cur = pb.val(parent)
        return cur


@dataclass
class RamState:
    """One machine state = one PCD message payload."""

    timestamp: int
    pc: int
    flag: int
    regs: list
    root: int
    has_accepted: int

    def payload(self):
        return ([self.timestamp, self.pc, self.flag] + list(self.regs)
                + [self.root, self.has_accepted])


class RamCompliancePredicateHandler:
    """ram_compliance_predicate_handler: the one-step predicate circuit
    over wires [1 | out msg | arity | in msg | local data | witness].

    Message payload: [timestamp, pc, flag, regs*K, mem_root,
    has_accepted].  Local data: [want_halt].  The witness region holds
    the step's internal wires (allocated after the predicate prefix, so
    the CompliancePredicate wire convention is preserved)."""

    def __init__(self, program: TinyRAMProgram, addr_depth: int, p: int):
        for ins in program.instructions:
            if ins.op not in SUPPORTED_OPS:
                raise NotImplementedError(f"opcode {ins.op}")
        self.program = program
        self.addr_depth = addr_depth
        ap = program.ap
        self.K = ap.k
        self.w = ap.w
        self.mask = ap.word_mask
        self.state_len = 3 + self.K + 2  # ts, pc, flag, regs, root, acc
        self.p = p

        pb = Protoboard(p)
        self.pb = pb
        self._fills = []

        # ---- predicate wire prefix ------------------------------------
        self.out_type = pb.allocate_var("out_type")
        self.out_state = [pb.allocate_var(f"out{i}")
                          for i in range(self.state_len)]
        self.arity = pb.allocate_var("arity")
        self.in_type = pb.allocate_var("in_type")
        self.in_state = [pb.allocate_var(f"in{i}")
                         for i in range(self.state_len)]
        self.want_halt = pb.allocate_var("want_halt")
        pb.set_input_sizes(1 + self.state_len)  # primary = outgoing msg

        self._build_step()

    # -- small helpers ---------------------------------------------------
    def _bool(self, v, ann=""):
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_lc(v), _c(1) - _lc(v), _c(0)), f"bool {ann}"
        )

    def _prod(self, a_lc, b_lc, ann=""):
        t = self.pb.allocate_var(f"p.{ann}")
        self.pb.add_r1cs_constraint(
            R1CSConstraint(a_lc, b_lc, t.lc()), f"prod {ann}"
        )

        def fill(a_lc=a_lc, b_lc=b_lc, t=t):
            self.pb.set_val(t, self.pb.lc_val(a_lc) * self.pb.lc_val(b_lc))

        self._fills.append(fill)
        return t

    def _decompose(self, v_lc, nbits, ann=""):
        bits = [self.pb.allocate_var(f"{ann}.b{i}") for i in range(nbits)]
        acc = LC()
        for i, b in enumerate(bits):
            self._bool(b, ann)
            acc = acc + b.lc(1 << i)
        self.pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), acc, v_lc), f"pack {ann}"
        )

        def fill(v_lc=v_lc, bits=bits):
            v = self.pb.lc_val(v_lc)
            for i, b in enumerate(bits):
                self.pb.set_val(b, (v >> i) & 1)

        self._fills.append(fill)
        return bits

    def _inv_flag(self, d_lc, ann=""):
        """z = (d == 0) via the inverse-witness trick."""
        pb = self.pb
        z = pb.allocate_var(f"z.{ann}")
        dinv = pb.allocate_var(f"di.{ann}")
        pb.add_r1cs_constraint(
            R1CSConstraint(d_lc, dinv.lc(), _c(1) - z.lc()), f"invf {ann}"
        )
        pb.add_r1cs_constraint(
            R1CSConstraint(d_lc, z.lc(), _c(0)), f"invz {ann}"
        )

        def fill(d_lc=d_lc, z=z, dinv=dinv):
            d = pb.lc_val(d_lc)
            pb.set_val(z, 1 if d == 0 else 0)
            pb.set_val(dinv, pow(d, -1, pb.p) if d else 0)

        self._fills.append(fill)
        return z

    # -- the CPU step ----------------------------------------------------
    def _build_step(self):
        pb = self.pb
        program = self.program
        L = len(program.instructions)
        K, w, mask = self.K, self.w, self.mask
        ts_in, pc_in, flag_in = (x.lc() for x in self.in_state[:3])
        regs_in = [x.lc() for x in self.in_state[3:3 + K]]
        root_in = self.in_state[3 + K].lc()
        acc_in = self.in_state[3 + K + 1].lc()
        ts_out, pc_out, flag_out = (x.lc() for x in self.out_state[:3])
        regs_out = [x.lc() for x in self.out_state[3:3 + K]]
        root_out = self.out_state[3 + K].lc()
        acc_out = self.out_state[3 + K + 1].lc()

        # types: fixed tag 1; arity pinned by the PCD layer (0 or 1)
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), self.out_type.lc(), _c(1)), "type"
        )
        # timestamp advances
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), ts_in + _c(1), ts_out), "ts"
        )

        # ---- pc one-hot + operands (ram_to_r1cs schedule) -------------
        sel = [pb.allocate_var(f"s{j}") for j in range(L)]
        for s in sel:
            self._bool(s, "sel")
        tot, pcsum = LC(), LC()
        for j, s in enumerate(sel):
            tot = tot + s.lc()
            pcsum = pcsum + s.lc(j)
        pb.add_r1cs_constraint(R1CSConstraint(_c(1), tot, _c(1)), "sel one")
        pb.add_r1cs_constraint(R1CSConstraint(_c(1), pcsum, pc_in), "sel pc")

        def fill_sel():
            pcv = pb.lc_val(pc_in)
            for j, s in enumerate(sel):
                pb.set_val(s, 1 if j == pcv else 0)

        self._fills.append(fill_sel)

        def opsel(opname):
            out = LC()
            for j, ins in enumerate(program.instructions):
                if ins.op == opname:
                    out = out + sel[j].lc()
            return out

        a1, a2 = LC(), LC()
        for j, ins in enumerate(program.instructions):
            pa = self._prod(sel[j].lc(), regs_in[ins.arg1], f"a1_{j}")
            a1 = a1 + pa.lc()
            if ins.arg2_is_imm:
                a2 = a2 + sel[j].lc(ins.arg2 & mask)
            else:
                p2 = self._prod(sel[j].lc(), regs_in[ins.arg2], f"a2_{j}")
                a2 = a2 + p2.lc()
        a1b = self._decompose(a1, w, "a1b")
        a2b = self._decompose(a2, w, "a2b")

        # ---- ALU ------------------------------------------------------
        and_bits = [self._prod(x.lc(), y.lc(), f"and{i}")
                    for i, (x, y) in enumerate(zip(a1b, a2b))]
        res_and, res_or, res_xor = LC(), LC(), LC()
        for i, (x, y, xy) in enumerate(zip(a1b, a2b, and_bits)):
            res_and = res_and + xy.lc(1 << i)
            res_or = res_or + x.lc(1 << i) + y.lc(1 << i) - xy.lc(1 << i)
            res_xor = res_xor + x.lc(1 << i) + y.lc(1 << i) - xy.lc(2 << i)
        res_not = _c(mask) - a2

        add_res = pb.allocate_var("addr_")
        add_carry = pb.allocate_var("addc")
        self._bool(add_carry)

        def fill_add():
            s = pb.lc_val(a1) + pb.lc_val(a2)
            pb.set_val(add_res, s & mask)
            pb.set_val(add_carry, s >> w)

        self._fills.append(fill_add)
        self._decompose(add_res.lc(), w, "addres")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), a1 + a2,
                           add_res.lc() + add_carry.lc(1 << w)), "add"
        )

        sub_res = pb.allocate_var("subr")
        sub_borrow = pb.allocate_var("subb")
        self._bool(sub_borrow)

        def fill_sub():
            s = pb.lc_val(a1) - pb.lc_val(a2)
            pb.set_val(sub_res, s & mask)
            pb.set_val(sub_borrow, 1 if s < 0 else 0)

        self._fills.append(fill_sub)
        self._decompose(sub_res.lc(), w, "subres")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), a1 - a2 + sub_borrow.lc(1 << w),
                           sub_res.lc()), "sub"
        )

        eq = self._inv_flag(a1 - a2, "eq")
        gt = self._prod(_c(1) - sub_borrow.lc(), _c(1) - eq.lc(), "gt")

        # ---- memory: two conditional Merkle walks ---------------------
        is_store = opsel("storew")
        is_load = opsel("loadw")
        is_mem = is_store + is_load
        addr = self._prod(is_mem, a2, "maddr")
        addr_bits = self._decompose(addr.lc(), self.addr_depth, "maddrb")
        old_val = pb.allocate_var("mold")
        new_val = pb.allocate_var("mnew")
        sibs = [pb.allocate_var(f"msib{k}") for k in range(self.addr_depth)]
        walk_old = _MerkleWalkGadget(pb, self.addr_depth, old_val.lc(),
                                     addr_bits, sibs, "wo")
        walk_new = _MerkleWalkGadget(pb, self.addr_depth, new_val.lc(),
                                     addr_bits, sibs, "wn")
        self.walk_old, self.walk_new = walk_old, walk_new
        self.old_val, self.new_val, self.sibs = old_val, new_val, sibs
        # memory ops must authenticate the old value under root_in
        mchk = self._prod(is_mem, walk_old.root - root_in, "mchk")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), mchk.lc(), _c(0)), "mem auth"
        )
        # stores write a2's... store value is a1 (storew a, r: mem[a2]=a1)
        svd = self._prod(is_store, a1 - old_val.lc(), "svd")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), old_val.lc() + svd.lc(), new_val.lc()),
            "store val",
        )
        # root_out = root_in + is_store*(walk_new.root - root_in)
        rd = self._prod(is_store, walk_new.root - root_in, "rootd")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), root_in + rd.lc(), root_out), "root upd"
        )

        # ---- result selection -----------------------------------------
        cands = {
            "mov": a2, "cmov": a2, "add": add_res.lc(),
            "sub": sub_res.lc(), "and": res_and, "or": res_or,
            "xor": res_xor, "not": res_not,
        }
        result = LC()
        for opname, cand in cands.items():
            os_ = opsel(opname)
            if os_.terms:
                result = result + self._prod(os_, cand, f"res_{opname}").lc()
        if is_load.terms:
            result = result + self._prod(is_load, old_val.lc(),
                                         "res_loadw").lc()

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
                wr = wr + self._prod(cmov_wr, flag_in, f"cmovw{r}").lc()
            delta = self._prod(wr, result - regs_in[r], f"wd{r}")
            pb.add_r1cs_constraint(
                R1CSConstraint(_c(1), regs_in[r] + delta.lc(), regs_out[r]),
                "reg update",
            )

        # ---- flag update ----------------------------------------------
        rz = self._inv_flag(result, "rz")
        flag_new = LC()
        for opname, vlc in (
            ("add", add_carry.lc()), ("sub", sub_borrow.lc()),
            ("cmpe", eq.lc()), ("cmpa", gt.lc()),
            ("cmpae", _c(1) - sub_borrow.lc()),
        ):
            os_ = opsel(opname)
            if os_.terms:
                flag_new = flag_new + self._prod(os_, vlc,
                                                 f"fl_{opname}").lc()
        os_bw = LC()
        for opname in BITWISE:
            os_bw = os_bw + opsel(opname)
        if os_bw.terms:
            flag_new = flag_new + self._prod(os_bw, rz.lc(), "fl_bw").lc()
        keep = _c(1)
        for opname in FLAG_SETTERS:
            keep = keep - opsel(opname)
        flag_new = flag_new + self._prod(keep, flag_in, "fl_keep").lc()
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), flag_new, flag_out), "flag update"
        )

        # ---- pc update -------------------------------------------------
        taken = opsel("jmp") + opsel("answer")
        os_cj = opsel("cjmp")
        if os_cj.terms:
            taken = taken + self._prod(os_cj, flag_in, "cj").lc()
        os_cnj = opsel("cnjmp")
        if os_cnj.terms:
            taken = taken + self._prod(os_cnj, _c(1) - flag_in, "cnj").lc()
        target = LC()
        for j, ins in enumerate(program.instructions):
            if ins.op in ("jmp", "cjmp", "cnjmp"):
                target = target + sel[j].lc(ins.arg2)
            elif ins.op == "answer":
                target = target + sel[j].lc(j)  # freeze: pc self-loop
        pcd_ = self._prod(taken, target - pc_in - _c(1), "pcd")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), pc_in + _c(1) + pcd_.lc(), pc_out),
            "pc update",
        )

        # ---- acceptance ------------------------------------------------
        # has_accepted_out = acc_in OR (is_answer AND a2 == 0)
        is_ans = opsel("answer")
        a2z = self._inv_flag(a2, "a2z")
        ok = self._prod(is_ans, a2z.lc(), "ansok") if is_ans.terms else None
        ok_lc = ok.lc() if ok is not None else _c(0)
        both = self._prod(acc_in, ok_lc, "accand")
        pb.add_r1cs_constraint(
            R1CSConstraint(_c(1), acc_in + ok_lc - both.lc(), acc_out),
            "accept",
        )

    # -- predicate packaging --------------------------------------------
    def get_compliance_predicate(self) -> CompliancePredicate:
        cs = self.pb.get_constraint_system()
        n_prefix = self.prefix_length
        return CompliancePredicate(
            name=11, type=1, constraint_system=cs,
            outgoing_message_payload_length=self.state_len,
            max_arity=1,
            incoming_message_payload_lengths=[self.state_len],
            local_data_length=1,
            witness_length=self.pb.num_variables - n_prefix,
            relies_on_same_type_inputs=True,
        )

    # -- witness map -----------------------------------------------------
    def witness_map(self, state_in: RamState, mem: dict, want_halt: int):
        """Execute one step from state_in over `mem` (mutated), fill
        every wire and return state_out; ``step_witness`` then gives the
        predicate's witness.  The caller packages messages/local data for
        the PCD layer.  Raises ValueError where the step does not satisfy
        the predicate (a state that memory does not authenticate)."""
        pb = self.pb
        program = self.program
        mask = self.mask
        p = self.p
        pcv = state_in.pc
        ins = program.instructions[pcv]
        regs = list(state_in.regs)
        a1 = regs[ins.arg1]
        a2 = (ins.arg2 & mask) if ins.arg2_is_imm else regs[ins.arg2]

        # memory effect (host)
        is_mem = ins.op in ("storew", "loadw")
        addr = a2 if is_mem else 0
        old_val = mem.get(addr, 0) if is_mem else 0
        sib_vals = merkle_mem_path(p, mem, self.addr_depth, addr)
        new_val = a1 if ins.op == "storew" else old_val
        if ins.op == "storew":
            mem[addr] = a1

        # machine step (host)
        flag = state_in.flag
        nxt = pcv + 1
        acc = state_in.has_accepted
        op = ins.op
        if op == "mov":
            regs[ins.des] = a2
        elif op == "cmov":
            if flag:
                regs[ins.des] = a2
        elif op == "add":
            s = a1 + a2
            regs[ins.des] = s & mask
            flag = s >> self.w
        elif op == "sub":
            s = a1 - a2
            regs[ins.des] = s & mask
            flag = 1 if s < 0 else 0
        elif op == "and":
            regs[ins.des] = a1 & a2
            flag = int(regs[ins.des] == 0)
        elif op == "or":
            regs[ins.des] = a1 | a2
            flag = int(regs[ins.des] == 0)
        elif op == "xor":
            regs[ins.des] = a1 ^ a2
            flag = int(regs[ins.des] == 0)
        elif op == "not":
            regs[ins.des] = (~a2) & mask
            flag = int(regs[ins.des] == 0)
        elif op == "cmpe":
            flag = int(a1 == a2)
        elif op == "cmpa":
            flag = int(a1 > a2)
        elif op == "cmpae":
            flag = int(a1 >= a2)
        elif op == "jmp":
            nxt = ins.arg2
        elif op == "cjmp":
            nxt = ins.arg2 if flag else nxt
        elif op == "cnjmp":
            nxt = nxt if flag else ins.arg2
        elif op == "loadw":
            regs[ins.des] = old_val
        elif op == "storew":
            pass
        elif op == "answer":
            nxt = pcv  # freeze
            acc = acc or int(a2 == 0)

        state_out = RamState(
            timestamp=state_in.timestamp + 1, pc=nxt, flag=flag,
            regs=regs, root=merkle_mem_root(p, mem, self.addr_depth),
            has_accepted=acc,
        )

        # ---- fill wires ------------------------------------------------
        pb.set_val(self.out_type, 1)
        for var, val in zip(self.out_state, state_out.payload()):
            pb.set_val(var, val)
        pb.set_val(self.arity, 1)
        pb.set_val(self.in_type, 1)
        for var, val in zip(self.in_state, state_in.payload()):
            pb.set_val(var, val)
        pb.set_val(self.want_halt, want_halt)
        pb.set_val(self.old_val, old_val)
        pb.set_val(self.new_val, new_val)
        for var, val in zip(self.sibs, sib_vals):
            pb.set_val(var, val)
        # walk fills FIRST: the mchk/rootd product fills (inside _fills)
        # read the walk-root wires
        self.walk_old.fill(old_val, addr, sib_vals)
        self.walk_new.fill(new_val, addr, sib_vals)
        for fill in self._fills:
            fill()
        if not self.pb.is_satisfied():
            raise ValueError(f"step {state_in.timestamp} ({op}) does not satisfy the predicate")
        return state_out

    @property
    def prefix_length(self) -> int:
        """Wires before the witness: [out msg | arity | in msg | local data]."""
        return (1 + self.state_len) + 1 + (1 + self.state_len) + 1

    def step_witness(self) -> list:
        """The predicate's witness for the step ``witness_map`` last filled:
        every wire beyond the prefix."""
        return (self.pb.primary_input() + self.pb.auxiliary_input())[self.prefix_length :]


# ---------------------------------------------------------------------------
# The zkSNARK composition (ram_zksnark.tcc)
# ---------------------------------------------------------------------------


@dataclass
class RamZKKeypair:
    pcd_kp: object
    handler: RamCompliancePredicateHandler
    program: TinyRAMProgram
    addr_depth: int
    pcd: SPPCDProver = field(default=None, repr=False, compare=False)


def base_case_state(handler: RamCompliancePredicateHandler, primary_input) -> RamState:
    """get_base_case_message: memory boots from the primary input at
    addresses 0..n-1 (as_memory_contents), machine state zeroed."""
    mem = {i: v & handler.mask for i, v in enumerate(primary_input)}
    return RamState(
        timestamp=0, pc=0, flag=0, regs=[0] * handler.K,
        root=merkle_mem_root(handler.p, mem, handler.addr_depth),
        has_accepted=0,
    )


def generator(program: TinyRAMProgram, addr_depth: int, rng, outer_curve: str = "MNT4753",
              arity: int = 0, device="cuda", profiler: Profiler | None = None) -> RamZKKeypair:
    """ram_zksnark_generator: the one-step predicate, keyed by the sp PCD
    (``SPPCDProver.keygen`` on ``device``, the card unless the caller passes
    "cpu").  Each step's compliance is proved standalone (arity 0); arity
    >= 1 raises ValueError (the module's docstring)."""
    if arity:
        raise ValueError("the RAM zkSNARK proves each step standalone (arity 0): at arity 1 the "
                         "reference's recursion feeds a proof of the outer curve to a verifier "
                         "of the partner curve's")
    p = host_curve("MNT6753" if outer_curve == "MNT4753" else "MNT4753").g2.F.p
    handler = RamCompliancePredicateHandler(program, addr_depth, p)
    pred = handler.get_compliance_predicate()
    pcd = SPPCDProver(outer_curve, device)
    kp = pcd.keygen(pred, rng, profiler=profiler)
    return RamZKKeypair(pcd_kp=kp, handler=handler, program=program, addr_depth=addr_depth,
                        pcd=pcd)


def prover(kp: RamZKKeypair, primary_input, time_bound: int, rng,
           profiler: Profiler | None = None, on_step=None):
    """ram_zksnark_prover: per step, the witness map and the PCD prove of
    the step's messages with its witness (ram_zksnark.tcc:124-210's step
    loop).  ``on_step(step, state_in, state_out, proof)``, if given, is
    called after each step's prove, while the step circuit still holds
    that step's assignment.  Returns the final state and its proof."""
    handler = kp.handler
    mem = {i: v & handler.mask for i, v in enumerate(primary_input)}
    state = base_case_state(handler, primary_input)
    proof = None
    for step in range(time_bound):
        prev = state
        state = handler.witness_map(prev, mem, want_halt=0)
        out_msg = R1CSPCDMessage(type=1, payload=state.payload())
        in_msg = R1CSPCDMessage(type=1, payload=prev.payload())
        ld = R1CSPCDLocalData(payload=[0])
        proof = kp.pcd.prove(kp.pcd_kp, out_msg, [in_msg], ld, handler.step_witness(), rng,
                             profiler=profiler)
        if on_step is not None:
            on_step(step, prev, state, proof)
    return state, proof


def verifier(kp: RamZKKeypair, primary_input, final_state: RamState, proof) -> bool:
    """ram_zksnark_verifier: PCD-verify the final message and check it
    encodes acceptance."""
    if not final_state.has_accepted:
        return False
    out_msg = R1CSPCDMessage(type=1, payload=final_state.payload())
    return kp.pcd.verify(kp.pcd_kp, out_msg, proof)
