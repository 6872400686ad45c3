"""TinyRAM, the RAM machine behind libsnark's ram_ppzksnark, on the host.

Counterpart of the JAX package's ``relations/tinyram.py`` (libsnark
relations/ram_computations/rams/tinyram, tinyram_aux.{hpp,cpp}): the
architecture parameters (w-bit words, k registers), the 2^5-opcode ISA and
its instruction encoding, programs, and a simulator of the whole ISA with
the condition flag, program-counter semantics and the primary input on a
read-only tape.  The circuit (``reductions.ram_to_r1cs``) constrains the
subset of opcodes in its ``CIRCUIT_OPS``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# tinyram_aux.hpp:27-65
OPCODES = {
    "and": 0b00000, "or": 0b00001, "xor": 0b00010, "not": 0b00011,
    "add": 0b00100, "sub": 0b00101, "mull": 0b00110, "umulh": 0b00111,
    "smulh": 0b01000, "udiv": 0b01001, "umod": 0b01010, "shl": 0b01011,
    "shr": 0b01100, "cmpe": 0b01101, "cmpa": 0b01110, "cmpae": 0b01111,
    "cmpg": 0b10000, "cmpge": 0b10001, "mov": 0b10010, "cmov": 0b10011,
    "jmp": 0b10100, "cjmp": 0b10101, "cnjmp": 0b10110,
    "storeb": 0b11010, "loadb": 0b11011, "storew": 0b11100,
    "loadw": 0b11101, "read": 0b11110, "answer": 0b11111,
}
OPCODE_NAMES = {v: k for k, v in OPCODES.items()}


@dataclass(frozen=True)
class TinyRAMArchParams:
    """(w, k) — word size and register count (tinyram_aux.hpp:88-108)."""

    w: int = 16
    k: int = 16

    @property
    def word_mask(self) -> int:
        return (1 << self.w) - 1


@dataclass(frozen=True)
class Instruction:
    """op des, arg1, arg2 — arg2 is a register index or an immediate
    (tinyram_aux.hpp:110-147 tinyram_instruction)."""

    op: str
    des: int = 0
    arg1: int = 0
    arg2: int = 0
    arg2_is_imm: bool = True

    def encode(self, ap: TinyRAMArchParams) -> int:
        """Pack into the reference's 2w-bit word layout
        (tinyram_aux.cpp:42-55: opcode | imm-flag | des | arg1 | arg2)."""
        reg_bits = max(1, math.ceil(math.log2(ap.k)))
        out = OPCODES[self.op]
        out = (out << 1) | (1 if self.arg2_is_imm else 0)
        out = (out << reg_bits) | self.des
        out = (out << reg_bits) | self.arg1
        out = (out << ap.w) | (self.arg2 & ap.word_mask)
        return out


@dataclass
class ExecutionStep:
    """One row of the execution trace (timestamp, pc, instruction index,
    registers BEFORE, flag BEFORE, memory op if any)."""

    t: int
    pc: int
    regs: list
    flag: int
    mem_op: tuple | None = None  # (addr, is_store, value)


@dataclass
class TinyRAMProgram:
    ap: TinyRAMArchParams
    instructions: list  # of Instruction

    def add(self, op, des=0, arg1=0, arg2=0, imm=True):
        self.instructions.append(Instruction(op, des, arg1, arg2, imm))
        return self


def simulate(program: TinyRAMProgram, primary_tape, max_steps=1 << 12,
             init_mem: dict | None = None):
    """Execute; returns (accepted, answer, trace: [ExecutionStep]).

    Accepting computation == `answer 0` (ram_params accept semantics).
    Registers/flag start zero; the input tape feeds `read 0`.
    init_mem preloads memory — the circuit reduction boot-stores the
    tape at addresses 0..n-1 (ram_to_r1cs boot region), so its witness
    map simulates with init_mem={i: tape[i]}."""
    ap = program.ap
    mask = ap.word_mask
    regs = [0] * ap.k
    flag = 0
    pc = 0
    mem: dict[int, int] = dict(init_mem or {})
    tape = list(primary_tape)
    tape_pos = 0
    trace: list[ExecutionStep] = []

    def sval(v):  # signed view
        return v - (1 << ap.w) if v >> (ap.w - 1) else v

    for t in range(max_steps):
        if pc >= len(program.instructions):
            return False, None, trace
        ins = program.instructions[pc]
        a2 = (ins.arg2 & mask) if ins.arg2_is_imm else regs[ins.arg2]
        a1 = regs[ins.arg1]
        step = ExecutionStep(t, pc, list(regs), flag)
        trace.append(step)
        nxt = pc + 1
        op = ins.op
        if op == "and":
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
        elif op == "add":
            s = a1 + a2
            regs[ins.des] = s & mask
            flag = s >> ap.w
        elif op == "sub":
            s = a1 - a2
            regs[ins.des] = s & mask
            flag = int(s < 0)  # borrow
        elif op == "mull":
            s = a1 * a2
            regs[ins.des] = s & mask
            flag = int((s >> ap.w) != 0)
        elif op == "umulh":
            s = a1 * a2
            regs[ins.des] = (s >> ap.w) & mask
            flag = int((s >> ap.w) != 0)
        elif op == "smulh":
            s = sval(a1) * sval(a2)
            regs[ins.des] = (s >> ap.w) & mask
            # flag: signed product overflows one signed word
            flag = int(not (-(1 << (ap.w - 1)) <= s < (1 << (ap.w - 1))))
        elif op == "udiv":
            regs[ins.des] = 0 if a2 == 0 else a1 // a2
            flag = int(a2 == 0)
        elif op == "umod":
            regs[ins.des] = 0 if a2 == 0 else a1 % a2
            flag = int(a2 == 0)
        elif op == "shl":
            s = a1 << min(a2, 2 * ap.w)
            regs[ins.des] = s & mask
            flag = (a1 >> (ap.w - 1)) & 1
        elif op == "shr":
            regs[ins.des] = a1 >> min(a2, 2 * ap.w)
            flag = a1 & 1
        elif op == "cmpe":
            flag = int(a1 == a2)
        elif op == "cmpa":
            flag = int(a1 > a2)
        elif op == "cmpae":
            flag = int(a1 >= a2)
        elif op == "cmpg":
            flag = int(sval(a1) > sval(a2))
        elif op == "cmpge":
            flag = int(sval(a1) >= sval(a2))
        elif op == "mov":
            regs[ins.des] = a2
        elif op == "cmov":
            if flag:
                regs[ins.des] = a2
        elif op == "jmp":
            nxt = a2
        elif op == "cjmp":
            if flag:
                nxt = a2
        elif op == "cnjmp":
            if not flag:
                nxt = a2
        elif op == "storew":
            mem[a2] = a1
            step.mem_op = (a2, True, a1)
        elif op == "loadw":
            v = mem.get(a2, 0)
            regs[ins.des] = v
            step.mem_op = (a2, False, v)
        elif op == "storeb":
            mem[a2] = a1 & 0xFF
            step.mem_op = (a2, True, a1 & 0xFF)
        elif op == "loadb":
            v = mem.get(a2, 0) & 0xFF
            regs[ins.des] = v
            step.mem_op = (a2, False, v)
        elif op == "read":
            if a2 == 0 and tape_pos < len(tape):
                regs[ins.des] = tape[tape_pos] & mask
                tape_pos += 1
                flag = 0
            else:
                regs[ins.des] = 0
                flag = 1
        elif op == "answer":
            return a2 == 0, a2, trace
        else:
            raise ValueError(f"unknown opcode {op}")
        pc = nxt
    return False, None, trace
