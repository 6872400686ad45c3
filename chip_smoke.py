#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sizes4 250,98304,1048576]
                          [--sizes6 24576,32768,819200]
                          [--keygen4 131072] [--keygen6 32768] [--gm17-4 65536]
                          [--pghr13-4 65536]
                          [--adsnark4 65536,16] [--adsnark6 32768,8]
                          [--bacs-gates 16384] [--ram4 65536]
                          [--tbcs4 31744,1024,32,1024] [--tbcs6 16128,256,8,256]
                          [--towers 4099] [--pcd 2] [--mp-pcd 1] [--ram-zksnark 2]
                          [--fixnum 1048576] [--pedersen 32] [--caml4 32768]
                          [--caml6 1024] [--polynomial 524288] [--functions 16384]
                          [--seed 1]

Builds the CUDA kernels from the sources in this checkout and then, for
MNT4753 and for MNT6753 in turn: checks the curve's GT tower (``towers``:
Fq4 / Fq6 mul, sqr, inv, every Frobenius power and the unitary inverse on
norm-1 elements, and G2 ``mul_by_q``, at ``--towers`` lanes against exact
host values); holds every kernel against its plain
PyTorch version on the card (ragged N with the edge lanes), proves the
committed fixture byte for byte through the command line's ``main``, and
proves at full size (m = d + 1, all five MSMs) through ``prove_files`` on
files written in the wire format, checking the result against proof bytes
that the host computes with exact integers, independently of the device
code.  Before each full-size prove the files are read by both readers
(the numpy one and the device reader that the prover uses on the card),
timed, and their words held equal.  MNT4753 is proved at d + 1 = 250 (a
geometric sequence domain), at 2^16 + 2^15 = 98304 (step radix-2, the
domain a circuit of 2^16 to 1.5 * 2^16 constraints gets) and at the
challenge's own 2^20 (radix-2); MNT6753 at 2^14 + 2^13 = 24576 (step
radix-2), at the challenge's own 2^15 (radix-2) and at 25 * 2^15 = 819200
(mixed radix), the largest domain its scalar field has.  The kernel
wrappers record the lane counts of each prove's launches (and, for the
doublings, the doublings a launch); every kernel is then compared with its
plain version again, and timed, at the lane counts of the largest prove of
its curve, the doublings at every (lanes, doublings) of the curve's proves
and in bulk.

Then each curve generates its keys (``keygen``: the command line's
``generate_for_curve`` on the card, MNT4753 at d + 1 = ``--keygen4``,
2^17, an eighth of the reference's default, MNT6753 at ``--keygen6``, the
reference's default): its launch counts,
phase times and peak memory; its queries checked against exact host
multiplication (the first and last entries, 256 random ones and every
identity, with the scalars replayed from the seed on the host and the QAP
evaluated at t by this script's own Lagrange basis); the
generated files proved through ``prove_files`` and the proof held to bytes
that the host computes without any MSM; and every kernel compared with its
plain version, and timed, at the keygen's largest and most frequent lane
counts.

Then, on the key generation's in-process proving key and its host replay,
the ``groth16`` phase: the blinded prover (``groth16_full.prover``, r and s
drawn from the seed) with its launch counts, phase times and peak memory,
its bytes held to bytes the host computes without any MSM; the
verification key and ``verifier_strong_IC`` accepting the proof and
rejecting a wrong input, a tampered A and a truncated input;
``kc_multi_exp_fused`` (which is ``kc_multi_exp``) against the prover's B
MSMs, timed; the witness map, plain and with a random zero-knowledge
patch, by the identity (A + d1 Z)(B + d2 Z) - (C + d3 Z) = H Z at the key's
t; ``bg.prover`` with a random d against the host's scalars and its
verifier; the keys and the proof through ``io.keys``, timed; and every
kernel compared and timed at the blinded prove's lane counts.

Then the ``gm17`` phase (GM17 on the R1CS -> SAP reduction: on MNT4753 on
an example of its own at ``--gm17-4``, 2^16, a SAP domain of 2^17; on
MNT6753 on the key generation's example, a SAP domain of 2^16) and the
``pghr13`` phase (on MNT4753 on an example of its own at ``--pghr13-4``,
2^16; on MNT6753 on the key generation's), then the ``adsnark`` phase (ADSNARK on an example of
its own with authenticated inputs: ``--adsnark4`` d + 1 = 2^16 with 16,
``--adsnark6`` 2^15 with 8; labels, authentication keys and signatures from
the seed): the generator and the prover with their launch counts, phase
times and peak memory; every query family, the single points and the
verification key against exact host multiplication of the scalars
replayed from the seed (the SAP or QAP at t by this script's own Lagrange
basis); the proof against the host's scalars with no MSM; the witness map
with the prover's zero-knowledge draws by its identity at t; the verdicts
(ADSNARK: both verifiers, and its MACs, Lambdas and ``auth_verify_*``);
and every kernel compared and timed at the prove's lane counts, and at the
generator's where no earlier check of the curve compared them.  On MNT4753
the ``bacs`` phase proves a circuit of ``--bacs-gates`` gates drawn from the
seed and holds its keys and proof to PGHR13's on the circuit's R1CS, and
the kernels are compared at its generator's and prover's new lane counts;
then the ``ram`` phase: the RAM ppzkSNARK on a TinyRAM program (w = k = 16,
only the circuit's opcodes, loads and stores over a public tape of 16
words) drawn from the seed, with T steps such that its R1CS fills a QAP
domain of ``--ram4`` (2^16): the simulation accepting, the filled circuit
satisfied, the proof against PGHR13's host scalars on its R1CS, the
witness map's identity, the tape accepted and a changed tape word
rejected, and the kernels at its shapes.  Last, on each curve, the
``tbcs`` phase: the TBCS ppzkSNARK (the USCS ppzkSNARK on the circuit's
USCS -> SSP lowering) on a circuit drawn from the seed with every gate
type and all outputs false, sized so its USCS fills a radix-2 domain
(``--tbcs4``: 31744 gates, 1024 inputs of which 32 primary and 1024
outputs, 2^16 constraints and 32768 variables on MNT4753; ``--tbcs6``:
16128 gates, 256 inputs, 8 primary, 256 outputs, 2^15 constraints on
MNT6753): the generator and the prover with their launch counts, phase
times and peak memory; the four query families and the verification key
against exact host multiplication (the SSP at t by this script's own
Lagrange basis); the proof against the host's scalars with no MSM; the
witness map with the prover's d by its identity at t; the verdicts (a
flipped primary bit); and the kernels at the prove's lane counts and at
the generator's new ones.

After both curves, the ``pcd`` chain (``--pcd``) and seven later phases.
``mp_pcd`` (``--mp-pcd``): ``MPPCDProver`` at arity 0 on MNT4753 over two
counter predicates (mult 1 and 2): its keygen, a prove under each key, the
commitment against knapsack digests recomputed here, each key and proof
against exact integers, ``verify`` accepting both and rejecting a wrong
message and the other key; then the recursive step on MNT6753 as the JAX
package's tests drive it: ``MPPCDStepCircuit`` at arity 1 over two MNT4753
keys made on the card (213295 constraints, a mixed-radix QAP of 409600), its
four fill verdicts, ``groth16_full.proving_key`` and ``prover`` on the card,
the key and the proof against exact integers, the verdicts.
``ram_zksnark`` (``--ram-zksnark`` tape words): the RAM zkSNARK on MNT4753
for a program drawn from the seed (w = k = 16, 32 words of memory), one PCD
proof a machine step up to acceptance (a QAP of 2^14 a step): the states
chained and equal to the simulator's, every step's proof verified on the
pool, the key and the first and last proofs against exact integers, the
final state accepted and two tampered forms rejected.  ``fixnum``
(``--fixnum`` n): ``cli_fixnum.main`` on a stream of two chunks of n, its
output byte for byte the Python integers' Montgomery products.
``pedersen`` (``--pedersen`` messages): ``hash_batch_device`` over the
2048-point coefficient strip, every digest against the host hash, and a
Schnorr signature.  ``caml`` (``--caml4`` 2^15, ``--caml6`` 2^10: num_constraints +
num_inputs + 1, 2 inputs): the field-input chain built through the
camlsnark_* C ABI (``io.caml_ffi``, its library built from ``native/`` with
g++), extracted and its digest held to the extracted terms and to the port's
own example; ``groth16_full`` key and prove on the card, the verdicts, the
proof against the host's scalars; the key, verification key and proof in
libsnark's bytes (``io.caml_serialization``) equal to what the native
``*_of_string`` / ``*_to_string`` give back, read back onto the card, and the
key read back proving to the same bytes; on MNT4753 that prove under
``op_counts.counting()``, its report against its launches (each group's add
its K2 lanes, its dbl its K3 lanes times k, the other products K1's lanes),
and a G1 and a G2 addition and doubling at 4099 lanes reporting the same
through the kernel and its plain version.  ``polynomial`` (``--polynomial``
2^19): ``ops.polynomial.multiplication`` of two polynomials over MNT4753's Fr,
a domain of 2^20, checked at two points by host Horner.  ``functions``
(``--functions`` 16384 lanes): ``modexp`` and ``modinv`` on MNT4753's Fr,
``quorem``, ``divexact`` and ``chinese`` over (r, q), every lane against
Python integers.  After each, the kernels at its lane counts.

Each phase prints one JSON line.  Any failure raises, so the exit code is
non-zero and no result line is printed.  The last line on success is
``{"ok": true, "device": {...}}``; the line before the card's name and
power limit holds one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import multiprocessing
import os
import random
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from collections import namedtuple
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import replace
from itertools import chain
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from snark_challenge_prover_tpu_torch import cli, cli_fixnum, pedersen  # noqa: E402
from snark_challenge_prover_tpu_torch.cli_generate_parameters import generate_for_curve  # noqa: E402
from snark_challenge_prover_tpu_torch.host.curves import host_curve  # noqa: E402
from snark_challenge_prover_tpu_torch.io import caml_ffi  # noqa: E402
from snark_challenge_prover_tpu_torch.io import caml_serialization as cser  # noqa: E402
from snark_challenge_prover_tpu_torch.io import keys as key_io  # noqa: E402
from snark_challenge_prover_tpu_torch.io import serialization as ser  # noqa: E402
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753  # noqa: E402
from snark_challenge_prover_tpu_torch.ops import _build, cuda_field, cuda_group  # noqa: E402
from snark_challenge_prover_tpu_torch.ops import functions, polynomial  # noqa: E402
from snark_challenge_prover_tpu_torch.ops.msm import default_window_bits  # noqa: E402
from snark_challenge_prover_tpu_torch.ops.fft import (  # noqa: E402
    get_domain_of_min_size, get_evaluation_domain)
from snark_challenge_prover_tpu_torch.ops.field import canonical_words  # noqa: E402
from snark_challenge_prover_tpu_torch.gadgets.knapsack import knapsack_coefficients  # noqa: E402
from snark_challenge_prover_tpu_torch.gadgets.protoboard import collector_paused  # noqa: E402
from snark_challenge_prover_tpu_torch.gadgets.verifier_gadget import vk_field_elements  # noqa: E402
from snark_challenge_prover_tpu_torch.proof_systems import (  # noqa: E402
    adsnark, bacs_ppzksnark, bg, gm17, groth16_full, mp_pcd, pcd, pghr13, ram_ppzksnark,
    ram_zksnark, tbcs_ppzksnark)
from snark_challenge_prover_tpu_torch.proof_systems.ate_pairing import AtePairing, HostGT  # noqa: E402
from snark_challenge_prover_tpu_torch.proof_systems.groth16 import (  # noqa: E402
    ChallengeProver, _g1_proj_to_host, _g2_proj_to_host, compute_h)
from snark_challenge_prover_tpu_torch.proof_systems.knowledge_commitment import (  # noqa: E402
    KCVector, kc_multi_exp_fused)
from snark_challenge_prover_tpu_torch.reductions import bacs_to_r1cs, r1cs_to_sap  # noqa: E402
from snark_challenge_prover_tpu_torch.reductions import uscs_to_ssp as ssp  # noqa: E402
from snark_challenge_prover_tpu_torch.reductions import r1cs_to_qap as qap  # noqa: E402
from snark_challenge_prover_tpu_torch.reductions.ram_to_r1cs import ram_to_r1cs  # noqa: E402
from snark_challenge_prover_tpu_torch.relations.bacs import BACSCircuit, BACSGate  # noqa: E402
from snark_challenge_prover_tpu_torch.relations.examples import (  # noqa: E402
    R1CSExample, generate_r1cs_example_with_field_input)
from snark_challenge_prover_tpu_torch.relations.r1cs import (  # noqa: E402
    LinearCombination, R1CSConstraint, R1CSConstraintSystem)
from snark_challenge_prover_tpu_torch.relations.tbcs import TBCSCircuit, TBCSGate  # noqa: E402
from snark_challenge_prover_tpu_torch.relations.tinyram import (  # noqa: E402
    Instruction, TinyRAMArchParams, TinyRAMProgram, simulate)
from snark_challenge_prover_tpu_torch.utils import op_counts  # noqa: E402
from snark_challenge_prover_tpu_torch.utils.profiling import Profiler  # noqa: E402
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words, words_to_ints  # noqa: E402

TESTDATA = REPO / "snark_challenge_prover_tpu_torch" / "testdata"
PKG = "snark_challenge_prover_tpu_torch"

# The card's published limits used for the bounds (NVIDIA H100 SXM data
# sheet and the arithmetic-throughput table of NVIDIA's CUDA documentation
# for compute capability 9.0): 3.35 TB/s of device memory; 64 32-bit integer
# multiply-adds per SM per clock * 132 SMs * 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 64 * 132 * 1.98e9
# A Montgomery product (CIOS, 24 words) takes 24 * 24 wide partial products
# for a*b and as many for m*p; a 32x32 -> 64-bit partial product is two 32-bit
# multiply-adds on this card (mad.lo and mad.hi, or one IMAD.WIDE issued at
# half rate).  The 24 m's (m = t0 * n0 mod 2^32) need only the low word, one
# multiply each, so a product is 2 * 2 * 24^2 + 24.
MADS_PER_MONT_MUL = 2 * 2 * 24 * 24 + 24

# kernel name -> (source, TPU kernel replaced, Montgomery products per
# element, 96-byte values read + written per element).  Both group laws
# count the products the function needs with the curves' own constants: a is
# a small integer on every curve, so its multiplications are additions.  An
# addition takes 12 extension products and two monomials c u^s for 3b (1, 2
# or 3 base products); a doubling 11 extension products (its a ZZ is
# additions), k times for a launch of k doublings.
KERNELS = {
    "mont_mul": (f"{PKG}/csrc/mont_mul.cu",
                 "snark_challenge_prover_tpu/ops/pallas_field.py:141", 1, 3),
    "ec_add_fp": (f"{PKG}/csrc/ec_add.cu",
                  "snark_challenge_prover_tpu/ops/pallas_group.py:529", 14, 9),
    "ec_add_fp2": (f"{PKG}/csrc/ec_add.cu",
                   "snark_challenge_prover_tpu/ops/pallas_group.py:529", 40, 18),
    "ec_dbl_fp": (f"{PKG}/csrc/ec_dbl.cu",
                  "snark_challenge_prover_tpu/ops/pallas_group.py:529", 11, 6),
    "ec_dbl_fp2": (f"{PKG}/csrc/ec_dbl.cu",
                   "snark_challenge_prover_tpu/ops/pallas_group.py:529", 33, 12),
    "ec_add_fp3": (f"{PKG}/csrc/ec_add.cu",
                   "snark_challenge_prover_tpu/ops/pallas_group.py:529", 78, 27),
    "ec_dbl_fp3": (f"{PKG}/csrc/ec_dbl.cu",
                   "snark_challenge_prover_tpu/ops/pallas_group.py:529", 66, 18),
}
MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}


def path_kernels(model):
    """The kernels one curve's prove goes through."""
    g2 = model.G2.kernel_field
    return ["mont_mul", "ec_add_fp", f"ec_add_{g2}", "ec_dbl_fp", f"ec_dbl_{g2}"]


START = time.perf_counter()  # when the script started, for each line's "at_seconds"


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "at_seconds": time.perf_counter() - START}), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of one call, by CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_run(model, hc, what: str, fn, kernels=None):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, and the peak memory reset: (its result, seconds, launches, lanes,
    peak bytes).  Raises if a kernel of the path (``kernels``, by default
    every kernel of the curve's prove) was never launched."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_field.launches.clear()
    cuda_field.launch_lanes.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_field.launches)
    lanes = {k: dict(v) for k, v in cuda_field.launch_lanes.items()}
    missing = [k for k in kernels or path_kernels(model) if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {hc.name} {what} path: {missing}")
    return out, secs, launches, lanes, torch.cuda.max_memory_allocated()


def top_lanes(lanes: dict) -> dict:
    """Per kernel, the four lane counts that carried most of its work:
    [lanes, launches], for the doublings [[lanes, doublings], launches]."""
    return {k: sorted(v.items(), key=lambda kv: -math.prod(as_tuple(kv[0])) * kv[1])[:4]
            for k, v in lanes.items()}


# --------------------------------------------------------------------------
# data made from the seed
# --------------------------------------------------------------------------
STRIP_BASE, STRIP_STEP = 7, 11  # strip point j is (7 + 11 j) times the generator


def strips(hc):
    """256 distinct G1 points 7G + 11iG and 128 G2 points, on the host."""
    def strip(group, gen, count):
        P, step, out = group.mul(STRIP_BASE, gen), group.mul(STRIP_STEP, gen), []
        for _ in range(count):
            out.append(P)
            P = group.add(P, step)
        return out
    return strip(hc.g1, hc.g1_gen, 256), strip(hc.g2, hc.g2_gen, 128)


def mont_bytes(spec, v: int) -> bytes:
    return spec.to_mont(v).to_bytes(96, "little")


def field_tensor(F, values, device) -> torch.Tensor:
    """Canonical ints -> Montgomery (24, n) tensor."""
    return torch.from_numpy(ints_to_words([F.spec.to_mont(v) for v in values])).to(device)


def point_tensors(model, curve, pts, n: int, shift: int):
    """The strip tiled to n points (starting at ``shift``) as a projective triple."""
    Fq = model.Fq
    idx = (torch.arange(n) + shift) % len(pts)
    if curve.deg == 1:
        x = field_tensor(Fq, [P[0] for P in pts], model.device)
        y = field_tensor(Fq, [P[1] for P in pts], model.device)
    else:
        x = torch.stack([field_tensor(Fq, [P[0][k] for P in pts], model.device)
                         for k in range(curve.deg)])
        y = torch.stack([field_tensor(Fq, [P[1][k] for P in pts], model.device)
                         for k in range(curve.deg)])
    idx = idx.to(model.device)
    return curve.from_affine(x.index_select(-1, idx), y.index_select(-1, idx))


def random_field(F, n: int, rng) -> torch.Tensor:
    vals = [0, 1, F.p - 1] + [rng.randrange(F.p) for _ in range(61)]
    t = torch.from_numpy(ints_to_words(vals)).to(F.device)
    return t[:, torch.arange(n, device=F.device) % 64]


# --------------------------------------------------------------------------
# phase: sass
# --------------------------------------------------------------------------
def sass_counts(lib: Path) -> dict:
    """What ``cuobjdump -sass`` of a shared library shows of each kernel:
    the instructions of its body, and of each function it calls (a
    __noinline__ device function is compiled into the caller's section, from
    its CALL target to its RET), by opcode, with the integer multiply class
    (IMAD*) counted apart."""
    nvcc = Path(_build._nvcc())
    tool = shutil.which("cuobjdump") or str(nvcc.with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    sections, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            sections[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            addr, rest = line.strip()[2:].split("*/", 1)
            body = rest.split(";")[0].split()
            if body and body[0].startswith("@"):
                body = body[1:]
            if body:
                sections[name].append((int(addr, 16), body[0], body[1:2]))

    def summary(instrs):
        ops = {}
        for _, op, _ in instrs:
            ops[op] = ops.get(op, 0) + 1
        return {"instructions": len(instrs),
                "imad_class": sum(v for k, v in ops.items() if k.startswith("IMAD")),
                "imad_wide": sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE")),
                "calls": ops.get("CALL.REL.NOINC", 0),
                "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10])}

    out = {}
    for fname, instrs in sections.items():
        targets = sorted({int(arg[0], 16) for _, op, arg in instrs if op.startswith("CALL") and arg})
        callees, body_end = [], len(instrs)
        for t in targets:
            start = next(i for i, ins in enumerate(instrs) if ins[0] == t)
            end = next(i for i in range(start, len(instrs)) if instrs[i][1].startswith("RET"))
            callees.append({"address": hex(t), **summary(instrs[start:end + 1])})
            body_end = min(body_end, start)
        out[fname] = {"body": summary(instrs[:body_end]), "callees": callees}
    return {"library": lib.name, "kernels": out}


# --------------------------------------------------------------------------
# phase: kernels
# --------------------------------------------------------------------------
def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernels(model, g1_strip, g2_strip, rng, errs, ks):
    """Every kernel of the model's path against its plain version at
    N = 4099 (ragged, with the edge lanes), the doublings for each k in
    ``ks``.  Updates ``errs``, {kernel: largest absolute difference}."""
    n = 4099
    rows = []

    def compare(name, kern, plain, **extra):
        got, want = as_tuple(kern()), as_tuple(plain())
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        rows.append({"name": name, "n": n, "equal": equal, "kernel_ms": time_ms(kern, 20),
                     "plain_ms": time_ms(plain, 1), **extra})
        errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
        if not equal:
            raise AssertionError(f"kernel {name} disagrees with its plain version ({extra})")
        return got

    for F in (model.Fr, model.Fq):
        a, b = random_field(F, n, rng), random_field(F, n, rng).roll(7, dims=1)
        compare("mont_mul", lambda: cuda_field.mont_mul(F, a, b),
                lambda: cuda_field.mont_mul_plain(F, a, b), field=F.name)
        c = b[:, 5].contiguous()
        compare("mont_mul", lambda: F.mul_const(a, c),
                lambda: cuda_field.mont_mul_plain(F, a, c[:, None]),
                field=F.name, constant_operand=True)

    for curve, strip in ((model.G1, g1_strip), (model.G2, g2_strip)):
        P = point_tensors(model, curve, strip, n, 0)
        zero_x = curve.zero((n,))[0]
        Q = point_tensors(model, curve, strip, n, 5)
        P, Q = tuple(t.clone() for t in P), tuple(t.clone() for t in Q)
        ident, negP = curve.zero((n,)), curve.neg(P)
        top = torch.from_numpy(ints_to_words([model.Fq.p - 1] * curve.deg)).to(model.device)
        top = top[:, 0] if curve.deg == 1 else top.T.contiguous()  # p - 1 in every component
        for k in range(3):  # lanes 0..3: identity P, identity Q, P = Q, Q = -P
            P[k][..., 0] = ident[k][..., 0]
            Q[k][..., 1] = ident[k][..., 1]
            Q[k][..., 2] = P[k][..., 2]
            Q[k][..., 3] = negP[k][..., 3]
            # extreme lanes, where a wrong lazy bound would show: 4 every
            # coordinate p - 1 (the largest Karatsuba sums); 5 both Z = p - 1;
            # 6 P all p - 1 against a point; 7 X, Y = p - 1 against a point
            P[k][..., 4] = top
            Q[k][..., 4] = top
            P[k][..., 6] = top
        for T in (P, Q):
            T[2][..., 5] = top
            T[0][..., 7] = top
            T[1][..., 7] = top
        sfx = curve.kernel_field
        got = compare(f"ec_add_{sfx}", lambda: cuda_group.ec_add(curve, P, Q),
                      lambda: cuda_group.ec_add_plain(curve, P, Q), curve=curve.name)
        if not bool(curve.is_zero(got)[3]):
            raise AssertionError(f"{curve.name}: P + (-P) is not the identity")
        # the doubling's own edge lanes: 8 (0, y, 0) with y != 1 (kept like the
        # identity); 9 Y = 0 (to (0, -w^3, 0), which later doublings keep)
        D = tuple(t.clone() for t in P)
        D[0][..., 8], D[2][..., 8] = zero_x[..., 8], zero_x[..., 8]
        D[1][..., 9] = zero_x[..., 9]
        for k in ks:
            got = compare(f"ec_dbl_{sfx}", lambda: cuda_group.ec_dbl(curve, D, k),
                          lambda: cuda_group.ec_dbl_plain(curve, D, k), curve=curve.name, k=k)
            if not all(torch.equal(g[..., i], p[..., i]) for g, p in zip(got, D) for i in (0, 8)):
                raise AssertionError(f"{curve.name}: doubling moved the identity")
            if not bool(curve.is_zero(got)[9]):
                raise AssertionError(f"{curve.name}: doubling a point with Y = 0 kept X or Z")
    emit("kernels", curve=model.name, compared=rows)


PLAIN_CHUNK = 1 << 19  # lanes per call of a plain version (bounds its working memory)
BULK_DBL_LANES = 1 << 18  # a large doubling shape for the record: the path's own are tiny


def bound(name: str, lanes: int, k: int = 1):
    """(least milliseconds the card could take, what sets it): bytes moved
    over the memory rate against multiply-adds over the integer rate; a
    doubling launch of k doublings does k doublings' products on the
    bytes of one."""
    _, _, mont_muls, values = KERNELS[name]
    by_bytes = lanes * values * 96 / PEAK_BYTES_PER_S * 1e3
    by_ops = k * lanes * mont_muls * MADS_PER_MONT_MUL / PEAK_IMAD_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else "operations"


def run_plain(plain, args, got):
    """The plain version in chunks of PLAIN_CHUNK lanes on the kernel's
    inputs: (milliseconds, the sum over the chunks; largest absolute
    difference from the kernel's outputs ``got``)."""
    plain_ms, err = 0.0, 0
    plain(*(t[..., :1] for t in args))  # warm the plain version's first call
    lanes = args[0].shape[-1]
    for i in range(0, lanes, PLAIN_CHUNK):
        part = tuple(t[..., i : i + PLAIN_CHUNK] for t in args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = as_tuple(plain(*part))
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(tuple(g[..., i : i + PLAIN_CHUNK] for g in got), want))
        del want, part
    return plain_ms, err


def compare_at(model, g1_strip, g2_strip, rng, name: str, shape, launches: int, errs, done):
    """Kernel ``name`` against its plain version on the same inputs, and
    timed, at ``shape`` (lanes; (lanes, k) for a doubling), which a path
    launched ``launches`` times: the row.  Raises if they differ.  ``done``
    keeps each (name, shape)'s row: a shape compared before on this curve
    gives that row again, marked "reused", with this path's launches."""
    if (name, shape) in done:
        return {**done[name, shape], "path_launches": launches, "reused": True}
    lanes, k = shape if name.startswith("ec_dbl") else (shape, 1)
    if name == "mont_mul":
        F = model.Fr
        args = (random_field(F, lanes, rng), random_field(F, lanes, rng).roll(3, dims=1))
        kern = lambda *a: cuda_field.mont_mul(F, *a)
        plain = lambda *a: cuda_field.mont_mul_plain(F, *a)
    else:
        curve, strip = (model.G1, g1_strip) if name.endswith("_fp") else (model.G2, g2_strip)
        args = point_tensors(model, curve, strip, lanes, 0)
        if name.startswith("ec_dbl"):
            kern = lambda *a: cuda_group.ec_dbl(curve, a, k)
            plain = lambda *a: cuda_group.ec_dbl_plain(curve, a, k)
        else:
            args = (*args, *point_tensors(model, curve, strip, lanes, 9))
            kern = lambda *a: cuda_group.ec_add(curve, a[:3], a[3:])
            plain = lambda *a: cuda_group.ec_add_plain(curve, a[:3], a[3:])
    got = as_tuple(kern(*args))
    ms = time_ms(lambda: kern(*args), 20 if lanes >= 4096 else 200)
    plain_ms, err = run_plain(plain, args, got)
    del got, args
    torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"kernel {name} disagrees with its plain version at {lanes} lanes"
                             + (f", k = {k}" if name.startswith("ec_dbl") else ""))
    errs[name] = max(errs[name], err)
    bound_ms, bound_by = bound(name, lanes, k)
    done[name, shape] = {
        "name": name, "lanes": lanes, **({"k": k} if name.startswith("ec_dbl") else {}),
        "path_launches": launches, "equal": True, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / ms}
    return dict(done[name, shape])


def check_dbl_at_path_shapes(model, g1_strip, g2_strip, name, shapes, errs, done):
    """A doubling kernel against its plain version, and timed, at every
    (lanes, k) of ``shapes`` ({(lanes, k): launches a prove}, the curve's
    proves' own, the largest prove's first) and at (BULK_DBL_LANES, 1).
    Returns the rows: a path row gives the µs a doubling (a launch's time
    over k, the latency of the point's chain), the bulk row the ns a point
    doubling (over lanes and k)."""
    rows = []
    for (lanes, k), per_prove in [*shapes.items(), ((BULK_DBL_LANES, 1), 0)]:
        row = compare_at(model, g1_strip, g2_strip, None, name, (lanes, k), per_prove, errs, done)
        if per_prove:
            row["us_per_doubling"] = row["ms"] * 1e3 / k
        else:
            row["ns_per_point_doubling"] = row["ms"] * 1e6 / (lanes * k)
        rows.append(row)
    return rows


def check_kernels_at_path_shapes(model, g1_strip, g2_strip, rng, path_lanes, errs, done,
                                 phase: str = "kernels_at_path_shapes"):
    """Every kernel of the model's path against its plain version, and
    timed, at the lane counts the main path launched it with
    (``path_lanes``: kernel -> {lanes: launches}, read from the wrappers
    after the curve's largest prove): the largest and the most frequent;
    the doublings at every (lanes, k) their wrappers recorded in the
    curve's proves, and one large shape beside (check_dbl_at_path_shapes).
    The plain version runs in chunks of PLAIN_CHUNK lanes on the same
    inputs; its time is the sum over the chunks.  ``done`` holds the rows
    of the shapes compared on the curve (``compare_at``)."""
    report, rows = {}, []
    for name in (k for k in path_kernels(model) if k in path_lanes):
        curve = model.G1 if name.endswith("_fp") else model.G2
        if name.startswith("ec_dbl"):
            dbl_rows = check_dbl_at_path_shapes(model, g1_strip, g2_strip, name, path_lanes[name],
                                                errs, done)
            rows += dbl_rows
            keys = ("lanes", "k", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")
            report[name] = {**{k: dbl_rows[0][k] for k in (*keys, "us_per_doubling")},
                            "instantiation": cuda_group.dbl_kernel(curve).launcher,
                            "other_path_shapes": [
                                {k: r[k] for k in ("path_launches", *keys, "us_per_doubling")}
                                for r in dbl_rows[1:-1]],
                            "bulk": {k: dbl_rows[-1][k] for k in (*keys, "ns_per_point_doubling")}}
            continue
        seen = path_lanes[name]
        largest = max(seen)
        for lanes in sorted(largest_and_commonest(name, seen), reverse=True):
            row = compare_at(model, g1_strip, g2_strip, rng, name, lanes, seen.get(lanes, 0),
                             errs, done)
            row["ns_per_lane"] = row["ms"] * 1e6 / lanes
            rows.append(row)
            if lanes == largest:
                report[name] = {k: row[k] for k in ("lanes", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "ns_per_lane", "share_of_bound")}
                if name.startswith("ec_add"):
                    report[name]["instantiation"] = cuda_group.add_kernel(curve).launcher
            else:
                report[name]["commonest"] = {k: row[k] for k in (
                    "lanes", "path_launches", "ms", "plain_ms", "bound_ms", "bound_by")}
    emit(phase, curve=model.name, compared=rows)
    return report


def check_kernels_at_new_shapes(model, g1_strip, g2_strip, rng, lanes, errs, done, phase: str):
    """Every kernel of the model's path against its plain version, and
    timed, at the largest and the commonest shapes of ``lanes`` (a path's
    kernel -> {shape: launches}) that no earlier check of the curve compared
    (``done``)."""
    rows = []
    for name in (k for k in path_kernels(model) if k in lanes):
        seen = lanes[name]
        for shape in sorted(largest_and_commonest(name, seen)):
            if (name, shape) not in done:
                rows.append(compare_at(model, g1_strip, g2_strip, rng, name, shape, seen[shape],
                                       errs, done))
    emit(phase, curve=model.name, compared=rows)


# --------------------------------------------------------------------------
# phase: towers (GT = Fq4 / Fq6, the Frobenius maps, G2 mul_by_q)
# --------------------------------------------------------------------------
def towers_expected(args) -> list:
    """Exact host values for a piece of lanes of the towers check: for each
    (a, b), a b, a^2, a^-1 (0 for 0), a^(q^k) for k < 2e, the norm-1
    element u = a^(q^e) / a (1 for 0) and u^-1."""
    name, pairs = args
    gt = HostGT(host_curve(name).g2.F)
    e = gt.base.deg
    out = []
    for a, b in pairs:
        zero = a == (gt.base.zero, gt.base.zero)
        inv = a if zero else gt.inv(a)
        u = gt.one if zero else gt.mul(gt.frobenius_map(a, e), inv)
        out.append((gt.mul(a, b), gt.sqr(a), inv,
                    [gt.frobenius_map(a, k) for k in range(2 * e)], u, gt.inv(u)))
    return out


def gt_tensor(model, vals) -> torch.Tensor:
    """GT elements (pairs of Fq^e tuples) -> (2, e, 24, n) Montgomery words."""
    Fq, e = model.Fq, model.GT.base.deg
    return torch.stack([torch.stack([field_tensor(Fq, [v[k][c] for v in vals], model.device)
                                     for c in range(e)]) for k in range(2)])


def ext_values(model, t: torch.Tensor) -> list:
    """(e, 24, n) Montgomery words -> Fq^e tuples, on the host."""
    spec = model.Fq.spec
    comps = [[spec.from_mont(v) for v in words_to_ints(c)] for c in t.cpu().numpy()]
    return [tuple(c[j] for c in comps) for j in range(t.shape[-1])]


def gt_values(model, t: torch.Tensor) -> list:
    """(2, e, 24, n) Montgomery words -> GT elements, on the host."""
    return list(zip(ext_values(model, t[0]), ext_values(model, t[1])))


def check_towers(model, hc, g2_strip, n: int, rng, pool) -> dict:
    """The GT tower of the curve (Fq4 on MNT4753, Fq6 on MNT6753) on the
    card at n lanes (0: the zero element, 1: one, 2: every component p - 1,
    3: (p - 1, 0, ...), then random): mul, sqr, inv, frobenius_map for every
    power below the degree, unitary_inverse on norm-1 elements, against
    exact host values (``HostGT``, on ``pool``); and ``g2_mul_by_q`` on the
    G2 strip tiled to n lanes with a random projective scale on each,
    against q P by the same additive walk from q times the strip's first
    point.  Each operation is timed (CUDA events) and its launches counted.
    Returns the kernels' numbers for the summary line."""
    GT, Fq, E = model.GT, model.Fq, model.G2.F
    e, q = E.deg, Fq.p
    t0 = time.perf_counter()
    top = (q - 1,) * e
    edge = [((0,) * e, (0,) * e), ((1,) + (0,) * (e - 1), (0,) * e), (top, top),
            ((q - 1,) + (0,) * (e - 1), (0,) * e)]
    rand = lambda: tuple(tuple(rng.randrange(q) for _ in range(e)) for _ in range(2))
    a = (edge + [rand() for _ in range(n)])[:n]
    b = [rand() for _ in range(n)]
    want = list(chain.from_iterable(pool.map(towers_expected, [
        (hc.name, part) for part in pieces(list(zip(a, b)))])))
    # mul_by_q: strip point j of lane i is P_(i mod 128); q P_j by the walk
    # (7 + 11 j) q G; every lane scaled by a random lambda != 0 of Fq^e
    F = hc.g2.F
    qG = hc.g2.mul(q % hc.fr_spec.p, hc.g2_gen)
    Q, step, qstrip = hc.g2.mul(STRIP_BASE, qG), hc.g2.mul(STRIP_STEP, qG), []
    for _ in range(len(g2_strip)):
        qstrip.append(Q)
        Q = hc.g2.add(Q, step)
    lam = [tuple(rng.randrange(1, q) for _ in range(e)) for _ in range(n)]
    pts = [g2_strip[i % len(g2_strip)] for i in range(n)]
    ext = lambda vals: torch.stack([field_tensor(Fq, [v[c] for v in vals], model.device)
                                    for c in range(e)])
    P = (ext([F.mul(l, pt[0]) for l, pt in zip(lam, pts)]),
         ext([F.mul(l, pt[1]) for l, pt in zip(lam, pts)]), ext(lam))
    A, B = gt_tensor(model, a), gt_tensor(model, b)
    U = gt_tensor(model, [w[4] for w in want])
    t_host = time.perf_counter() - t0

    ops = {"mul": lambda: GT.mul(A, B), "sqr": lambda: GT.sqr(A), "inv": lambda: GT.inv(A),
           **{f"frobenius_map_{k}": (lambda k=k: GT.frobenius_map(A, k)) for k in range(2 * e)},
           "unitary_inverse": lambda: GT.unitary_inverse(U), "g2_mul_by_q": lambda: model.g2_mul_by_q(P)}
    rows, total = {}, 0
    for name, fn in ops.items():
        torch.cuda.synchronize()
        cuda_field.launches.clear()
        got = fn()
        torch.cuda.synchronize()
        launches = cuda_field.launches.get("mont_mul", 0)
        total += launches
        if name == "g2_mul_by_q":
            X, Y, Z = (ext_values(model, t) for t in got)
            for i, (x, y, z) in enumerate(zip(X, Y, Z)):  # (X : Y : Z) = (qx : qy : 1)
                qx, qy = qstrip[i % len(qstrip)]
                if x != F.mul(qx, z) or y != F.mul(qy, z):
                    raise AssertionError(f"{hc.name}: g2_mul_by_q differs from q P at lane {i}")
        else:
            k = {"mul": 0, "sqr": 1, "inv": 2, "unitary_inverse": 5}.get(name)
            exp = ([w[k] for w in want] if k is not None
                   else [w[3][int(name.rsplit("_", 1)[1])] for w in want])
            if gt_values(model, got) != exp:
                raise AssertionError(f"{hc.name}: the card's GT {name} differs from the host's")
        del got
        rows[name] = {"launches": launches, "ms": time_ms(fn, 3 if name == "inv" else 20)}
    emit("towers", curve=hc.name, field=GT.name, lanes=n, exact=True, ops=rows,
         launches={"mont_mul": total}, seconds={"host_values": t_host,
                                                 "total": time.perf_counter() - t0})
    return {"mont_mul": {"lanes": n, "launches": total,
                         "ms": {k: r["ms"] for k, r in rows.items()}}}


# --------------------------------------------------------------------------
# phase: prove_small
# --------------------------------------------------------------------------
def prove_small(curve: str, workdir: Path):
    out = workdir / f"{curve}-small.output"
    rc = cli.main([curve, "compute", str(TESTDATA / f"{curve}-3.params"),
                   str(TESTDATA / f"{curve}-3.input"), str(out)])
    if rc != 0:
        raise RuntimeError(f"cli returned {rc}")
    got = hashlib.sha256(out.read_bytes()).hexdigest()
    want = hashlib.sha256((TESTDATA / f"{curve}-3.output").read_bytes()).hexdigest()
    if got != want:
        raise AssertionError(f"{curve} fixture proof differs: {got} != {want}")
    emit("prove_small", curve=curve, bytes=out.stat().st_size, sha256=got, equal=True)


# --------------------------------------------------------------------------
# phase: prove_full
# --------------------------------------------------------------------------
SHIFTS = {"A": 0, "B1": 1, "L": 2, "H": 3}  # where each G1 query starts in the strip


def write_files(workdir: Path, hc, g1_strip, g2_strip, n: int, seed: int, pool):
    """Parameters and input in the wire format for d + 1 = m = n.  Returns
    the Montgomery integers of the input, which the host checks need."""
    d, m = n - 1, n
    fq, fr = hc.fq_spec, hc.fr_spec
    g1_bytes = np.frombuffer(
        b"".join(mont_bytes(fq, P[0]) + mont_bytes(fq, P[1]) for P in g1_strip), np.uint8
    ).reshape(len(g1_strip), 192)
    g2_bytes = np.frombuffer(
        b"".join(b"".join(mont_bytes(fq, c) for c in P[0] + P[1]) for P in g2_strip), np.uint8
    ).reshape(len(g2_strip), -1)  # 2 * degree * 96 bytes a point
    params_path = workdir / f"{hc.name}-{n}.params"
    input_path = workdir / f"{hc.name}-{n}.input"
    with open(params_path, "wb") as f:
        f.write(struct.pack("<QQ", d, m))
        for key, count in (("A", m + 1), ("B1", m + 1)):
            f.write(g1_bytes[(np.arange(count) + SHIFTS[key]) % 256].tobytes())
        f.write(g2_bytes[np.arange(m + 1) % 128].tobytes())
        for key, count in (("L", m - 1), ("H", d)):
            f.write(g1_bytes[(np.arange(count) + SHIFTS[key]) % 256].tobytes())

    rng = np.random.default_rng(seed)

    def rand_mont(count):
        """Montgomery-form bytes of 752 random bits each (< r)."""
        raw = rng.integers(0, 256, size=(count, 96), dtype=np.uint8)
        raw[:, 94:] = 0
        return raw

    def to_ints(raw):
        buf = raw.tobytes()
        return [int.from_bytes(buf[i : i + 96], "little") for i in range(0, len(buf), 96)]

    w_raw = rand_mont(m + 1)
    w_raw[0] = np.frombuffer(mont_bytes(fr, 1), np.uint8)
    ca_raw, cb_raw, r_raw = rand_mont(n), rand_mont(n), rand_mont(1)
    ca, cb = to_ints(ca_raw), to_ints(cb_raw)
    rinv = pow(fr.R, -1, fr.p)
    cc = list(chain.from_iterable(pool.map(mont_products, [  # Montgomery form of ca * cb
        (a, b, rinv, fr.p) for a, b in zip(pieces(ca), pieces(cb))])))
    with open(input_path, "wb") as f:
        f.write(w_raw.tobytes())
        f.write(ca_raw.tobytes())
        f.write(cb_raw.tobytes())
        f.write(b"".join(v.to_bytes(96, "little") for v in cc))
        f.write(r_raw.tobytes())
    mont = {"w": to_ints(w_raw), "ca": ca, "cb": cb, "cc": cc, "r": to_ints(r_raw)[0]}
    return params_path, input_path, mont


def batch_inverse(values, p: int) -> list:
    """[v^-1 mod p] by Montgomery's trick: one inversion, 3 (n - 1) products."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % p
    inv = pow(acc, -1, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % p
        inv = inv * values[i] % p
    return out


def domain_runs(fr, kind: str, n: int):
    """The points of a domain of the radix-2 family, from the field's roots
    alone, as geometric runs (base, ratio, count) in the domain's order:
    Z(x) = prod over the runs of (x^count - base^count).  None for a
    sequence domain."""
    p = fr.p
    if kind in ("Radix2Domain", "MixedRadixDomain"):
        return [(1, fr.get_root_of_unity(n), n)]
    if kind == "ExtendedRadix2Domain":
        w, shift = fr.get_root_of_unity(n // 2), fr.multiplicative_generator ** 2 % p
        return [(1, w, n // 2), (shift, w, n // 2)]
    if kind == "StepRadix2Domain":
        big = 1 << (n.bit_length() - 1)
        w = fr.get_root_of_unity(2 * big)
        return [(1, w * w % p, big), (w, fr.get_root_of_unity(n - big), n - big)]
    return None


def vanishing_at(fr, kind: str, n: int, tau: int) -> int:
    """Z(tau) = prod over the domain's runs of (tau^count - base^count)."""
    p, z = fr.p, 1
    for b, _, k in domain_runs(fr, kind, n):
        z = z * (pow(tau, k, p) - pow(b, k, p)) % p
    return z


BASIS_CHUNK = 1 << 16  # points of a run a host process takes at a time


def run_basis(args) -> list:
    """Points start .. start + count - 1 of a geometric run (base, ratio):
    [x_i scale[i % period] / (tau - x_i)], one batch inversion."""
    p, base, ratio, tau, scale, start, count = args
    xs, diffs, x = [], [], base * pow(ratio, start, p) % p
    for _ in range(count):
        xs.append(x)
        diffs.append(tau - x)
        x = x * ratio % p
    period = len(scale)
    return [x * v % p * scale[(start + i) % period] % p
            for i, (x, v) in enumerate(zip(xs, batch_inverse(diffs, p)))]


def sequence_denominators(args) -> list:
    """(tau - x_i) prod_{j != i} (x_i - x_j) for i in start .. start + count - 1."""
    p, tau, xs, start, count = args
    out = []
    for i in range(start, start + count):
        x, d = xs[i], tau - xs[i]
        for j, y in enumerate(xs):
            if j != i:
                d = d * (x - y) % p
        out.append(d)
    return out


def lagrange_at(fr, kind: str, n: int, tau: int, pool):
    """(Z(tau), [L_i(tau)]) for the domain's points x_i: L_i(tau) =
    Z(tau) / (Z'(x_i) (tau - x_i)).  On a run, Z'(x) = (count base^count / x)
    prod over the other runs (x^count' - base'^count'), and that product is
    periodic in i; the geometric sequence domain (x_i = 2^i) takes O(n^2).
    The points go out in chunks to ``pool``, the host processes that
    ``main`` spawns."""
    p = fr.p
    runs = domain_runs(fr, kind, n)
    if runs is None:
        if kind != "GeometricSequenceDomain":
            raise ValueError(f"no host points for a {kind}")
        xs = [pow(2, i, p) for i in range(n)]
        z = 1
        for x in xs:
            z = z * (tau - x) % p
        step = -(-n // 64)
        dens = chain.from_iterable(pool.map(sequence_denominators, [
            (p, tau, xs, s, min(step, n - s)) for s in range(0, n, step)]))
        return z, [z * v % p for v in batch_inverse(list(dens), p)]
    z = vanishing_at(fr, kind, n, tau)
    out = []
    for r, (b, ratio, k) in enumerate(runs):
        others = [(k2, pow(b2, k2, p)) for j, (b2, _, k2) in enumerate(runs) if j != r]
        period = 1  # the order of ratio^count' (a power of two) for each other run
        for k2, _ in others:
            t, order = pow(ratio, k2, p), 1
            while t != 1:
                t, order = t * t % p, order * 2
            period = max(period, order)
        K = []
        for i in range(period):
            x, v = b * pow(ratio, i, p) % p, k * pow(b, k, p) % p
            for k2, c2 in others:
                v = v * (pow(x, k2, p) - c2) % p
            K.append(v)
        scale = [z * v % p for v in batch_inverse(K, p)]
        out.extend(chain.from_iterable(pool.map(run_basis, [
            (p, b, ratio, tau, scale, s, min(BASIS_CHUNK, k - s))
            for s in range(0, k, BASIS_CHUNK)])))
    return z, out


HOST_PIECES = 16  # tasks a host computation over many values is cut into for the pool


def pieces(seq) -> list:
    """``seq`` cut into at most HOST_PIECES consecutive slices, all but the
    last of one length."""
    step = max(1, -(-len(seq) // HOST_PIECES))
    return [seq[s : s + step] for s in range(0, len(seq), step)]


def comb_muls(args) -> list:
    comb, scalars = args
    return [comb.mul(s) for s in scalars]


def pool_muls(pool, comb, scalars) -> list:
    """[comb.mul(s) for s in scalars] (``comb`` a HostComb), in pieces over
    ``pool``."""
    return list(chain.from_iterable(pool.map(comb_muls, [(comb, part)
                                                         for part in pieces(scalars)])))


def horner_piece(args) -> int:
    coeffs, x, p = args
    return horner(coeffs, x, p)


def pool_horner(pool, coeffs, x: int, p: int) -> int:
    """horner(coeffs, x, p) with the coefficients in pieces over ``pool``:
    the pieces' values P_k(x), highest first, joined by Horner's rule in
    x^(piece length)."""
    parts = pieces(coeffs)
    vals = list(pool.map(horner_piece, [(part, x, p) for part in parts]))
    step, acc = pow(x, len(parts[0]), p), 0
    for v in reversed(vals):
        acc = (acc * step + v) % p
    return acc


def dot_piece(args) -> int:
    xs, ys, p = args
    return sum(x * y for x, y in zip(xs, ys)) % p


def pool_dot(pool, xs, ys, p: int) -> int:
    """sum_i xs[i] ys[i] mod p (two lists of one length), in pieces over
    ``pool``."""
    if len(xs) != len(ys):
        raise ValueError(f"pool_dot of {len(xs)} and {len(ys)} values")
    return sum(pool.map(dot_piece, [(a, b, p) for a, b in zip(pieces(xs), pieces(ys))])) % p


def mont_products(args) -> list:
    a, b, rinv, p = args
    return [x * y * rinv % p for x, y in zip(a, b)]


def check_h(fr, kind: str, n: int, mont, h, rng, pool):
    """H(tau) Z(tau) == A(tau) B(tau) - C(tau) at a random tau, with A, B, C
    evaluated from their values on the domain's points (computed here from
    the field's roots, independently of the device's domain) by the
    Lagrange basis at tau, and Z the domain's vanishing polynomial."""
    p = fr.p
    tau = rng.randrange(2, p)
    z, L = lagrange_at(fr, kind, n, tau, pool)
    rinv = pow(fr.R, -1, p)  # values are in Montgomery form

    def evaluate(vals):
        return sum(v * wt for v, wt in zip(vals, L)) % p * rinv % p

    a, b, c = evaluate(mont["ca"]), evaluate(mont["cb"]), evaluate(mont["cc"])
    if pool_horner(pool, h, tau, p) * z % p != (a * b - c) % p:
        raise AssertionError(f"compute_h ({kind}): H(tau) Z(tau) != A(tau) B(tau) - C(tau)")


def expected_proof(hc, g1_strip, g2_strip, mont, h, n: int) -> bytes:
    """The proof bytes by exact integers: every MSM collapses to its strip."""
    fr, fq = hc.fr_spec, hc.fq_spec
    p = fr.p
    rinv = pow(fr.R, -1, p)
    d, m = n - 1, n
    w = mont["w"]

    def collapse(group, strip, gen, scalars, shift, scale):
        period = len(strip)
        # strip point j, (7 + 11 j) times the generator, collects the indices
        # i with (i + shift) % period == j: the MSM is one multiple of the generator
        k = sum(sum(scalars[(j - shift) % period :: period]) * (STRIP_BASE + STRIP_STEP * j)
                for j in range(period))
        return group.mul(k * scale % p, gen)

    At = collapse(hc.g1, g1_strip, hc.g1_gen, w[: m + 1], SHIFTS["A"], rinv)
    Bt1 = collapse(hc.g1, g1_strip, hc.g1_gen, w[: m + 1], SHIFTS["B1"], rinv)
    Bt2 = collapse(hc.g2, g2_strip, hc.g2_gen, w[: m + 1], 0, rinv)
    Lt = collapse(hc.g1, g1_strip, hc.g1_gen, w[2 : m + 1], SHIFTS["L"], rinv)
    Ht = collapse(hc.g1, g1_strip, hc.g1_gen, h[:d], SHIFTS["H"], 1)
    C = hc.g1.add(hc.g1.add(Ht, Lt), hc.g1.mul(mont["r"] * rinv % p, Bt1))

    def g1(P):
        return b"\x00" * 192 if P is None else mont_bytes(fq, P[0]) + mont_bytes(fq, P[1])

    def g2(P):
        if P is None:
            return b"\x00" * (2 * len(hc.g2_gen[0]) * 96)
        return b"".join(mont_bytes(fq, c) for c in P[0] + P[1])

    return g1(At) + g2(Bt2) + g1(C)


def check_load(model, params_path: Path, input_path: Path, n: int):
    """Both readers on the files just written (warm in the page cache): the
    numpy reader on the host, then the device reader (pinned chunks, the
    copy to the card and the unpacking there, to a synchronize); every
    word array of the device reader must equal the numpy reader's."""
    deg = model.g2_deg
    t0 = time.perf_counter()
    P_np = ser.read_params(params_path, deg)
    t1 = time.perf_counter()
    I_np = ser.read_input(input_path, P_np.d, P_np.m)
    t2 = time.perf_counter()
    reader = ser.DeviceReader(model.device)  # its pinned buffers, outside the times
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    P_dev = reader.read_params(params_path, deg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    I_dev = reader.read_input(input_path, P_dev.d, P_dev.m)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    pairs = [((P_dev.d, P_dev.m), (P_np.d, P_np.m))]
    for k in ("A", "B1", "B2", "L", "H"):
        pairs += list(zip(getattr(P_dev, k), getattr(P_np, k)))
    pairs += [(getattr(I_dev, k), getattr(I_np, k)) for k in ("w", "ca", "cb", "cc", "r")]
    arrays = 0
    for got, want in pairs:
        if isinstance(want, tuple):
            same = got == want
        else:
            arrays += 1
            same = (got.device == model.device and got.dtype == torch.int32
                    and torch.equal(got, torch.from_numpy(want).to(model.device)))
        if not same:
            raise AssertionError(f"{model.name} d + 1 = {n}: the device reader's words differ "
                                 "from the numpy reader's")
    sizes = {"params": params_path.stat().st_size, "input": input_path.stat().st_size}
    del P_np, I_np, P_dev, I_dev, reader
    torch.cuda.empty_cache()
    emit("load", curve=model.name, d=n - 1, m=n, bytes=sizes, arrays_equal=arrays, equal=True,
         numpy_seconds={"params": t1 - t0, "input": t2 - t1},
         device_seconds={"params": t4 - t3, "input": t5 - t4},
         device_gb_per_s=(sizes["params"] + sizes["input"]) / (t5 - t3) / 1e9)


def prove_full(model, hc, g1_strip, g2_strip, workdir: Path, n: int, seed: int, pool):
    """One prove at d + 1 = m = n through ``prove_files``, checked against
    the host's exact-integer proof.  Returns this run's launch counts and
    lane counts, read from the wrappers."""
    t0 = time.perf_counter()
    params_path, input_path, mont = write_files(workdir, hc, g1_strip, g2_strip, n, seed, pool)
    t_files = time.perf_counter() - t0
    check_load(model, params_path, input_path, n)

    # compute_h on its own, checked by a polynomial identity on the host
    t0 = time.perf_counter()
    Fr = model.Fr
    up = lambda vals: torch.from_numpy(ints_to_words(vals)).to(model.device)
    domain = get_evaluation_domain(Fr, n)
    domain_name = type(domain).__name__
    h_dev = Fr.to_canonical(compute_h(model, domain, up(mont["ca"]), up(mont["cb"]), up(mont["cc"])))
    h = words_to_ints(h_dev.cpu().numpy())
    del h_dev, domain
    if h[n - 1] != 0:
        raise AssertionError("compute_h: the top coefficient of H is not zero")
    check_h(hc.fr_spec, domain_name, n, mont, h, random.Random(seed), pool)
    t_hcheck = time.perf_counter() - t0

    t0 = time.perf_counter()
    want = expected_proof(hc, g1_strip, g2_strip, mont, h, n)
    t_expected = time.perf_counter() - t0
    del mont, h

    # the main path, with the launch counts set to 0 just before and read just after
    out_path = workdir / f"{hc.name}-{n}.output"
    prover = ChallengeProver(model, verbose=False)
    got, t_prove, launches, path_lanes, peak = path_run(
        model, hc, "challenge",
        lambda: prover.prove_files(str(params_path), str(input_path), str(out_path)))

    got_sha = hashlib.sha256(out_path.read_bytes()).hexdigest()
    want_sha = hashlib.sha256(want).hexdigest()
    proof_bytes = (4 + 2 * model.g2_deg) * 96  # two G1 points and one G2 point, affine
    if got != out_path.read_bytes() or len(got) != proof_bytes or got_sha != want_sha:
        raise AssertionError(
            f"{hc.name} proof at d + 1 = {n} differs from the host's: {got_sha} != {want_sha}")
    for p in (params_path, input_path, out_path):
        p.unlink()
    emit("prove_full", curve=hc.name, d=n - 1, m=n, domain=domain_name, bytes=len(got),
         sha256=got_sha, equal=True,
         seconds={"total": t_prove, **{k: v for k, v in prover.profiler.cumulative.items()}},
         host_seconds={"write_files": t_files, "compute_h_and_check": t_hcheck,
                       "expected_proof": t_expected},
         peak_device_bytes=peak, launches=launches, lanes=top_lanes(path_lanes))
    return launches, path_lanes


# --------------------------------------------------------------------------
# phase: keygen
# --------------------------------------------------------------------------
class HostComb:
    """s P for many scalars s and one base P, by exact integers: the table
    d 2^(4j) P (d < 16, j < 189) once, affine, then per scalar one mixed
    addition a nonzero 4-bit digit in Jacobian coordinates (X / Z^2,
    Y / Z^3), one inverse at the end."""

    def __init__(self, group, P, bits: int = 753):
        self.group, self.F = group, group.F
        self.rows = []
        for _ in range((bits + 3) // 4):
            row = [None, P]
            for _ in range(14):
                row.append(group.add(row[-1], P))
            self.rows.append(row)
            P = group.add(row[8], row[8])  # 16 P
    def _affine(self, J):
        if J is None:
            return None
        F = self.F
        zi = F.inv(J[2])
        zi2 = F.mul(zi, zi)
        return (F.mul(J[0], zi2), F.mul(J[1], F.mul(zi2, zi)))

    def _madd(self, J, Q):
        """Jacobian J plus affine Q (madd-2007-bl); where J and Q share x
        (a doubling or the identity) the affine law takes over."""
        F = self.F
        if J is None:
            return (Q[0], Q[1], F.one)
        X1, Y1, Z1 = J
        z1z1 = F.mul(Z1, Z1)
        h = F.sub(F.mul(Q[0], z1z1), X1)
        rr = F.sub(F.mul(Q[1], F.mul(Z1, z1z1)), Y1)
        if F.is_zero(h):
            P = self.group.add(self._affine(J), Q)
            return None if P is None else (P[0], P[1], F.one)
        hh = F.mul(h, h)
        hhh = F.mul(h, hh)
        v = F.mul(X1, hh)
        X3 = F.sub(F.sub(F.mul(rr, rr), hhh), F.add(v, v))
        Y3 = F.sub(F.mul(rr, F.sub(v, X3)), F.mul(Y1, hhh))
        return (X3, Y3, F.mul(Z1, h))

    def mul(self, s: int):
        J, j = None, 0
        while s:
            if s & 15:
                J = self._madd(J, self.rows[j][s & 15])
            s >>= 4
            j += 1
        return self._affine(J)


_COMBS = {}  # (field modulus, degree, base point) -> its HostComb, built once a run


def host_comb(group, P) -> HostComb:
    """The HostComb of ``group`` and base P, built on first use and kept."""
    key = (group.F.p, group.F.deg, P)
    if key not in _COMBS:
        _COMBS[key] = HostComb(group, P)
    return _COMBS[key]


def host_keys(model, hc, ex, seed: int, pool):
    """The generator's secrets and scalars, replayed from the seed on the
    host for its example ``ex`` (the keygen's own: the generator drew it
    first, with two draws, and applied the A/B swap): t, alpha, beta, delta
    and g1_scalar, in the generator's order of draws.  The QAP at t is
    evaluated here from the constraints and this script's own Lagrange
    basis (``qap_at``), not by the port's instance map; "at_t" holds the
    witness's sums at t (``qap_at_t``)."""
    rng = random.Random(seed)
    r = model.Fr.p
    rng.randrange(r), rng.randrange(r)  # the example's two draws
    cs = ex.constraint_system
    t, alpha, beta, delta = (rng.randrange(1, r) for _ in range(4))
    zt, At, Bt, Ct = qap_at(model, hc, cs, t, pool)
    n = get_domain_of_min_size(model.Fr, cs.num_constraints + cs.primary_input_size + 1).n
    powers = [1] * (n - 1)  # t^i for the H query, i < d
    for i in range(1, n - 1):
        powers[i] = powers[i - 1] * t % r
    keys = {"w": [1] + ex.primary_input + ex.auxiliary_input, "nin": cs.primary_input_size,
            "t": t, "At": At, "Bt": Bt, "Ct": Ct, "Zt": zt, "Ht": powers,
            "alpha": alpha, "beta": beta, "delta": delta, "g1_scalar": rng.randrange(1, r)}
    keys["at_t"] = qap_at_t(model, keys, pool)
    return keys


def qap_at(model, hc, cs, t: int, pool):
    """(Z(t), [A_i(t)], [B_i(t)], [C_i(t)]) for i <= m, by exact integers
    from this script's own Lagrange basis over the QAP domain's points:
    X_i(t) = sum over the rows j where variable i appears of L_j(t) X_{j,i},
    and A_i(t) gains L_{n_c + i}(t) for i <= num_inputs (libsnark
    r1cs_to_qap.tcc:105-177)."""
    r = model.Fr.p
    nc, nin, m = cs.num_constraints, cs.primary_input_size, cs.num_variables
    domain = get_domain_of_min_size(model.Fr, nc + nin + 1)
    zt, L = lagrange_at(hc.fr_spec, type(domain).__name__, domain.n, t, pool)
    At, Bt, Ct = [0] * (m + 1), [0] * (m + 1), [0] * (m + 1)
    for i in range(nin + 1):
        At[i] = L[nc + i]
    for u, cons in zip(L, cs.constraints):
        for X, lc in ((At, cons.a), (Bt, cons.b), (Ct, cons.c)):
            for idx, coeff in lc.terms:
                X[idx] += u * coeff
    return zt, [v % r for v in At], [v % r for v in Bt], [v % r for v in Ct]


def read_point(raw: np.ndarray, off: int, deg: int, spec):
    """One affine point of the params file at byte ``off`` (None for zeros)."""
    vals = [spec.from_mont(int.from_bytes(raw[off + 96 * i : off + 96 * (i + 1)].tobytes(),
                                          "little")) for i in range(2 * deg)]
    if not any(vals):
        return None
    return (vals[0], vals[1]) if deg == 1 else (tuple(vals[:deg]), tuple(vals[deg:]))


def check_queries(model, hc, params_path: Path, keys: dict, n: int, seed: int, pool):
    """A, B1, B2, L and H of the generated params file against exact
    multiplication (on ``pool``): the first and last entries, 256 random
    ones and every identity, and the identities' positions against the zero
    scalars."""
    r, deg = model.Fr.p, model.g2_deg
    d, m = n - 1, n
    dinv = pow(keys["delta"], -1, r)
    abc = [(keys["beta"] * a + keys["alpha"] * b + c) % r
           for a, b, c in zip(keys["At"], keys["Bt"], keys["Ct"])]
    zdt = keys["Zt"] * dinv % r
    g1s = keys["g1_scalar"]
    queries = [("A", keys["At"], 1), ("B1", keys["Bt"], 1), ("B2", keys["Bt"], deg),
               ("L", [v * dinv % r for v in abc[2:]], 1), ("H", [zdt * h % r for h in keys["Ht"]], 1)]
    combs = {1: host_comb(hc.g1, hc.g1_gen), deg: host_comb(hc.g2, hc.g2_gen)}
    raw = np.memmap(params_path, dtype=np.uint8, mode="r")
    if struct.unpack("<QQ", raw[:16].tobytes()) != (d, m):
        raise AssertionError(f"{hc.name} keygen: params header is not (d, m) = ({d}, {m})")
    off, rng, checked = 16, random.Random(seed), {}
    for key, scalars, k in queries:
        size = 2 * k * 96
        block = raw[off : off + len(scalars) * size].reshape(len(scalars), size)
        zero_rows = np.flatnonzero(~block.any(axis=1)).tolist()
        zero_scalars = [i for i, s in enumerate(scalars) if s == 0]
        if zero_rows != zero_scalars:
            raise AssertionError(f"{hc.name} keygen {key}: identities at {zero_rows[:8]}, "
                                 f"zero scalars at {zero_scalars[:8]}")
        picks = sorted({0, len(scalars) - 1, *zero_scalars,
                        *rng.sample(range(len(scalars)), min(256, len(scalars)))})
        # G1 queries: s times g1_scalar G
        want = pool_muls(pool, combs[k], [scalars[i] if k > 1 else scalars[i] * g1s % r
                                          for i in picks])
        for i, P in zip(picks, want):
            if read_point(raw, off + i * size, k, hc.fq_spec) != P:
                raise AssertionError(f"{hc.name} keygen {key}[{i}] differs from exact multiplication")
        checked[key] = {"entries": len(picks), "identities": len(zero_scalars)}
        off += len(scalars) * size
    if off != raw.size:
        raise AssertionError(f"{hc.name} keygen: params file of {raw.size} bytes, {off} expected")
    return checked


def expected_keygen_proof(model, hc, keys: dict, input_path: Path) -> bytes:
    """The proof of the generated files by exact integers, with no MSM:
    A = A(t) g1b, B = B(t) G2 and C = ((A(t) B(t) - C(t)) / delta + sum_{i>=2}
    w_i L_i + r B(t)) g1b, with g1b = g1_scalar G1, X(t) = sum_i w_i X_i(t)
    and sum_{i>=2} w_i L_i from ``keys["at_t"]`` (the example has one input,
    so its sum over i > 1 is this), and h(t) Z(t) = A(t) B(t) - C(t)
    standing for the H query's sum."""
    rr, at_t = model.Fr.p, keys["at_t"]
    dinv = pow(keys["delta"], -1, rr)
    At, Bt, Ct = at_t["A"], at_t["B"], at_t["C"]
    with open(input_path, "rb") as f:
        f.seek(-96, os.SEEK_END)
        r_blind = model.Fr.spec.from_mont(int.from_bytes(f.read(), "little"))
    c_scalar = ((At * Bt - Ct + at_t["L"]) * dinv + r_blind * Bt) % rr
    g1s = keys["g1_scalar"]
    return wire_bytes(model, hc, hc.g1.mul(At * g1s % rr, hc.g1_gen), hc.g2.mul(Bt, hc.g2_gen),
                      hc.g1.mul(c_scalar * g1s % rr, hc.g1_gen))


def wire_bytes(model, hc, A, B, C) -> bytes:
    """A proof's bytes in the wire format, from host affine points."""
    fq = hc.fq_spec

    def g1(P):
        return b"\x00" * 192 if P is None else mont_bytes(fq, P[0]) + mont_bytes(fq, P[1])

    B_bytes = (b"\x00" * (192 * model.g2_deg) if B is None
               else b"".join(mont_bytes(fq, c) for c in B[0] + B[1]))
    return g1(A) + B_bytes + g1(C)


def keygen(model, hc, workdir: Path, n: int, seed: int, pool):
    """The key generation path at d + 1 = n (m = n): ``generate_for_curve``
    on the card, with the launch counts set to 0 just before and read just
    after; the queries against exact multiplication; the generated files
    proved through ``prove_files`` and the proof against exact-integer
    bytes.  Returns the keygen's launch and lane counts, what
    ``generate_for_curve`` made (the proving key, its secrets, the example)
    and the host's replay of the secrets and the QAP at t, which the
    groth16 phase reuses."""
    prof = Profiler(model.device, verbose=False)
    gen, t_gen, launches, path_lanes, peak = path_run(
        model, hc, "keygen",
        lambda: generate_for_curve(model, n.bit_length() - 1, random.Random(seed), workdir, prof))
    params_path, input_path = gen.params_path, gen.input_path
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    keys = host_keys(model, hc, gen.example, seed, pool)
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = check_queries(model, hc, params_path, keys, n, seed, pool)
    t_checks = time.perf_counter() - t0

    t0 = time.perf_counter()
    want = expected_keygen_proof(model, hc, keys, input_path)
    t_expected = time.perf_counter() - t0
    out_path = workdir / f"{hc.name}-keygen.output"
    prover = ChallengeProver(model, verbose=False)
    t0 = time.perf_counter()
    got = prover.prove_files(str(params_path), str(input_path), str(out_path))
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    got_sha, want_sha = hashlib.sha256(got).hexdigest(), hashlib.sha256(want).hexdigest()
    if got != want:
        raise AssertionError(f"{hc.name} proof of the generated files at d + 1 = {n} differs "
                             f"from the host's: {got_sha} != {want_sha}")
    sizes = {"params": params_path.stat().st_size, "input": input_path.stat().st_size}
    for p in (params_path, input_path, out_path):
        p.unlink()
    dbl = {k: v for k, v in path_lanes.items() if k.startswith("ec_dbl")}
    emit("keygen", curve=hc.name, d=n - 1, m=n, bytes=sizes, queries_checked=checked,
         proof_sha256=got_sha, proof_equal=True,
         seconds={"generate": t_gen, **dict(prof.cumulative)},
         host_seconds={"replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         prove_seconds=t_prove, peak_device_bytes=peak, launches=launches,
         lanes=top_lanes(path_lanes), largest_doubling={k: max(v, key=lambda s: (s[0], s[1])) for k, v in dbl.items()})
    return launches, path_lanes, gen, keys


# --------------------------------------------------------------------------
# phase: groth16
# --------------------------------------------------------------------------
def qap_at_t(model, keys: dict, pool) -> dict:
    """The witness's QAP polynomials at the key's t by exact integers (the
    sums on ``pool``): X(t) = sum_i w_i X_i(t) for X = A, B, C, and
    sum_{i > nin} w_i ABC_i(t) = beta sum w_i A_i(t) + alpha sum w_i B_i(t) +
    sum w_i C_i(t) over i > nin."""
    rr, w, nin = model.Fr.p, keys["w"], keys["nin"]
    out = {k: pool_dot(pool, w, keys[k + "t"], rr) for k in "ABC"}
    tail = {k: (out[k] - sum(a * b for a, b in zip(w[: nin + 1], keys[k + "t"]))) % rr
            for k in "ABC"}
    out["L"] = (keys["beta"] * tail["A"] + keys["alpha"] * tail["B"] + tail["C"]) % rr
    return out


def blinded_scalars(model, keys: dict, at_t: dict, r: int, s: int, d: int = 1):
    """The scalars of a blinded proof by exact integers, with no MSM: A =
    a g1b, B = b G2 (b g1b in G1), C = c g1b, for delta' = d delta (d = 1:
    Groth16, else BG) and blinding r, s: a = alpha + A(t) + r delta',
    b = beta + B(t) + s delta', c = d^-1 (A(t) B(t) - C(t) + sum_{i > nin}
    w_i ABC_i) / delta + s a + r b - r s delta' (``at_t``: ``qap_at_t``), where
    h(t) Z(t) = A(t) B(t) - C(t) stands for the H query's sum.  Returns
    (a, b, c)."""
    rr = model.Fr.p
    dl = keys["delta"] * d % rr
    htlt = (at_t["A"] * at_t["B"] - at_t["C"] + at_t["L"]) * pow(keys["delta"], -1, rr) % rr
    a = (keys["alpha"] + at_t["A"] + r * dl) % rr
    b = (keys["beta"] + at_t["B"] + s * dl) % rr
    return a, b, (htlt * pow(d, -1, rr) + s * a + r * b - r * s * dl) % rr


def check_witness_map(model, cs, ex, n: int, t: int, z: int, at_t: dict, patches, pool):
    """The QAP witness map at full size, on one set of A, B and C words:
    for each (d1, d2, d3) of ``patches``, ``witness_map_device``'s top
    coefficient is d1 d2 (Z's is 1) and (A(t) + d1 Z(t)) (B(t) + d2 Z(t)) -
    (C(t) + d3 Z(t)) = H(t) Z(t) at the key's random t, where this script's
    own Lagrange basis gave A(t), B(t), C(t) and Z(t) (``qap_at``).  Returns
    seconds."""
    Fr, p = model.Fr, model.Fr.p
    aA, aB, aC = qap.assemble_abc_evaluations(cs, ex.primary_input, ex.auxiliary_input, Fr)
    words = Fr.from_canonical(canonical_words(Fr, aA + aB + aC))
    del aA, aB, aC
    ca, cb, cc = (words[:, k * n : (k + 1) * n].contiguous() for k in range(3))
    del words
    A, B, C = at_t["A"], at_t["B"], at_t["C"]
    secs = {"device": [], "identity_check": 0.0}
    for d1, d2, d3 in patches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H = qap.witness_map_device(model, ca, cb, cc, d1, d2, d3)
        torch.cuda.synchronize()
        secs["device"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        coeffs = words_to_ints(Fr.to_canonical(H).cpu().numpy())
        if coeffs[n] != d1 * d2 % p:
            raise AssertionError(f"{model.name}: witness map's top coefficient is not d1 d2")
        if pool_horner(pool, coeffs, t, p) * z % p != ((A + d1 * z) * (B + d2 * z)
                                                       - (C + d3 * z)) % p:
            raise AssertionError(f"{model.name}: witness map with d = {(d1, d2, d3) != (0, 0, 0)}"
                                 ": H(t) Z(t) != A'(t) B'(t) - C'(t)")
        secs["identity_check"] += time.perf_counter() - t0
        del H, coeffs
    return secs


def horner(coeffs, x: int, p: int) -> int:
    """The polynomial of ``coeffs`` (lowest degree first) at x."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def check_key_io(model, pk, vk, proof, workdir: Path):
    """The full-size keys and the proof written through ``io.keys``, to a
    file and back: the words and points read back equal, and writing what
    was read gives the same bytes.  Returns (seconds, sizes)."""
    secs, sizes = {}, {}
    for name, write, read, obj in (
            ("pk", key_io.write_proving_key,
             lambda b: key_io.read_proving_key(b, model.device), pk),
            ("vk", key_io.write_verification_key, key_io.read_verification_key, vk)):
        path = workdir / f"{model.name}.{name}"
        t0 = time.perf_counter()
        data = write(obj)
        path.write_bytes(data)
        t1 = time.perf_counter()
        back = read(path.read_bytes())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if name == "pk":
            for key in ("A_query", "B_query_g2", "B_query_g1", "H_query", "L_query"):
                if not all(torch.equal(a, b) for a, b in zip(getattr(pk, key), getattr(back, key))):
                    raise AssertionError(f"{model.name}: {key} read back differs")
            same = all(getattr(pk, k) == getattr(back, k) for k in (
                "curve", "alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"))
        else:
            same = back == vk
        if not same or write(back) != data:
            raise AssertionError(f"{model.name}: the {name} does not round-trip through io.keys")
        secs[name] = {"write": t1 - t0, "read": t2 - t1}
        sizes[name] = len(data)
        path.unlink()
        del data, back
    if key_io.read_proof(proof.to_bytes(model), model.name) != proof:
        raise AssertionError(f"{model.name}: the proof does not round-trip through io.keys")
    return secs, sizes


def groth16(model, hc, workdir: Path, n: int, seed: int, gen, keys: dict, pool):
    """The blinded Groth16 prover at the key generation's size, on its
    in-process proving key (``gen``) and the host's replay of its secrets
    (``keys``): ``groth16_full.prover`` with the launch counts set to 0 just
    before and read just after, its bytes against the host's MSM-free
    bytes; ``verification_key`` + ``verifier_strong_IC`` accepting it and
    rejecting a wrong input, a tampered A and a truncated input;
    ``kc_multi_exp_fused`` over (B_query_g2, B_query_g1) against the
    prover's B MSMs; then ``groth16_extras`` on the same key.  Returns the
    prover's launch and lane counts."""
    rr, ex, pk = model.Fr.p, gen.example, gen.pk
    primary, aux = ex.primary_input, ex.auxiliary_input
    g1s = keys["g1_scalar"]
    g1b = lambda k: hc.g1.mul(k * g1s % rr, hc.g1_gen)
    prof = Profiler(model.device, verbose=False)
    proof, t_prove, launches, path_lanes, peak = path_run(
        model, hc, "groth16",
        lambda: groth16_full.prover(model, pk, primary, aux, random.Random(seed), profiler=prof))

    t0 = time.perf_counter()
    at_t = keys["at_t"]
    blind = random.Random(seed)
    r, s = blind.randrange(rr), blind.randrange(rr)  # the prover's draws, in its order
    a, b, c = blinded_scalars(model, keys, at_t, r, s)
    want = wire_bytes(model, hc, g1b(a), hc.g2.mul(b, hc.g2_gen), g1b(c))
    t_expected = time.perf_counter() - t0
    got = proof.to_bytes(model)
    got_sha, want_sha = hashlib.sha256(got).hexdigest(), hashlib.sha256(want).hexdigest()
    if got != want:
        raise AssertionError(f"{hc.name} blinded proof at d + 1 = {n} differs from the host's: "
                             f"{got_sha} != {want_sha}")

    t0 = time.perf_counter()
    vk = groth16_full.verification_key(pk, gen.secrets)
    t_vk = time.perf_counter() - t0
    t_verify = check_verdicts(hc, groth16_full, vk, primary, proof, groth16_full.Proof(
        hc.g1.add(proof.g_A, hc.g1_gen), proof.g_B, proof.g_C), pool)["verify"]

    # the knowledge commitment over (B_query_g2, B_query_g1)
    Fr, G1, G2 = model.Fr, model.G1, model.G2
    kc = KCVector(g=G2.from_affine(*pk.B_query_g2), h=G1.from_affine(*pk.B_query_g1))
    w_can = canonical_words(Fr, keys["w"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, h = kc_multi_exp_fused(G2, G1, kc, w_can)
    torch.cuda.synchronize()
    t_kc = time.perf_counter() - t0
    kc_out = (_g2_proj_to_host(model, g), _g1_proj_to_host(model, h))
    del kc, w_can, g, h
    # the prover's own B MSMs, B - beta - s delta in G2 and in G1
    _, r0, s0, _, g1_B, _ = proof.extras
    from_proof = (hc.g2.add(proof.g_B, hc.g2.neg(hc.g2.add(pk.beta_g2, hc.g2.mul(s0, pk.delta_g2)))),
                  hc.g1.add(g1_B, hc.g1.neg(hc.g1.add(pk.beta_g1, hc.g1.mul(s0, pk.delta_g1)))))
    Bt = at_t["B"]
    if not kc_out == from_proof == (hc.g2.mul(Bt, hc.g2_gen), g1b(Bt)):
        raise AssertionError(f"{hc.name}: kc_multi_exp_fused differs from the prover's B MSMs")

    extras = groth16_extras(model, hc, workdir, n, seed, gen, keys, at_t, vk, proof, pool)
    emit("groth16", curve=hc.name, d=n - 1, m=n, proof_sha256=got_sha, proof_equal=True,
         verifier={"accepts": True, "rejects": ["input + 1", "tampered A", "truncated input"]},
         witness_map={"top": ["0", "d1 d2"], "identity_at_random_tau": ["plain", "patched"]},
         bg={"equal": True, "verified": True}, kc_fused_equal=True,
         key_bytes=extras.pop("key_bytes"),
         seconds={"prove": t_prove, **dict(prof.cumulative), "verification_key": t_vk,
                  "verify": t_verify, "kc_multi_exp_fused": t_kc, **extras},
         host_seconds={"expected_proof": t_expected},
         peak_device_bytes=peak, launches=launches, lanes=top_lanes(path_lanes))
    return launches, path_lanes


def groth16_extras(model, hc, workdir: Path, n: int, seed: int, gen, keys: dict, at_t: dict, vk,
                   proof, pool) -> dict:
    """On the key ``gen`` of d + 1 = n with its host replay ``keys`` and
    verification key ``vk``: the witness map (``check_witness_map``, plain
    and patched); ``bg.prover`` with a random d != 1 against the host's
    scalars and ``bg.verifier_strong_IC``; the proving and verification keys
    and ``proof`` through ``io.keys``.  Returns the seconds and the key files'
    bytes."""
    rr, ex, pk = model.Fr.p, gen.example, gen.pk
    primary, aux = ex.primary_input, ex.auxiliary_input
    g1b = lambda k: hc.g1.mul(k * keys["g1_scalar"] % rr, hc.g1_gen)
    wm_rng = random.Random(seed)
    wm_seconds = check_witness_map(model, pk.constraint_system, ex, n, keys["t"], keys["Zt"], at_t,
                                   [(0, 0, 0), tuple(wm_rng.randrange(1, rr) for _ in range(3))],
                                   pool)

    d = random.Random(seed).randrange(2, rr)
    bg_prof = Profiler(model.device, verbose=False)
    t0 = time.perf_counter()
    bg_proof = bg.prover(model, pk, d, primary, aux, random.Random(seed + 1), profiler=bg_prof)
    torch.cuda.synchronize()
    t_bg = time.perf_counter() - t0
    blind = random.Random(seed + 1)
    r, s = blind.randrange(rr), blind.randrange(rr)
    ba, bb, bc = blinded_scalars(model, keys, at_t, r, s, d)
    want_bg = (g1b(ba), hc.g2.mul(bb, hc.g2_gen), g1b(bc), hc.g2.mul(keys["delta"] * d % rr,
                                                                     hc.g2_gen))
    if (bg_proof.g_A, bg_proof.g_B, bg_proof.g_C, bg_proof.delta_prime) != want_bg:
        raise AssertionError(f"{hc.name}: the BG proof differs from the host's scalars")
    t0 = time.perf_counter()
    if not bg.verifier_strong_IC(vk, primary, bg_proof):
        raise AssertionError(f"{hc.name}: bg.verifier_strong_IC rejects the card's BG proof")
    t_bg_verify = time.perf_counter() - t0

    key_seconds, key_bytes = check_key_io(model, pk, vk, proof, workdir)
    return {"bg_prove": t_bg, "bg_verify": t_bg_verify, "bg_phases": dict(bg_prof.cumulative),
            "keys": key_seconds, "witness_map_checks": wm_seconds, "key_bytes": key_bytes}


# --------------------------------------------------------------------------
# phases: gm17, pghr13, bacs
# --------------------------------------------------------------------------
def zero_columns(pair) -> list:
    """The entries of a stored affine query whose y is 0: the identities."""
    y = pair[1]
    return torch.nonzero(~y.reshape(-1, y.shape[-1]).any(dim=0)).flatten().tolist()


def device_points(model, pair, idx) -> list:
    """Entries ``idx`` of a stored affine query on the card -> host affine
    points (None where y is 0)."""
    spec = model.Fq.spec
    sel = torch.tensor(idx, dtype=torch.long, device=pair[0].device)
    comps = []
    for t in pair:
        t = t.index_select(-1, sel).cpu().numpy()
        comps.append([[spec.from_mont(v) for v in words_to_ints(c)]
                      for c in (t[None] if t.ndim == 2 else t)])
    out = []
    for j in range(len(idx)):
        xs, ys = [c[j] for c in comps[0]], [c[j] for c in comps[1]]
        out.append(None if not any(ys) else (xs[0], ys[0]) if len(xs) == 1
                   else (tuple(xs), tuple(ys)))
    return out


class Powers:
    """t^i for i < count, computed where read (none is zero)."""

    def __init__(self, t: int, count: int, p: int):
        self.t, self.count, self.p = t, count, p

    def __len__(self):
        return self.count

    def __getitem__(self, i: int) -> int:
        return pow(self.t, i, self.p)


def check_family(model, hc, key: str, pair, values, coeff: int, comb, rng, pool) -> dict:
    """One query family on the card against exact multiplication (``comb``,
    on ``pool``) of its scalars coeff * values[i], coeff nonzero: every
    identity's position against the zero values' (none for ``Powers``),
    then the first and last entries, 256 random ones and a few identities."""
    r = model.Fr.p
    if coeff % r == 0 or pair[0].shape[-1] != len(values):
        raise AssertionError(f"{hc.name} {key}: {pair[0].shape[-1]} entries, {len(values)} expected")
    zero_rows = zero_columns(pair)
    zero_values = [] if isinstance(values, Powers) else [i for i, v in enumerate(values) if v == 0]
    if zero_rows != zero_values:
        raise AssertionError(f"{hc.name} {key}: identities at {zero_rows[:8]}, zero scalars at "
                             f"{zero_values[:8]}")
    picks = sorted({0, len(values) - 1, *zero_values[:4], *zero_values[-4:],
                    *rng.sample(range(len(values)), min(256, len(values)))})
    want = pool_muls(pool, comb, [coeff * values[i] % r for i in picks])
    for i, P, Q in zip(picks, device_points(model, pair, picks), want):
        if P != Q:
            raise AssertionError(f"{hc.name} {key}[{i}] differs from exact multiplication")
    return {"entries": len(picks), "identities": len(zero_values)}


def sap_domain(model, cs):
    """(kind, size) of the SAP's domain: the smallest one of 2 n_c - n_sq +
    2 num_inputs + 1 points (r1cs_to_sap.tcc:37-52)."""
    nonsq = sum(not c.is_square for c in cs.constraints)
    domain = get_domain_of_min_size(model.Fr, len(cs.constraints) + nonsq
                                    + 2 * cs.primary_input_size + 1)
    return type(domain).__name__, domain.n


def sap_at_t(model, hc, cs, primary, auxiliary, t: int, domain, pool) -> dict:
    """The R1CS -> SAP reduction of ``cs`` at t by exact integers, from the
    SAP's rows and this script's own Lagrange basis over the SAP domain's
    points (r1cs_to_sap.tcc:75-180): a non-square constraint a b = c gives
    the rows (a + b)^2 = 4 c + x' and (a - b)^2 = x', x' a new variable;
    a square one (a a = c) one row; then x_0^2 = x_0 and, for each input i
    with a new x''_i, (x_i + x_0)^2 = 4 x_i + x''_i and (x_i - x_0)^2 =
    x''_i, over ``domain`` (``sap_domain``'s (kind, size)).  Returns Z(t),
    A_i(t), C_i(t) for the SAP's variables, the rows' A and C on the witness
    (the domain's values) and A(t), C(t)."""
    r, fr = model.Fr.p, hc.fr_spec
    nvar, nin = cs.num_variables, cs.primary_input_size
    nonsq = sum(not c.is_square for c in cs.constraints)
    kind, n = domain
    z, L = lagrange_at(fr, kind, n, t, pool)
    m = nvar + nonsq + nin
    At, Ct, aA, aC = [0] * (m + 1), [0] * (m + 1), [0] * n, [0] * n
    w = [v % r for v in list(primary) + list(auxiliary)]
    k, extra = 0, []  # the next row; the x' values

    def row(j, a_terms, c_terms, a_val, c_val):
        for idx, coeff in a_terms:
            At[idx] += L[j] * coeff
        for idx, coeff in c_terms:
            Ct[idx] += L[j] * coeff
        aA[j], aC[j] = a_val % r, c_val % r

    for cons in cs.constraints:
        a, c = cons.a.evaluate(w, r), cons.c.evaluate(w, r)
        if cons.is_square:
            row(k, cons.a.terms, cons.c.terms, a, c)
            k += 1
            continue
        b = cons.b.evaluate(w, r)
        x = (a - b) ** 2 % r
        xv = nvar + 1 + len(extra)
        extra.append(x)
        neg_b = [(idx, -coeff) for idx, coeff in cons.b.terms]
        row(k, cons.a.terms + cons.b.terms, [(idx, 4 * co) for idx, co in cons.c.terms] + [(xv, 1)],
            a + b, 4 * c + x)
        row(k + 1, cons.a.terms + neg_b, [(xv, 1)], a - b, x)
        k += 2
    row(k, [(0, 1)], [(0, 1)], 1, 1)
    for i in range(1, nin + 1):
        xpp, xi = nvar + nonsq + i, w[i - 1]
        row(k + 2 * i - 1, [(i, 1), (0, 1)], [(i, 4), (xpp, 1)], xi + 1, 4 * xi + (xi - 1) ** 2)
        row(k + 2 * i, [(i, 1), (0, -1)], [(xpp, 1)], xi - 1, (xi - 1) ** 2)
    return {"n": n, "kind": kind, "Zt": z, "At": [v % r for v in At],
            "Ct": [v % r for v in Ct], "aA": aA, "aC": aC, "w": [1] + w,
            "A": pool_dot(pool, L, aA, r), "C": pool_dot(pool, L, aC, r)}


def check_square_witness_map(model, what: str, run, n: int, top: int, rhs: int, t: int, z: int,
                             pool) -> dict:
    """A witness map on the card: ``run()`` (timed) gives H's n + 1
    Montgomery coefficients, whose top one must be ``top`` and whose value
    at t times Z(t) must be ``rhs``, by exact integers.  Returns seconds."""
    Fr, p = model.Fr, model.Fr.p
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = run()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    coeffs = words_to_ints(Fr.to_canonical(H).cpu().numpy())
    if len(coeffs) != n + 1 or coeffs[n] != top % p:
        raise AssertionError(f"{model.name}: the {what}'s top coefficient is not {top % p}")
    if pool_horner(pool, coeffs, t, p) * z % p != rhs % p:
        raise AssertionError(f"{model.name}: {what}: H(t) Z(t) differs from its identity at t")
    return {"device": t_dev, "identity_check": time.perf_counter() - t0}


def check_sap_witness_map(model, sap: dict, t: int, d1: int, d2: int, pool) -> dict:
    """The SAP witness map on the card for this script's own A and C on the
    domain and the prover's d1, d2: H's top coefficient is d1^2 (Z's is 1)
    and (A(t) + d1 Z(t))^2 - (C(t) + d2 Z(t)) = H(t) Z(t).  Returns seconds."""
    Fr, n, z = model.Fr, sap["n"], sap["Zt"]
    words = Fr.from_canonical(canonical_words(Fr, sap["aA"] + sap["aC"]))
    ca, cc = words[:, :n].contiguous(), words[:, n:].contiguous()
    del words
    return check_square_witness_map(
        model, "SAP witness map", lambda: r1cs_to_sap.witness_map_device(model, ca, cc, d1, d2), n,
        d1 * d1, (sap["A"] + d1 * z) ** 2 - (sap["C"] + d2 * z), t, z, pool)


def verdict(args) -> bool:
    verifier, vk, inputs, proof = args
    return verifier(vk, inputs, proof)


def check_verdicts(hc, system, vk, primary, proof, tampered, pool, wrong_input=None) -> dict:
    """``verifier_strong_IC`` accepts the proof and rejects a wrong input
    (``wrong_input``, by default the first input plus 1), a tampered proof
    and a truncated input; the three rejections run on ``pool`` while this
    process times the acceptance.  Returns the acceptance's seconds and
    those of all four verdicts."""
    rr = hc.fr_spec.p
    if wrong_input is None:
        wrong_input = [(primary[0] + 1) % rr] + primary[1:]
    t0 = time.perf_counter()
    wrong = {what: pool.submit(verdict, (system.verifier_strong_IC, vk, inputs, pf))
             for what, inputs, pf in (("wrong input", wrong_input, proof),
                                      ("tampered proof", primary, tampered),
                                      ("truncated input", primary[:-1], proof))}
    t1 = time.perf_counter()
    if not system.verifier_strong_IC(vk, primary, proof):
        raise AssertionError(f"{hc.name}: {system.__name__} rejects the card's proof")
    secs = time.perf_counter() - t1
    for what, accepted in wrong.items():
        if accepted.result():
            raise AssertionError(f"{hc.name}: {system.__name__} accepts a proof with {what}")
    return {"verify": secs, "verdicts": time.perf_counter() - t0}


def proof_sha256(model, points) -> str:
    """sha256 of a proof's host points in the wire format's encoding (96
    Montgomery bytes a coordinate, the identity as zeros), in order."""
    fq, h = model.Fq.spec, hashlib.sha256()
    for P in points:
        if P is None:
            h.update(b"\x00")
        else:
            for c in P:
                for v in (c if isinstance(c, tuple) else (c,)):
                    h.update(mont_bytes(fq, v))
    return h.hexdigest()


def gm17_phase(model, hc, n: int, seed: int, ex, pool):
    """GM17 at d + 1 = n on the example ``ex`` (the key generation's on
    MNT6753, one of its own on MNT4753, ``--gm17-4``): ``gm17.generator``
    and ``gm17.prover`` (both drawing from ``--seed``), each with the launch
    counts set to 0 just before and read just after; every query family, the
    single points and the verification key against exact multiplication of
    the scalars replayed on the host (the SAP at t by ``sap_at_t``); the
    proof against the host's scalars, with no MSM (gm17.py's docstring); the
    SAP witness map with the prover's d1, d2; the verdicts.  Returns the
    prover's launch and lane counts and the generator's lane counts."""
    rr, cs = model.Fr.p, ex.constraint_system
    primary, aux = ex.primary_input, ex.auxiliary_input
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_gen, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "gm17 keygen", lambda: gm17.generator(model, cs, random.Random(seed), kg_prof))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "gm17 prove",
        lambda: gm17.prover(model, kp.pk, primary, aux, random.Random(seed), prof))

    # the generator's draws (t until Z(t) != 0), the SAP at t, the prover's draws
    t0 = time.perf_counter()
    kind, sap_n = sap_domain(model, cs)
    rng = random.Random(seed)
    t = rng.randrange(1, rr)
    while not vanishing_at(hc.fr_spec, kind, sap_n, t):
        t = rng.randrange(1, rr)
    alpha, beta, gamma, g_s, h_s = (rng.randrange(1, rr) for _ in range(5))
    draws = random.Random(seed)
    d1, d2, r = (draws.randrange(rr) for _ in range(3))
    sap = sap_at_t(model, hc, cs, primary, aux, t, (kind, sap_n), pool)
    At, Ct, Z, l = sap["At"], sap["Ct"], sap["Zt"], cs.primary_input_size
    ab, g2z = (alpha + beta) % rr, gamma * gamma * Z % rr
    vq = [(gamma * c + ab * a) % rr for a, c in zip(At, Ct)]
    G, H = hc.g1.mul(g_s, hc.g1_gen), hc.g2.mul(h_s, hc.g2_gen)
    combG, combH = host_comb(hc.g1, G), host_comb(hc.g2, hc.g2.mul(gamma, H))
    t_replay = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk, vk, chk = kp.pk, kp.vk, random.Random(seed)
    checked = {key: check_family(model, hc, key, getattr(pk, key), values, coeff, comb, chk,
                                 pool)
               for key, values, coeff, comb in (
                   ("A_query", At, gamma, combG), ("B_query", At, 1, combH),
                   ("C_query_1", vq[l + 1 :], gamma, combG), ("C_query_2", At, 2 * g2z, combG),
                   ("G_gamma2_Z_t", Powers(t, sap_n + 1, rr), g2z, combG))}
    gz = gamma * Z % rr
    singles = ((pk.G_gamma_Z, combG.mul(gz)), (pk.H_gamma_Z, hc.g2.mul(gz, H)),
               (pk.G_ab_gamma_Z, combG.mul(ab * gz % rr)), (pk.G_gamma2_Z2, combG.mul(g2z * Z % rr)),
               (vk.H, H), (vk.G_alpha, combG.mul(alpha)), (vk.H_beta, hc.g2.mul(beta, H)),
               (vk.G_gamma, combG.mul(gamma)), (vk.H_gamma, hc.g2.mul(gamma, H)),
               (vk.query, [combG.mul(v) for v in vq[: l + 1]]))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name} gm17: a single point or the verification key differs")
    t_checks = time.perf_counter() - t0

    # A = gamma (A(t) + (r + d1) Z) G, B likewise over H, C by gm17.py's docstring
    t0 = time.perf_counter()
    w = sap["w"]
    A_t, C_t = sap["A"], sap["C"]
    low_A, low_C = (sum(wi * v for wi, v in zip(w[: l + 1], X)) for X in (At, Ct))
    h_t = ((A_t + d1 * Z) ** 2 - (C_t + d2 * Z)) * pow(Z, -1, rr)
    rd1 = r + d1
    a = gamma * (A_t + rd1 * Z) % rr
    c = (gamma * (gamma * (C_t - low_C) + ab * (A_t - low_A)) + (r * r + 2 * r * d1) * g2z * Z
         + rd1 * ab * gz + 2 * r * g2z * A_t + g2z * (h_t + d2)) % rr
    if (proof.A, proof.B, proof.C) != (combG.mul(a), hc.g2.mul(a, H), combG.mul(c)):
        raise AssertionError(f"{hc.name} gm17 proof at d + 1 = {n} differs from the host's scalars")
    t_expected = time.perf_counter() - t0
    wm = check_sap_witness_map(model, sap, t, d1, d2, pool)
    m_sap = len(At) - 1
    del sap, At, Ct, vq
    verdicts = check_verdicts(hc, gm17, vk, primary, proof,
                              gm17.Proof(hc.g1.add(proof.A, hc.g1_gen), proof.B, proof.C), pool)
    emit("gm17", curve=hc.name, d=n - 1, sap_domain=[kind, sap_n], sap_variables=m_sap,
         queries_checked=checked, proof_sha256=proof_sha256(model, (proof.A, proof.B, proof.C)),
         proof_equal=True, verifier={"accepts": True, "rejects": ["input + 1", "tampered A",
                                                                  "truncated input"]},
         witness_map={"top": "d1^2", "identity_at_t": True},
         seconds={"generate": t_gen, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                  "prove_phases": dict(prof.cumulative), **verdicts, "witness_map_check": wm},
         host_seconds={"replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return launches, lanes, kg_lanes


def pghr13_host_proof(hc, combG, secrets, draws, qap_t, w, l: int, pool):
    """PGHR13's proof from the host's scalars, with no MSM (pghr13.py's
    docstring): for the generator's (alphaA, alphaB, alphaC, rA, rB, beta),
    the prover's (d1, d2, d3), the QAP at t (Z, [A_i], [B_i], [C_i]) and the
    assignment ``w`` (w[0] the constant 1, l inputs), the pairs rX (X(t) +
    d Z) (G or H, and alphaX times it in G1), A without its input rows;
    H(t) = (A' B' - C') / Z; K = beta (rA A' + rB B' + rC C'); the sums on
    ``pool``.  Returns the proof and {"A", "B", "C"}: A(t), B(t), C(t)."""
    rr = hc.fr_spec.p
    alA, alB, alC, rA, rB, beta = secrets
    rC = rA * rB % rr
    d1, d2, d3 = draws
    Z, At, Bt, Ct = qap_t
    w = [v % rr for v in w]
    A_t, B_t, C_t = (pool_dot(pool, w, X, rr) for X in (At, Bt, Ct))
    Ap, Bp, Cp = A_t + d1 * Z, B_t + d2 * Z, C_t + d3 * Z
    A0p = Ap - sum(wi * v for wi, v in zip(w[: l + 1], At))
    g = lambda k: combG.mul(k % rr)
    proof = pghr13.Proof(
        g_A=(g(rA * A0p), g(rA * alA * A0p)),
        g_B=(hc.g2.mul(rB * Bp % rr, hc.g2_gen), g(rB * alB * Bp)),
        g_C=(g(rC * Cp), g(rC * alC * Cp)), g_H=g((Ap * Bp - Cp) * pow(Z, -1, rr)),
        g_K=g(beta * (rA * Ap + rB * Bp + rC * Cp)))
    return proof, {"A": A_t, "B": B_t, "C": C_t}


def pghr13_key_checks(model, hc, pk, vk, secrets, qap_t, t: int, qap_n: int, ic_split: bool,
                      combG, combH, seed: int, pool) -> dict:
    """PGHR13's (and ADSNARK's) query families and the verification key's
    points other than the IC / Ain against exact multiplication of the
    generator's secrets (alphaA, alphaB, alphaC, rA, rB, beta, gamma) and the
    QAP at t (Z, [A_i], [B_i], [C_i]), with A's input rows zeroed under
    ``ic_split`` (pghr13.py's quirks: K skips row m + 1).  Raises on a
    difference; returns check_family's counts by query."""
    rr = model.Fr.p
    alA, alB, alC, rA, rB, beta, gamma = secrets
    rC = rA * rB % rr
    Z, At, Bt, Ct = qap_t
    l = pk.constraint_system.primary_input_size
    Az = ([0] * (l + 1) + At[l + 1 :] if ic_split else At) + [Z]
    Bz, Cz = Bt + [Z], Ct + [Z]
    # K / beta: rows 0..m, row m + 1 skipped, then the three Z rows
    K = [(rA * a + rB * b + rC * c) % rr for a, b, c in zip(At, Bt, Ct)]
    K += [rX * Z % rr for rX in (rA, rB, rC)]
    chk = random.Random(seed)
    checked = {key: check_family(model, hc, key, getattr(pk, key), values, coeff, comb, chk,
                                 pool)
               for key, values, coeff, comb in (
                   ("A_query_g", Az, rA, combG), ("A_query_h", Az, rA * alA, combG),
                   ("B_query_g", Bz, rB, combH), ("B_query_h", Bz, rB * alB, combG),
                   ("C_query_g", Cz, rC, combG), ("C_query_h", Cz, rC * alC, combG),
                   ("H_query", Powers(t, qap_n + 1, rr), 1, combG), ("K_query", K, beta, combG))}
    H2, gb = hc.g2_gen, gamma * beta % rr
    singles = ((vk.alphaA_g2, hc.g2.mul(alA, H2)), (vk.alphaB_g1, combG.mul(alB)),
               (vk.alphaC_g2, hc.g2.mul(alC, H2)), (vk.gamma_g2, hc.g2.mul(gamma, H2)),
               (vk.gamma_beta_g1, combG.mul(gb)), (vk.gamma_beta_g2, hc.g2.mul(gb, H2)),
               (vk.rC_Z_g2, hc.g2.mul(rC * Z % rr, H2)))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name}: the verification key differs")
    return checked


def pghr13_phase(model, hc, n: int, seed: int, ex, pool):
    """PGHR13 at d + 1 = n on the example ``ex`` (the key generation's on
    MNT6753, one of its own on MNT4753, ``--pghr13-4``):
    ``pghr13.generator`` and ``pghr13.prover`` (both drawing from
    ``--seed``) with the launch counts set to 0 just before and read just
    after; every query family (the K and IC quirks included) and the
    verification key against exact multiplication of the scalars replayed
    on the host (the QAP at t by ``qap_at``); the knowledge-commitment pairs,
    H and K against the host's scalars, with no MSM; the QAP witness map
    with the prover's d1, d2, d3; the verdicts.  Returns the prover's launch
    and lane counts and the generator's lane counts."""
    rr, cs = model.Fr.p, ex.constraint_system
    primary, aux = ex.primary_input, ex.auxiliary_input
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_gen, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "pghr13 keygen",
        lambda: pghr13.generator(model, cs, random.Random(seed), kg_prof))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "pghr13 prove",
        lambda: pghr13.prover(model, kp.pk, primary, aux, random.Random(seed), prof))

    t0 = time.perf_counter()
    rng = random.Random(seed)
    t = rng.randrange(1, rr)
    alA, alB, alC, rA, rB, beta, gamma = (rng.randrange(1, rr) for _ in range(7))
    draws = random.Random(seed)
    d1, d2, d3 = (draws.randrange(rr) for _ in range(3))
    Z, At, Bt, Ct = qap_at(model, hc, cs, t, pool)
    qap_n = get_domain_of_min_size(model.Fr, cs.num_constraints + len(primary) + 1).n
    m, l = cs.num_variables, len(primary)
    combG, combH = host_comb(hc.g1, hc.g1_gen), host_comb(hc.g2, hc.g2_gen)
    t_replay = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk, vk = kp.pk, kp.vk
    checked = pghr13_key_checks(model, hc, pk, vk, (alA, alB, alC, rA, rB, beta, gamma),
                                (Z, At, Bt, Ct), t, qap_n, True, combG, combH, seed, pool)
    singles = ((vk.encoded_IC_base, combG.mul(rA * At[0] % rr)),
               (vk.encoded_IC_values, [combG.mul(rA * a % rr) for a in At[1 : l + 1]]))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name} pghr13: the verification key's IC differs")
    t_checks = time.perf_counter() - t0

    t0 = time.perf_counter()
    want, at_t = pghr13_host_proof(hc, combG, (alA, alB, alC, rA, rB, beta), (d1, d2, d3),
                                   (Z, At, Bt, Ct), [1] + primary + aux, l, pool)
    if proof != want:
        raise AssertionError(f"{hc.name} pghr13 proof at d + 1 = {n} differs from the host's scalars")
    t_expected = time.perf_counter() - t0
    wm = check_witness_map(model, cs, ex, qap_n, t, Z, at_t, [(d1, d2, d3)], pool)
    del At, Bt, Ct
    tampered = pghr13.Proof(**{**vars(proof), "g_A": (hc.g1.add(proof.g_A[0], hc.g1_gen),
                                                      proof.g_A[1])})
    verdicts = check_verdicts(hc, pghr13, vk, primary, proof, tampered, pool)
    points = (*proof.g_A, *proof.g_B, *proof.g_C, proof.g_H, proof.g_K)
    emit("pghr13", curve=hc.name, d=n - 1, qap_domain=qap_n, m=m, queries_checked=checked,
         proof_sha256=proof_sha256(model, points), proof_equal=True,
         verifier={"accepts": True, "rejects": ["input + 1", "tampered A", "truncated input"]},
         witness_map={"top": "d1 d2", "identity_at_t": True},
         seconds={"generate": t_gen, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                  "prove_phases": dict(prof.cumulative), **verdicts, "witness_map_check": wm},
         host_seconds={"replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return launches, lanes, kg_lanes


# a stand-in for a model where a host-side function reads only its name: it
# pickles to the host pool, which a model on the card does not
CurveName = namedtuple("CurveName", "name")


def auth_check(args) -> bool:
    """adsnark.auth_verify_sym or _pub (``which``) on the host pool."""
    which, name, values, data, key, labels = args
    return getattr(adsnark, f"auth_verify_{which}")(CurveName(name), values, data, key, labels)


def adsnark_verdict(args):
    """adsnark.verifier_sym or _pub (``which``) on the host pool: (its
    verdict, its seconds)."""
    which, name, vk, proof, key, labels, data = args
    t0 = time.perf_counter()
    if which == "sym":
        ok = adsnark.verifier_sym(CurveName(name), vk, proof, key, labels)
    else:
        ok = adsnark.verifier_pub(CurveName(name), vk, proof, data, key, labels)
    return ok, time.perf_counter() - t0


def adsnark_phase(model, hc, n: int, num_inputs: int, seed: int, pool):
    """ADSNARK at d + 1 = n on an example of its own from the seed with
    ``num_inputs`` authenticated inputs (n - num_inputs - 1 constraints),
    labels, authentication keys and signatures drawn from the seed:
    ``adsnark.generator`` and ``adsnark.prover`` (from ``--seed`` and
    ``--seed`` + 1) with the launch counts set to 0 just before each and read
    just after; the MACs and Lambdas against lambda_i + i v_i and lambda_i H,
    ``auth_verify_sym`` / ``_pub`` accepting the values and rejecting a
    changed one; every query family, rA_i_Z_g1 and the verification key
    against exact multiplication of the scalars replayed on the host (the QAP
    at t by ``qap_at``); the proof against the host's scalars with no MSM
    (adsnark.py's docstring); the QAP witness map with the prover's shifts
    (d1 + dauth, d2, d3); the verdicts of both verifiers.  Returns the
    prover's launch and lane counts and the generator's lane counts."""
    rr = model.Fr.p
    t0 = time.perf_counter()
    ex = generate_r1cs_example_with_field_input(rr, n - num_inputs - 1, num_inputs,
                                                random.Random(seed + 2))
    cs, primary, aux = ex.constraint_system, ex.primary_input, ex.auxiliary_input
    t_example = time.perf_counter() - t0
    qap_n = qap.qap_domain_size(cs, model.Fr)
    if qap_n != n:
        raise AssertionError(f"{hc.name} adsnark: a QAP domain of {qap_n}, not {n}")
    t0 = time.perf_counter()
    arng = random.Random(seed + 3)
    labels = [arng.randbytes(16) for _ in range(num_inputs)]
    keys = adsnark.auth_generator(model, arng)
    data = adsnark.auth_sign(model, primary, keys.sak, labels, arng)
    t_auth = time.perf_counter() - t0

    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_gen, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "adsnark keygen",
        lambda: adsnark.generator(model, cs, keys.pap, random.Random(seed), kg_prof))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "adsnark prove",
        lambda: adsnark.prover(model, kp.pk, primary, aux, data, random.Random(seed + 1), prof))

    # the verdicts on the pool, while this process checks the rest
    name, vk, sak, pak = hc.name, kp.vk, keys.sak, keys.pak
    forged = [replace(data[0], sigma=(data[0].sigma[0] + 1, data[0].sigma[1]))] + data[1:]
    tampered = {"g_A": adsnark.Proof(**{**vars(proof), "g_A": (hc.g1.add(proof.g_A[0], hc.g1_gen),
                                                                proof.g_A[1])}),
                "muA": adsnark.Proof(**{**vars(proof), "muA": hc.g1.add(proof.muA, hc.g1_gen)})}
    wrong_labels = labels[1:] + labels[:1]
    tasks = {("sym", "accepts"): (vk, proof, sak, labels, None),
             ("pub", "accepts"): (vk, proof, pak, labels, data),
             ("sym", "wrong labels"): (vk, proof, sak, wrong_labels, None),
             ("pub", "wrong labels"): (vk, proof, pak, wrong_labels, data),
             ("sym", "tampered g_A"): (vk, tampered["g_A"], sak, labels, None),
             ("pub", "tampered g_A"): (vk, tampered["g_A"], pak, labels, data),
             ("sym", "tampered muA"): (vk, tampered["muA"], sak, labels, None),
             ("pub", "tampered muA"): (vk, tampered["muA"], pak, labels, data),
             ("pub", "forged label signature"): (vk, proof, pak, labels, forged)}
    t_verdicts = time.perf_counter()
    futures = {k: pool.submit(adsnark_verdict, (k[0], name, *v)) for k, v in tasks.items()}

    # the authentication layer: mu_i = lambda_i + i v_i, Lambda_i = lambda_i H,
    # both checks accepting the values (in pieces on the pool) and rejecting one changed
    t0 = time.perf_counter()
    lambdas = [adsnark._prf(sak.prf_seed, lb, rr) for lb in labels]
    combG, combH = host_comb(hc.g1, hc.g1_gen), host_comb(hc.g2, hc.g2_gen)
    if [ad.mu for ad in data] != [(lam + sak.i * v) % rr for lam, v in zip(lambdas, primary)] or \
            [ad.Lambda for ad in data] != pool_muls(pool, combH, lambdas):
        raise AssertionError(f"{hc.name} adsnark: a MAC or a Lambda differs from the host's")
    bad = [(primary[0] + 1) % rr]
    auth = [pool.submit(auth_check, (which, name, part_v, part_d, key, part_l))
            for which, key in (("sym", sak), ("pub", pak))
            for part_v, part_d, part_l in zip(pieces(primary), pieces(data), pieces(labels))]
    auth_bad = [pool.submit(auth_check, (which, name, bad, data[:1], key, labels[:1]))
                for which, key in (("sym", sak), ("pub", pak))]
    if not all(f.result() for f in auth) or any(f.result() for f in auth_bad):
        raise AssertionError(f"{hc.name} adsnark: auth_verify_sym / _pub decide wrongly")
    t_auth_checks = time.perf_counter() - t0

    # the generator's draws (t, alphaA, alphaB, alphaC, rA, rB, beta, gamma), the
    # QAP at t, the prover's (d1, d2, d3, dauth)
    t0 = time.perf_counter()
    rng = random.Random(seed)
    t = rng.randrange(1, rr)
    alA, alB, alC, rA, rB, beta, gamma = (rng.randrange(1, rr) for _ in range(7))
    rC = rA * rB % rr
    draws = random.Random(seed + 1)
    d1, d2, d3, dauth = (draws.randrange(rr) for _ in range(4))
    Z, At, Bt, Ct = qap_at(model, hc, cs, t, pool)
    m, l = cs.num_variables, num_inputs
    t_replay = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk = kp.pk
    checked = pghr13_key_checks(model, hc, pk, vk, (alA, alB, alC, rA, rB, beta, gamma),
                                (Z, At, Bt, Ct), t, qap_n, False, combG, combH, seed, pool)
    singles = ((vk.A0, combG.mul(rA * At[0] % rr)),
               (vk.Ain, [combG.mul(rA * a % rr) for a in At[1 : l + 1]]),
               (pk.rA_i_Z_g1, combG.mul(rA * Z * sak.i % rr)))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name} adsnark: rA_i_Z_g1, A0 or Ain differs")
    t_checks = time.perf_counter() - t0

    # the proof by adsnark.py's docstring: with a_in = sum_{i <= l} w_i A_i(t)
    # and a_aux = A(t) - A_0(t) - a_in, g_A = rA (a_aux + d1 Z), g_Aau = rA (a_in
    # + dauth Z) (and alphaA times each), B, C, H and K as PGHR13's with A' =
    # A(t) + (d1 + dauth) Z, muA = rA (dauth i Z + sum_i mu_i A_i(t))
    t0 = time.perf_counter()
    w = [1] + [v % rr for v in primary + aux]
    A_t, B_t, C_t = (pool_dot(pool, w, X, rr) for X in (At, Bt, Ct))
    a_in = sum(wi * v for wi, v in zip(w[1 : l + 1], At[1 : l + 1])) % rr
    a_aux, d1a = (A_t - At[0] - a_in) % rr, (d1 + dauth) % rr
    Ap, Bp, Cp = A_t + d1a * Z, B_t + d2 * Z, C_t + d3 * Z
    g = lambda k: combG.mul(k % rr)
    want = adsnark.Proof(
        g_A=(g(rA * (a_aux + d1 * Z)), g(rA * alA * (a_aux + d1 * Z))),
        g_B=(hc.g2.mul(rB * Bp % rr, hc.g2_gen), g(rB * alB * Bp)),
        g_C=(g(rC * Cp), g(rC * alC * Cp)),
        g_H=g((Ap * Bp - Cp) * pow(Z, -1, rr)), g_K=g(beta * (rA * Ap + rB * Bp + rC * Cp)),
        g_Aau=(g(rA * (a_in + dauth * Z)), g(rA * alA * (a_in + dauth * Z))),
        muA=g(rA * (dauth * sak.i * Z + sum(ad.mu * a for ad, a in zip(data, At[1 : l + 1])))))
    if proof != want:
        raise AssertionError(f"{hc.name} adsnark proof at d + 1 = {n} differs from the host's "
                             "scalars")
    t_expected = time.perf_counter() - t0
    wm = check_witness_map(model, cs, ex, qap_n, t, Z, {"A": A_t, "B": B_t, "C": C_t},
                           [(d1a, d2, d3)], pool)
    del At, Bt, Ct

    verdicts = {k: f.result() for k, f in futures.items()}
    t_verdicts = time.perf_counter() - t_verdicts
    for (which, case), (ok, _) in verdicts.items():
        if ok != (case == "accepts"):
            raise AssertionError(f"{hc.name}: adsnark verifier_{which} {'rejects' if case == 'accepts' else 'accepts'} "
                                 f"the card's proof{'' if case == 'accepts' else ' with ' + case}")
    points = (*proof.g_A, *proof.g_B, *proof.g_C, proof.g_H, proof.g_K, *proof.g_Aau, proof.muA)
    emit("adsnark", curve=hc.name, d=n - 1, inputs=num_inputs, qap_domain=qap_n, m=m,
         constraints=cs.num_constraints, queries_checked=checked,
         proof_sha256=proof_sha256(model, points), proof_equal=True,
         auth={"mac_and_lambda": True, "sym_pub_accept": True, "reject_changed_value": True},
         verifier={"accepts": ["sym", "pub"],
                   "rejects": sorted({case for (_, case) in verdicts if case != "accepts"})},
         witness_map={"shifts": "d1 + dauth, d2, d3", "identity_at_t": True},
         seconds={"generate": t_gen, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                  "prove_phases": dict(prof.cumulative),
                  "verify_sym": verdicts["sym", "accepts"][1],
                  "verify_pub": verdicts["pub", "accepts"][1], "verdicts": t_verdicts,
                  "witness_map_check": wm},
         host_seconds={"example": t_example, "auth_sign": t_auth, "auth_checks": t_auth_checks,
                       "replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return launches, lanes, kg_lanes


RAM_TAPE_WORDS = 16  # the public tape of the ram phase's program
# what the ram phase's program draws its body from (CIRCUIT_OPS but the
# memory operations, the jumps and answer, which it places itself)
RAM_ALU_OPS = ("mov", "cmov", "add", "sub", "and", "or", "xor", "not", "cmpe", "cmpa", "cmpae")


def ram_program(seed: int, w: int = 16, k: int = 16, tape_words: int = RAM_TAPE_WORDS):
    """A TinyRAM program and tape drawn from the seed, on a (w, k) machine,
    with only the opcodes of ``CIRCUIT_OPS``: it loads each of the
    ``tape_words`` tape words (boot-stored at addresses 0, 1, ...) in turn,
    between random ALU instructions over random registers and immediates,
    stores to and loads from random addresses below 2 * RAM_TAPE_WORDS, and
    takes forward jumps (jmp, cjmp, cnjmp) over one instruction; then xors
    every register into r0, subtracts the result it reached on this tape
    and answers r0, so it accepts this tape.  Returns (program, tape)."""
    rng = random.Random(seed)
    ap = TinyRAMArchParams(w, k)
    tape = [rng.randrange(1 << w) for _ in range(tape_words)]
    prog = TinyRAMProgram(ap, [])
    reg = lambda: rng.randrange(k)
    operand = lambda: (reg(), False) if rng.randrange(2) else (rng.randrange(1 << w), True)
    for i in range(tape_words):
        prog.add("loadw", des=reg(), arg2=i)
        for _ in range(2):
            a2, imm = operand()
            prog.add(rng.choice(RAM_ALU_OPS), des=reg(), arg1=reg(), arg2=a2, imm=imm)
        roll = rng.randrange(4)
        if roll == 0:
            prog.add("storew", arg1=reg(), arg2=rng.randrange(2 * RAM_TAPE_WORDS))
        elif roll == 1:
            prog.add("loadw", des=reg(), arg2=rng.randrange(2 * RAM_TAPE_WORDS))
        else:  # jump over the next instruction
            prog.add(("jmp", "cjmp", "cnjmp")[roll - 2 + rng.randrange(2)],
                     arg2=len(prog.instructions) + 2)
            a2, imm = operand()
            prog.add(rng.choice(RAM_ALU_OPS), des=reg(), arg1=reg(), arg2=a2, imm=imm)
    for r in range(1, k):
        prog.add("xor", des=0, arg1=0, arg2=r, imm=False)
    prog.add("answer", arg2=0, imm=False)
    _, result, _ = simulate(prog, tape, max_steps=1 << 12, init_mem=dict(enumerate(tape)))
    prog.instructions.insert(len(prog.instructions) - 1, Instruction("sub", 0, 0, result, True))
    return prog, tape


def as_waksman_switches(n: int) -> int:
    """Switches of an AS-Waksman network on n packets (gadgets/routing.py)."""
    if n <= 1:
        return 0
    if n == 2:
        return 1
    half, odd = n // 2, n % 2
    return half + half - 1 + odd + as_waksman_switches(half) + as_waksman_switches(half + odd)


def ram_constraints(program, tape_len: int, T: int, per_step: int, base: int) -> int:
    """Constraints of ``ram_to_r1cs(program, tape_len, T)``: ``base`` plus T
    steps of ``per_step``, plus the memory network on M = tape_len + T rows
    of 4 lines (a switch: 1 + 2 * 4 constraints) and each adjacent pair's
    checks (8 and a decomposition of w + the time bits)."""
    M = tape_len + T
    time_bits = max(1, math.ceil(math.log2(M + 1)))
    return (base + T * per_step + 9 * as_waksman_switches(M)
            + (M - 1) * (8 + program.ap.w + time_bits))


def ram_steps(program, tape_len: int, n: int):
    """The most steps T for which the circuit's QAP (its constraints plus
    tape_len + 1) fits a domain of n points, the per-step and fixed counts
    taken from circuits of 1 and 2 steps: (T, its constraints by
    ``ram_constraints``)."""
    c1, c2 = (ram_to_r1cs(program, tape_len, T)[0].num_constraints - ram_constraints(
        program, tape_len, T, 0, 0) for T in (1, 2))
    per_step, base = c2 - c1, 2 * c1 - c2
    T = 1
    while ram_constraints(program, tape_len, T + 1, per_step, base) + tape_len + 1 <= n:
        T += 1
    return T, ram_constraints(program, tape_len, T, per_step, base)


def ram_phase(model, hc, n: int, seed: int, pool):
    """The RAM ppzkSNARK (PGHR13 on the RAM -> R1CS reduction) on a program
    and tape drawn from the seed (``ram_program``), T steps such that the
    circuit's QAP fills a domain of n points (``ram_steps``):
    ``ram_ppzksnark.generator`` and ``prover`` (from ``--seed`` and
    ``--seed`` + 1) with the launch counts set to 0 just before each and read
    just after; the simulation accepting; the filled protoboard satisfied;
    the proof against the host's scalars with no MSM (``pghr13_host_proof``
    on the circuit's R1CS, the QAP at t by ``qap_at``); the QAP witness map
    with the prover's d1, d2, d3; the verdicts (the tape accepted, a changed
    tape word rejected).  Returns the prover's launch and lane counts, the
    generator's lane counts."""
    rr = model.Fr.p
    t0 = time.perf_counter()
    program, tape = ram_program(seed)
    T, predicted = ram_steps(program, len(tape), n)
    accepted, _, trace = simulate(program, tape, max_steps=T, init_mem=dict(enumerate(tape)))
    if not accepted:
        raise AssertionError(f"{hc.name} ram: the program does not accept its tape in {T} steps")
    t_draw = time.perf_counter() - t0
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_gen, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "ram keygen",
        lambda: ram_ppzksnark.generator(model, program, len(tape), T, random.Random(seed), kg_prof))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "ram prove",
        lambda: ram_ppzksnark.prover(model, kp, tape, random.Random(seed + 1), prof))
    pb = kp._handles[0]
    cs = kp.pk.constraint_system
    qap_n = qap.qap_domain_size(cs, model.Fr)
    if cs.num_constraints != predicted or qap_n != n:
        raise AssertionError(f"{hc.name} ram: {cs.num_constraints} constraints (predicted "
                             f"{predicted}), a QAP domain of {qap_n}")
    t0 = time.perf_counter()
    if not pb.is_satisfied():
        raise AssertionError(f"{hc.name} ram: the filled protoboard is not satisfied")
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    t_satisfied = time.perf_counter() - t0

    # the verdict on a changed tape word on the pool, while this process checks the rest
    t_verdicts = time.perf_counter()
    bad_tape = [tape[0] ^ 1] + tape[1:]
    rejected = pool.submit(verdict, (pghr13.verifier_strong_IC, kp.vk, bad_tape, proof))
    t0 = time.perf_counter()
    rng = random.Random(seed)
    t = rng.randrange(1, rr)
    secrets = tuple(rng.randrange(1, rr) for _ in range(6))
    draws = random.Random(seed + 1)
    d = tuple(draws.randrange(rr) for _ in range(3))
    Z, At, Bt, Ct = qap_at(model, hc, cs, t, pool)
    combG = host_comb(hc.g1, hc.g1_gen)
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, at_t = pghr13_host_proof(hc, combG, secrets, d, (Z, At, Bt, Ct), [1] + primary + aux,
                                   len(primary), pool)
    if proof != want:
        raise AssertionError(f"{hc.name} ram proof differs from the host's scalars")
    t_expected = time.perf_counter() - t0
    wm = check_witness_map(model, cs, R1CSExample(cs, primary, aux), qap_n, t, Z, at_t, [d], pool)
    del At, Bt, Ct
    t0 = time.perf_counter()
    if not ram_ppzksnark.verifier(model, kp, tape, proof):
        raise AssertionError(f"{hc.name}: ram_ppzksnark rejects the card's proof")
    t_verify = time.perf_counter() - t0
    if rejected.result():
        raise AssertionError(f"{hc.name}: ram_ppzksnark accepts a changed tape word")
    t_verdicts = time.perf_counter() - t_verdicts
    points = (*proof.g_A, *proof.g_B, *proof.g_C, proof.g_H, proof.g_K)
    emit("ram", curve=hc.name, w=program.ap.w, k=program.ap.k, instructions=len(program.instructions),
         tape_words=len(tape), steps_executed=len(trace), T=T, constraints=cs.num_constraints,
         variables=cs.num_variables, qap_domain=qap_n, accepted=True, satisfied=True,
         proof_sha256=proof_sha256(model, points), proof_equal=True,
         verifier={"accepts": True, "rejects": ["changed tape word"]},
         witness_map={"top": "d1 d2", "identity_at_t": True},
         seconds={"generate": t_gen, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                  "prove_phases": dict(prof.cumulative), "verify": t_verify,
                  "verdicts": t_verdicts, "witness_map_check": wm},
         host_seconds={"draw_and_steps": t_draw, "is_satisfied": t_satisfied, "replay": t_replay,
                       "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return launches, lanes, kg_lanes


def random_circuit(p: int, num_gates: int, seed: int):
    """A satisfiable BACS circuit drawn from the seed: one primary and two
    auxiliary inputs; each gate multiplies two combinations of one or two
    earlier wires (the constant among them); the last gate, (w - v) * 1 for
    the wire w before it and its value v, is the one circuit output."""
    rng = random.Random(seed)
    primary, aux = [rng.randrange(p)], [rng.randrange(p), rng.randrange(p)]
    circuit = BACSCircuit(p, primary_input_size=1, auxiliary_input_size=2)
    wires = primary + aux
    for _ in range(num_gates - 1):
        lcs = [[(rng.randrange(len(wires) + 1), rng.randrange(1, p)) for _ in range(rng.randrange(1, 3))]
               for _ in range(2)]
        gate = BACSGate(LinearCombination(lcs[0]), LinearCombination(lcs[1]), len(wires) + 1)
        circuit.add_gate(gate)
        wires.append(gate.evaluate(wires, p))
    circuit.add_gate(BACSGate(LinearCombination([(len(wires), 1), (0, p - wires[-1])]),
                              LinearCombination.constant(1), len(wires) + 1, True))
    return circuit, primary, aux


def bacs_phase(model, hc, num_gates: int, seed: int):
    """The BACS ppzkSNARK on a circuit of ``num_gates`` gates drawn from the
    seed: ``bacs_ppzksnark.generator`` and ``prover`` with the launch counts
    set to 0 just before each and read just after; the key pair and the
    proof equal to PGHR13's on ``bacs_to_r1cs.instance_map`` with the same
    seeds; the verdicts.  Returns the generator's and the prover's lane
    counts."""
    circuit, primary, aux = random_circuit(model.Fr.p, num_gates, seed)
    if not circuit.is_satisfied(primary, aux):
        raise AssertionError("the drawn circuit is not satisfied")
    kp, t_gen, kg_launches, kg_lanes, _ = path_run(
        model, hc, "bacs keygen",
        lambda: bacs_ppzksnark.generator(model, circuit, random.Random(seed)))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "bacs prove",
        lambda: bacs_ppzksnark.prover(model, kp.pk, primary, aux, random.Random(seed + 1)))
    cs = bacs_to_r1cs.instance_map(circuit)
    t0 = time.perf_counter()
    kp2 = pghr13.generator(model, cs, random.Random(seed))
    wires = bacs_to_r1cs.witness_map(circuit, primary, aux)
    proof2 = pghr13.prover(model, kp2.pk, primary, wires[1:], random.Random(seed + 1))
    t_pghr13 = time.perf_counter() - t0
    same_keys = kp.vk == kp2.vk and all(
        torch.equal(a, b) for f in ("A_query_g", "A_query_h", "B_query_g", "B_query_h", "C_query_g",
                                    "C_query_h", "H_query", "K_query")
        for a, b in zip(getattr(kp.pk.r1cs_pk, f), getattr(kp2.pk, f)))
    if not same_keys or proof != proof2:
        raise AssertionError(f"{hc.name} bacs: keys or proof differ from PGHR13's on the same R1CS")
    del kp2
    t0 = time.perf_counter()
    if not bacs_ppzksnark.verifier_strong_IC(kp.vk, primary, proof):
        raise AssertionError(f"{hc.name}: bacs_ppzksnark rejects the card's proof")
    t_verify = time.perf_counter() - t0
    if bacs_ppzksnark.verifier_strong_IC(kp.vk, [(primary[0] + 1) % model.Fr.p], proof):
        raise AssertionError(f"{hc.name}: bacs_ppzksnark accepts a wrong input")
    points = (*proof.g_A, *proof.g_B, *proof.g_C, proof.g_H, proof.g_K)
    emit("bacs", curve=hc.name, gates=num_gates, constraints=cs.num_constraints,
         qap_domain=type(get_domain_of_min_size(model.Fr, cs.num_constraints + 2)).__name__,
         proof_sha256=proof_sha256(model, points), equal_to_pghr13=True, verified=True,
         rejects=["input + 1"], seconds={"generate": t_gen, "prove": t_prove,
                                         "pghr13_generate_and_prove": t_pghr13, "verify": t_verify},
         peak_device_bytes=peak, launches={"keygen": kg_launches, "prove": launches},
         lanes={"keygen": top_lanes(kg_lanes), "prove": top_lanes(lanes)})
    return {"generator": kg_lanes, "prover": lanes}


def tbcs_circuit(num_gates: int, num_inputs: int, num_primary: int, num_outputs: int, seed: int):
    """A satisfiable TBCS circuit drawn from the seed: random input bits;
    the first 16 gates take the 16 types in a shuffled order with wire 0
    (TRUE) on the left, the rest random types over any earlier wires (0
    included); ``num_outputs`` of the rest, drawn at random, are circuit
    outputs, each given the complement of its drawn type where that type
    evaluates to true, so every output is false.  Returns (circuit, primary bits,
    auxiliary bits)."""
    rng = random.Random(seed)
    bits = [rng.randrange(2) for _ in range(num_inputs)]
    types = list(range(16))
    rng.shuffle(types)
    outputs = set(rng.sample(range(16, num_gates), num_outputs))
    circuit = TBCSCircuit(num_primary, num_inputs - num_primary)
    wires = list(bits)
    for j in range(num_gates):
        n = len(wires)
        gate = TBCSGate(0 if j < 16 else rng.randrange(n + 1), rng.randrange(n + 1),
                        types[j] if j < 16 else rng.randrange(16), n + 1, j in outputs)
        value = gate.evaluate(wires)
        if gate.is_circuit_output and value:
            gate.type ^= 15
            value = False
        circuit.add_gate(gate)
        wires.append(value)
    return circuit, bits[:num_primary], bits[num_primary:]


def ssp_at(model, hc, cs, w, t: int, pool) -> dict:
    """The USCS -> SSP reduction of ``cs`` at t by exact integers, from this
    script's own Lagrange basis over the SSP domain's points
    (uscs_to_ssp.tcc:57-136): V_i(t) = sum over the rows j where variable i
    appears of L_j(t) V_{j,i}, V_0 gaining L_j(t) at each dummy row j >=
    num_constraints (1^2 = 1); the rows' values on the assignment ``w`` (w[0]
    the constant 1) and V(t) = sum_i w_i V_i(t).  Returns Z(t), V_i(t) for
    i <= m, the values on the domain and V(t)."""
    r = model.Fr.p
    domain = get_domain_of_min_size(model.Fr, max(1, cs.num_constraints))
    kind, n = type(domain).__name__, domain.n
    z, L = lagrange_at(hc.fr_spec, kind, n, t, pool)
    Vt, aV = [0] * (cs.num_variables + 1), [1] * n
    for j, (u, lc) in enumerate(zip(L, cs.constraints)):
        val = 0
        for idx, coeff in lc.terms:
            Vt[idx] += u * coeff
            val += coeff * w[idx]
        aV[j] = val % r
    Vt[0] += sum(L[cs.num_constraints :])
    Vt = [v % r for v in Vt]
    return {"kind": kind, "n": n, "Zt": z, "Vt": Vt, "aV": aV,
            "V": sum(u * v for u, v in zip(L, aV)) % r}


def check_ssp_witness_map(model, at: dict, t: int, d: int, pool) -> dict:
    """The SSP witness map on the card for this script's own V on the domain
    and the prover's d: H's top coefficient is d^2 (Z's is 1) and
    (V(t) + d Z(t))^2 - 1 = H(t) Z(t).  Returns seconds."""
    Fr, z = model.Fr, at["Zt"]
    cv = Fr.from_canonical(canonical_words(Fr, at["aV"]))
    return check_square_witness_map(
        model, "SSP witness map", lambda: ssp.witness_map_device(model, cv, d), at["n"], d * d,
        (at["V"] + d * z) ** 2 - 1, t, z, pool)


def tbcs_phase(model, hc, sizes, seed: int, pool):
    """The TBCS ppzkSNARK, which is the USCS ppzkSNARK on the circuit's
    lowering, on a circuit drawn from the seed (``tbcs_circuit``; ``sizes``
    = gates, inputs, primary inputs, outputs): ``tbcs_ppzksnark.generator``
    and ``prover`` (from ``--seed`` and ``--seed`` + 1), each with the launch
    counts set to 0 just before and read just after; every query family and
    the verification key against exact multiplication of the scalars
    replayed on the host (the SSP at t by ``ssp_at``); the proof against the
    host's scalars, with no MSM (uscs_ppzksnark.py's docstring); the SSP
    witness map with the prover's d; the verdicts.  Returns the prover's
    launch and lane counts and the generator's lane counts."""
    rr = model.Fr.p
    num_gates, num_inputs, num_primary, num_outputs = sizes
    t0 = time.perf_counter()
    circuit, primary, aux = tbcs_circuit(num_gates, num_inputs, num_primary, num_outputs, seed)
    wires = circuit.get_all_wires(primary, aux)
    if any(wires[g.output - 1] for g in circuit.gates if g.is_circuit_output):
        raise AssertionError("the drawn circuit has a true output")
    if {g.type for g in circuit.gates} != set(range(16)) or \
            not any(0 in (g.left_wire, g.right_wire) for g in circuit.gates):
        raise AssertionError("the drawn circuit misses a gate type or the constant wire")
    t_draw = time.perf_counter() - t0
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_gen, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "tbcs keygen",
        lambda: tbcs_ppzksnark.generator(model, circuit, random.Random(seed), kg_prof))
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "tbcs prove",
        lambda: tbcs_ppzksnark.prover(model, kp.pk, primary, aux, random.Random(seed + 1), prof))

    # the generator's draws (t, alpha, tilde), the SSP at t, the prover's d
    t0 = time.perf_counter()
    pk, vk = kp.pk.uscs_pk, kp.vk
    cs = pk.constraint_system
    if cs.num_constraints != 2 * num_gates + num_inputs + num_outputs:
        raise AssertionError(f"{hc.name} tbcs: {cs.num_constraints} USCS constraints")
    rng = random.Random(seed)
    t, alpha, tilde = (rng.randrange(1, rr) for _ in range(3))
    d = random.Random(seed + 1).randrange(rr)
    w = [1] + [int(b) for b in wires]
    at = ssp_at(model, hc, cs, w, t, pool)
    kind, n, Z, Vt, l, m = at["kind"], at["n"], at["Zt"], at["Vt"], num_primary, cs.num_variables
    table = Vt + [Z]
    combG, combH = host_comb(hc.g1, hc.g1_gen), host_comb(hc.g2, hc.g2_gen)
    t_replay = time.perf_counter() - t0

    t0 = time.perf_counter()
    chk = random.Random(seed)
    checked = {key: check_family(model, hc, key, getattr(pk, key), values, coeff, comb, chk, pool)
               for key, values, coeff, comb in (
                   ("V_g1_query", table[l + 1 :], 1, combG),
                   ("alpha_V_g1_query", table[l + 1 :], alpha, combG),
                   ("H_g1_query", Powers(t, n + 1, rr), 1, combG),
                   ("V_g2_query", table, 1, combH))}
    H2 = hc.g2_gen
    singles = ((vk.tilde_g2, hc.g2.mul(tilde, H2)), (vk.alpha_tilde_g2, hc.g2.mul(alpha * tilde % rr, H2)),
               (vk.Z_g2, hc.g2.mul(Z, H2)), (vk.encoded_IC_base, combG.mul(Vt[0])),
               (vk.encoded_IC_values, [combG.mul(v) for v in Vt[1 : l + 1]]))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name} tbcs: the verification key differs")
    t_checks = time.perf_counter() - t0

    # V_g1 = (V_rest(t) + d Z) G, alpha times it, H(t) G, (V(t) + d Z) H
    t0 = time.perf_counter()
    V_rest = sum(wi * v for wi, v in zip(w[l + 1 :], Vt[l + 1 :])) % rr
    vd = (at["V"] + d * Z) % rr
    h_t = (vd * vd - 1) * pow(Z, -1, rr) % rr
    want = tbcs_ppzksnark.Proof(V_g1=combG.mul((V_rest + d * Z) % rr),
                                alpha_V_g1=combG.mul(alpha * (V_rest + d * Z) % rr),
                                H_g1=combG.mul(h_t), V_g2=hc.g2.mul(vd, H2))
    if proof != want:
        raise AssertionError(f"{hc.name} tbcs proof at {num_gates} gates differs from the host's "
                             "scalars")
    t_expected = time.perf_counter() - t0
    wm = check_ssp_witness_map(model, at, t, d, pool)
    del at, table
    tampered = tbcs_ppzksnark.Proof(**{**vars(proof), "V_g1": hc.g1.add(proof.V_g1, hc.g1_gen)})
    verdicts = check_verdicts(hc, tbcs_ppzksnark, vk, primary, proof, tampered, pool,
                              wrong_input=[1 - primary[0]] + primary[1:])
    points = (proof.V_g1, proof.alpha_V_g1, proof.H_g1, proof.V_g2)
    emit("tbcs", curve=hc.name, gates=num_gates, inputs=num_inputs, primary_inputs=num_primary,
         outputs=num_outputs, constraints=cs.num_constraints, ssp_domain=[kind, n], m=m,
         queries_checked=checked, proof_sha256=proof_sha256(model, points), proof_equal=True,
         verifier={"accepts": True, "rejects": ["flipped primary bit", "tampered V_g1",
                                                "truncated input"]},
         witness_map={"top": "d^2", "identity_at_t": True},
         seconds={"draw_circuit": t_draw, "generate": t_gen, "keygen_phases": dict(kg_prof.cumulative),
                  "prove": t_prove, "prove_phases": dict(prof.cumulative), **verdicts,
                  "witness_map_check": wm},
         host_seconds={"replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return launches, lanes, kg_lanes


# --------------------------------------------------------------------------
# phase: pcd (single-predicate PCD over the MNT cycle)
# --------------------------------------------------------------------------
PCD_LOCAL = (3, 7, 5)  # the increments of steps 0, 1 and 2 (step k > 2 adds k + 2)


def counter_predicate(p: int, mult: int = 1):
    """out = mult * in + local over [1 | out type, out value | arity | in
    type, in value | local]; primary = the outgoing message (the JAX
    package's tests/test_pcd.py:32-48 and tests/test_mp_pcd.py:32-51)."""
    cs = R1CSConstraintSystem(p, primary_input_size=2, auxiliary_input_size=4)
    cs.add_constraint(R1CSConstraint(LinearCombination.of_var(5, mult) + LinearCombination.of_var(6),
                                     LinearCombination.of_var(0), LinearCombination.of_var(2)))
    return pcd.CompliancePredicate(name=mult, type=1, constraint_system=cs,
                                   outgoing_message_payload_length=1, max_arity=1,
                                   incoming_message_payload_lengths=[1], local_data_length=1,
                                   witness_length=0)


def groth16_key_checks(model, hc, pk, vk, keys: dict, n: int, rng, pool) -> dict:
    """An in-process ``groth16_full`` key against exact multiplication of
    the generator's replayed secrets (``keys``: t, alpha, beta, delta,
    g1_scalar, the QAP at t and Z(t)) over a QAP domain of n: the five query
    families (``check_family``), the single points, ABC and e(alpha, beta)
    as e(g1 base, G2)^(alpha beta).  Raises on a difference; returns the
    families' counts."""
    r = model.Fr.p
    g1s, dinv, nin = keys["g1_scalar"], pow(keys["delta"], -1, r), keys["nin"]
    abc = [(keys["beta"] * a + keys["alpha"] * b + c) % r
           for a, b, c in zip(keys["At"], keys["Bt"], keys["Ct"])]
    combG, combH = host_comb(hc.g1, hc.g1_gen), host_comb(hc.g2, hc.g2_gen)
    checked = {key: check_family(model, hc, key, getattr(pk, key), values, coeff, comb, rng, pool)
               for key, values, coeff, comb in (
                   ("A_query", keys["At"], g1s, combG), ("B_query_g1", keys["Bt"], g1s, combG),
                   ("B_query_g2", keys["Bt"], 1, combH),
                   ("L_query", [v * dinv % r for v in abc[nin + 1 :]], g1s, combG),
                   ("H_query", Powers(keys["t"], n - 1, r), keys["Zt"] * dinv * g1s, combG))}
    g1b = combG.mul(g1s)
    engine = AtePairing(hc)
    singles = ((pk.alpha_g1, combG.mul(keys["alpha"] * g1s % r)),
               (pk.beta_g1, combG.mul(keys["beta"] * g1s % r)),
               (pk.delta_g1, combG.mul(keys["delta"] * g1s % r)),
               (pk.beta_g2, combH.mul(keys["beta"])), (pk.delta_g2, combH.mul(keys["delta"])),
               (vk.delta_g2, pk.delta_g2),
               (vk.ABC_g1, [combG.mul(v * g1s % r) for v in abc[: nin + 1]]),
               (vk.alpha_g1_beta_g2, engine.GT.pow(engine.reduced_pairing(g1b, hc.g2_gen),
                                                   keys["alpha"] * keys["beta"] % r)))
    if any(got != want for got, want in singles):
        raise AssertionError(f"{hc.name}: the single points or the verification key differ")
    return checked


def replay_groth16_key(model, hc, cs, kg_seed: int, pool, skip: int = 0) -> dict:
    """What ``groth16_full.proving_key`` drew from ``random.Random(kg_seed)``
    (after ``skip`` draws of earlier keys: t, alpha, beta, delta, then the G1
    base's scalar) and the QAP of its (swapped) constraint system ``cs`` at t
    by this script's own Lagrange basis (``qap_at``): the ``keys`` of
    ``groth16_key_checks`` and ``check_groth16_proof`` but the witness."""
    rng = random.Random(kg_seed)
    rr = model.Fr.p
    for _ in range(skip):
        rng.randrange(1, rr)
    t, alpha, beta, delta, g1s = (rng.randrange(1, rr) for _ in range(5))
    zt, At, Bt, Ct = qap_at(model, hc, cs, t, pool)
    return {"t": t, "alpha": alpha, "beta": beta, "delta": delta, "g1_scalar": g1s, "Zt": zt,
            "At": At, "Bt": Bt, "Ct": Ct, "nin": cs.primary_input_size}


def check_groth16_proof(model, hc, keys: dict, w, blinding, proof, what: str, pool):
    """A ``groth16_full`` proof against the host's scalars with no MSM
    (``blinded_scalars``) for the witness w = [1] + primary + auxiliary under
    the replayed key ``keys`` and the prover's (r, s) ``blinding``.  Raises on
    a difference."""
    rr = model.Fr.p
    a, b, c = blinded_scalars(model, keys, qap_at_t(model, {**keys, "w": w}, pool), *blinding)
    combG, g1s = host_comb(hc.g1, hc.g1_gen), keys["g1_scalar"]
    want = (combG.mul(a * g1s % rr), hc.g2.mul(b, hc.g2_gen), combG.mul(c * g1s % rr))
    if (proof.g_A, proof.g_B, proof.g_C) != want:
        raise AssertionError(f"{hc.name} {what}: the proof differs from the host's scalars")


def blinding_of(pr_seed: int, rr: int, step: int = 0) -> tuple:
    """The (r, s) of the ``step``-th ``groth16_full.prover`` call on one
    ``random.Random(pr_seed)``: each call draws r, then s."""
    draws = random.Random(pr_seed)
    for _ in range(2 * step):
        draws.randrange(rr)
    return draws.randrange(rr), draws.randrange(rr)


def pcd_step(ctx: dict, k: int, pred, prev, seed: int, pool) -> dict:
    """Step k of the chain on ``ctx``'s curve (the outer one): the step
    circuit and its key (``SPPCDProver.keygen``), the fill checks, the prove,
    each with the launch counts set to 0 just before and read just after;
    then the key against exact multiplication of the secrets replayed from
    the seed (the QAP at t by ``qap_at``), the proof against the host's
    scalars with no MSM, the verdicts.  ``prev`` is the previous step's
    (vk, proof, outgoing message, inner curve) or None for the base case.
    Returns the step's key, proof, message, launch and lane counts."""
    model, hc = ctx["model"], ctx["hc"]
    rr = model.Fr.p
    arity = 0 if prev is None else 1
    inner_vk, inner_proof, inc_msg, inner = prev or (None, None, None, None)
    incoming = [inc_msg or pcd.R1CSPCDMessage(1, [0])]
    local = PCD_LOCAL[k] if k < len(PCD_LOCAL) else k + 2
    out = pcd.R1CSPCDMessage(1, [(incoming[0].payload[0] + local) % rr])
    ld = pcd.R1CSPCDLocalData([local])
    prover = pcd.SPPCDProver(hc.name, model.device)
    kg_seed, pr_seed = seed + 100 + k, seed + 200 + k
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_kg, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "pcd keygen",
        lambda: prover.keygen(pred, random.Random(kg_seed), inner_vk, arity, kg_prof))
    cs, circ = kp.pk.constraint_system, kp.circuit
    nin = cs.primary_input_size
    domain = get_domain_of_min_size(model.Fr, cs.num_constraints + nin + 1)
    n = domain.n

    fills, t0 = {"real": True}, time.perf_counter()
    if arity:  # a forged predecessor (A + G1) and a wrong outgoing message
        ihc = host_curve(inner)
        forged = groth16_full.Proof(ihc.g1.add(inner_proof.g_A, ihc.g1_gen), inner_proof.g_B,
                                    inner_proof.g_C)
        wrong = pcd.R1CSPCDMessage(1, [out.payload[0] + 1])
        fills["forged_proof"] = circ.fill(out, incoming, ld, [], [forged])
        fills["wrong_message"] = circ.fill(wrong, incoming, ld, [], [inner_proof])
        if fills["forged_proof"] is not False or fills["wrong_message"] is not False:
            raise AssertionError(f"{hc.name} pcd step {k}: fill accepts {fills}")
    t_fills = time.perf_counter() - t0
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "pcd prove",
        lambda: prover.prove(kp, out, incoming, ld, [], random.Random(pr_seed),
                             None if prev is None else [inner_proof], prof))

    t0 = time.perf_counter()
    keys = replay_groth16_key(model, hc, cs, kg_seed, pool)
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = groth16_key_checks(model, hc, kp.pk, kp.vk, keys, n, random.Random(seed + k), pool)
    t_checks = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_groth16_proof(model, hc, keys, [1] + circ.pb.primary_input() + circ.pb.auxiliary_input(),
                        blinding_of(pr_seed, rr), proof, f"pcd step {k}", pool)
    t_expected = time.perf_counter() - t0
    del keys

    t0 = time.perf_counter()
    wrong_msg = [1, (out.payload[0] + 1) % rr]
    rejected = pool.submit(verdict, (groth16_full.verifier_strong_IC, kp.vk, wrong_msg, proof))
    t1 = time.perf_counter()
    if not prover.verify(kp, out, proof):
        raise AssertionError(f"{hc.name} pcd step {k}: verify rejects the card's proof")
    t_verify = time.perf_counter() - t1
    if rejected.result():
        raise AssertionError(f"{hc.name} pcd step {k}: verify accepts (1, value + 1)")
    t_verdicts = time.perf_counter() - t0
    sha = hashlib.sha256(proof.to_bytes(model)).hexdigest()
    emit("pcd", step=k, curve=hc.name, inner=inner, arity=arity, message=out.as_assignment(),
         constraints=cs.num_constraints, variables=cs.num_variables, qap_domain=n,
         qap_domain_kind=type(domain).__name__, fill=fills, queries_checked=checked,
         proof_sha256=sha, proof_equal=True,
         verifier={"accepts": out.as_assignment(), "rejects": [wrong_msg]},
         seconds={"keygen": t_kg, "keygen_phases": dict(kg_prof.cumulative), "fill_checks": t_fills,
                  "prove": t_prove, "prove_phases": dict(prof.cumulative), "verify": t_verify,
                  "verdicts": t_verdicts},
         host_seconds={"replay": t_replay, "query_checks": t_checks, "expected_proof": t_expected},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    return {"vk": kp.vk, "proof": proof, "out": out, "sha": sha, "qap_domain": n,
            "launches": launches, "lanes": lanes, "kg_lanes": kg_lanes}


def pcd_phase(contexts: dict, steps: int, seed: int, errs: dict, pool) -> list:
    """A chain of steps + 1 proofs with the counter predicate: the base case
    on MNT4753 (arity 0, message (1, 3)), then each step on the other curve
    (arity 1), its circuit verifying the previous proof in-circuit against
    the previous key, its message the previous one plus 7, 5, ... (``pcd_step``);
    after each step the kernels at its prove's and its generator's shapes
    on that curve.  Returns, per step, the curve, the QAP domain, the
    prove's launches and the kernels' numbers at its shapes."""
    out, prev, t0 = [], None, time.perf_counter()
    for k in range(steps + 1):
        curve = "MNT4753" if k % 2 == 0 else "MNT6753"
        ctx = contexts[curve]
        model = ctx["model"]
        step = pcd_step(ctx, k, counter_predicate(model.Fr.p), prev, seed, pool)
        report = kernels_after(ctx, errs, "pcd", step["lanes"], step["kg_lanes"])
        out.append({"curve": curve, "step": k, "qap_domain": step["qap_domain"],
                    "launches": step["launches"], "report": report, "sha": step["sha"],
                    "message": step["out"].as_assignment()})
        prev = (step["vk"], step["proof"], step["out"], curve)
    emit("pcd_chain", proofs=steps + 1,
         chain=[{k: s[k] for k in ("step", "curve", "qap_domain", "message", "sha")} for s in out],
         seconds=time.perf_counter() - t0)
    return out


def kernels_after(ctx: dict, errs: dict, phase: str, lanes: dict, gen_lanes=None) -> dict:
    """Every kernel a phase launched on ``ctx``'s curve against its plain
    version, and timed, at the phase's prove's lane counts
    (``check_kernels_at_path_shapes``) and at its generator's that no earlier
    check of the curve compared: the report."""
    torch.cuda.empty_cache()
    args = (ctx["model"], ctx["g1_strip"], ctx["g2_strip"], ctx["rng"])
    report = check_kernels_at_path_shapes(*args, shape_picks(lanes), errs, ctx["done"],
                                          f"kernels_at_{phase}_shapes")
    if gen_lanes:
        check_kernels_at_new_shapes(*args, gen_lanes, errs, ctx["done"],
                                    f"kernels_at_{phase}_generator_shapes")
    torch.cuda.empty_cache()
    return report


def merged_counts(*runs) -> dict:
    """Launch or lane counts of several runs of one path, summed."""
    out = {}
    for run in runs:
        for name, v in run.items():
            if isinstance(v, dict):
                into = out.setdefault(name, {})
                for shape, count in v.items():
                    into[shape] = into.get(shape, 0) + count
            else:
                out[name] = out.get(name, 0) + v
    return out


# --------------------------------------------------------------------------
# phase: mp_pcd (multi-predicate PCD)
# --------------------------------------------------------------------------
MP_IN, MP_LOCAL = 5, 3  # the base case's incoming value and local increment


def knapsack_digest(p: int, elems) -> int:
    """The knapsack hash of field elements, recomputed here: the sum mod p
    of the coefficients at the set bits of their p.bit_length()-bit
    little-endian concatenation (``gadgets/knapsack.py``'s coefficients)."""
    n = p.bit_length()
    coeffs = knapsack_coefficients(p, n * len(elems))
    return sum(coeffs[j * n + i] for j, e in enumerate(elems) for i in range(n)
               if (e % p) >> i & 1) % p


def mp_verify(args) -> bool:
    """``MPPCDProver.verify`` on a pool process, on a key pair without its
    proving keys and circuits."""
    curve, kp, which, message, proof, num_incoming = args
    return mp_pcd.MPPCDProver(curve, "cpu").verify(kp, which, message, proof, num_incoming)


def mp_base_case(ctx: dict, seed: int, pool) -> dict:
    """``MPPCDProver`` at arity 0 on ``ctx``'s curve (MNT4753) over two
    counter predicates (mult 1 and 2): its keygen, and one prove under each
    key, each with the launch counts set to 0 just before and read just
    after; the commitment and leaves against the knapsack digests of the
    keys recomputed here; each key against exact multiplication of its
    replayed secrets and each proof against the host's scalars; ``verify``
    accepting both proofs and rejecting a wrong message and the other key."""
    model, hc = ctx["model"], ctx["hc"]
    rr = model.Fr.p
    preds = [counter_predicate(rr, mult) for mult in (1, 2)]
    prover = mp_pcd.MPPCDProver(hc.name, model.device)
    kg_seed, pr_seed = seed + 400, seed + 410
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_kg, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "mp keygen", lambda: prover.keygen(preds, random.Random(kg_seed), profiler=kg_prof))
    ihc = host_curve(mp_pcd.partner(hc.name))
    q = ihc.g2.F.p
    leaves = [knapsack_digest(q, vk_field_elements(ihc, vk, 2)) for vk in kp.vks]
    if kp.leaves != leaves or kp.commitment != knapsack_digest(q, leaves):
        raise AssertionError(f"{hc.name} mp: the commitment or its leaves differ from the host's")
    incoming, ld = [pcd.R1CSPCDMessage(1, [MP_IN])], pcd.R1CSPCDLocalData([MP_LOCAL])
    runs, checked, t_checks = [], [], 0.0
    for j, pred in enumerate(preds):
        out = pcd.R1CSPCDMessage(1, [(j + 1) * MP_IN + MP_LOCAL])
        proof, t_prove, launches, lanes, peak = path_run(
            model, hc, "mp prove",
            lambda: prover.prove(kp, j, out, incoming, ld, [], random.Random(pr_seed + j),
                                 profiler=prof))
        t0 = time.perf_counter()
        pk, circ = kp.pks[j], kp.circuits[j]
        cs = pk.constraint_system
        keys = replay_groth16_key(model, hc, cs, kg_seed, pool, skip=5 * j)
        n = get_domain_of_min_size(model.Fr, cs.num_constraints + cs.primary_input_size + 1).n
        checked.append(groth16_key_checks(model, hc, pk, kp.vks[j], keys, n,
                                          random.Random(seed + 420 + j), pool))
        check_groth16_proof(model, hc, keys, [1] + circ.pb.primary_input() + circ.pb.auxiliary_input(),
                            blinding_of(pr_seed + j, rr), proof, f"mp prove {j}", pool)
        t_checks += time.perf_counter() - t0
        runs.append({"out": out, "proof": proof, "seconds": t_prove, "launches": launches,
                     "lanes": lanes, "peak": peak, "primary": circ.pb.primary_input()})
    t0 = time.perf_counter()
    bare = replace(kp, pks=[None] * len(kp.pks), circuits=None)
    wrong = [pool.submit(mp_verify, (hc.name, bare, which, msg, r["proof"], 1))
             for j, r in enumerate(runs)
             for which, msg in ((j, pcd.R1CSPCDMessage(1, [r["out"].payload[0] + 1])),
                                (1 - j, r["out"]))]
    t1 = time.perf_counter()
    if not all(prover.verify(kp, j, r["out"], r["proof"], 1) for j, r in enumerate(runs)):
        raise AssertionError(f"{hc.name} mp: verify rejects a proof of the card's")
    t_verify = time.perf_counter() - t1
    if any(w.result() for w in wrong):
        raise AssertionError(f"{hc.name} mp: verify accepts a wrong message or the other key")
    t_verdicts = time.perf_counter() - t0
    emit_fields = {
        "curve": hc.name, "arity": 0, "predicates": ["out = in + local", "out = 2 in + local"],
        "constraints": [pk.constraint_system.num_constraints for pk in kp.pks],
        "commitment_equal": True, "messages": [r["out"].as_assignment() for r in runs],
        "public_inputs": [r["primary"] for r in runs], "queries_checked": checked,
        "proofs_equal": True,
        "proof_sha256": [hashlib.sha256(r["proof"].to_bytes(model)).hexdigest() for r in runs],
        "verify": {"accepts": "both proofs under their keys",
                   "rejects": ["value + 1 under each key", "each proof under the other key"]},
        "seconds": {"keygen": t_kg, "keygen_phases": dict(kg_prof.cumulative),
                    "prove": [r["seconds"] for r in runs], "prove_phases": dict(prof.cumulative),
                    "verify": t_verify, "verdicts": t_verdicts},
        "host_seconds": {"key_and_proof_checks": t_checks},
        "peak_device_bytes": {"keygen": kg_peak, "prove": max(r["peak"] for r in runs)},
        "launches": {"keygen": kg_launches, "prove": [r["launches"] for r in runs]}}
    return {"fields": emit_fields, "launches": merged_counts(*(r["launches"] for r in runs)),
            "lanes": merged_counts(*(r["lanes"] for r in runs)), "kg_lanes": kg_lanes}


def mp_recursive_step(ctx: dict, inner_ctx: dict, seed: int, pool) -> dict:
    """The recursive step as the JAX package's tests/test_mp_pcd.py:54-110
    drives it, on ``ctx``'s curve (MNT6753): two keys of the partner curve
    (``groth16_full.generator`` on the card, the (5, 2) field-input example,
    two seeds) and a proof under the first; ``MPPCDStepCircuit`` at arity 1
    with the depth-1 commitment of that set; the four fill verdicts; then
    ``groth16_full.proving_key`` and ``prover`` on the card (launch counts
    set to 0 just before each and read just after), the key against exact
    multiplication of the replayed secrets, the proof against the host's
    scalars, ``verifier_strong_IC`` on the step's input and a changed one."""
    model, hc = ctx["model"], ctx["hc"]
    imodel, ihc = inner_ctx["model"], inner_ctx["hc"]
    rr = model.Fr.p
    t0 = time.perf_counter()
    ex = generate_r1cs_example_with_field_input(imodel.Fr.p, 5, 2, random.Random(seed + 430))
    inner_kps = [groth16_full.generator(imodel, ex.constraint_system, random.Random(seed + s))
                 for s in (431, 432)]
    inner_proof = groth16_full.prover(imodel, inner_kps[0].pk, ex.primary_input,
                                      ex.auxiliary_input, random.Random(seed + 433))
    if not groth16_full.verifier_strong_IC(inner_kps[0].vk, ex.primary_input, inner_proof):
        raise AssertionError(f"{ihc.name} mp: the inner proof does not verify")
    root, leaves = mp_pcd.vk_set_commitment(ihc, [kp.vk for kp in inner_kps], 2)
    t_inner = time.perf_counter() - t0

    t0 = time.perf_counter()
    with collector_paused():
        circ = mp_pcd.MPPCDStepCircuit(hc.name, counter_predicate(rr), set_depth=1, arity=1)
        cs = circ.pb.get_constraint_system()
    t_circuit = time.perf_counter() - t0
    t0 = time.perf_counter()
    typ, val = ex.primary_input
    incoming, ld = [pcd.R1CSPCDMessage(typ, [val])], pcd.R1CSPCDLocalData([7])
    out = pcd.R1CSPCDMessage(typ, [(val + 7) % rr])
    forged = groth16_full.Proof(ihc.g1.add(inner_proof.g_A, ihc.g1_gen), inner_proof.g_B,
                                inner_proof.g_C)
    vk0, vk1 = (kp.vk for kp in inner_kps)
    fills = {what: circ.fill(out, incoming, ld, [], root, inner=[edge]) for what, edge in (
        ("key 1 at slot 1", (vk1, inner_proof, 1, leaves)),
        ("key 0 at slot 1", (vk0, inner_proof, 1, leaves)),
        ("forged proof", (vk0, forged, 0, leaves)),
        ("key 0 at slot 0", (vk0, inner_proof, 0, leaves)))}  # last: the circuit keeps it
    if list(fills.values()) != [False, False, False, True]:
        raise AssertionError(f"{hc.name} mp step: fill verdicts {fills}")
    t_fills = time.perf_counter() - t0
    primary, aux = circ.pb.primary_input(), circ.pb.auxiliary_input()

    kg_seed, pr_seed = seed + 440, seed + 441
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    (pk, secrets), t_kg, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "mp step keygen",
        lambda: groth16_full.proving_key(model, cs, random.Random(kg_seed), kg_prof))
    vk = groth16_full.verification_key(pk, secrets)
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "mp step prove",
        lambda: groth16_full.prover(model, pk, primary, aux, random.Random(pr_seed), profiler=prof))
    cs = pk.constraint_system
    domain = get_domain_of_min_size(model.Fr, cs.num_constraints + cs.primary_input_size + 1)

    t0 = time.perf_counter()
    keys = replay_groth16_key(model, hc, cs, kg_seed, pool)
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = groth16_key_checks(model, hc, pk, vk, keys, domain.n, random.Random(seed + 442), pool)
    t_checks = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_groth16_proof(model, hc, keys, [1] + primary + aux, blinding_of(pr_seed, rr), proof,
                        "mp step", pool)
    t_expected = time.perf_counter() - t0
    del keys

    t0 = time.perf_counter()
    changed = [primary[0], (primary[1] + 1) % rr] + primary[2:]
    rejected = pool.submit(verdict, (groth16_full.verifier_strong_IC, vk, changed, proof))
    t1 = time.perf_counter()
    if not groth16_full.verifier_strong_IC(vk, primary, proof):
        raise AssertionError(f"{hc.name} mp step: the verifier rejects the card's proof")
    t_verify = time.perf_counter() - t1
    if rejected.result():
        raise AssertionError(f"{hc.name} mp step: the verifier accepts a changed input")
    t_verdicts = time.perf_counter() - t0
    emit_fields = {
        "curve": hc.name, "inner": ihc.name, "arity": 1, "set_depth": 1,
        "inner_keys": 2, "constraints": cs.num_constraints, "variables": cs.num_variables,
        "qap_domain": domain.n, "qap_domain_kind": type(domain).__name__,
        "public_input": primary, "fill": fills, "queries_checked": checked,
        "proof_sha256": hashlib.sha256(proof.to_bytes(model)).hexdigest(), "proof_equal": True,
        "verifier": {"accepts": primary, "rejects": [changed]},
        "seconds": {"keygen": t_kg, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                    "prove_phases": dict(prof.cumulative), "verify": t_verify,
                    "verdicts": t_verdicts},
        "host_seconds": {"inner_keys_and_proof": t_inner, "step_circuit": t_circuit,
                         "fills": t_fills, "replay": t_replay, "query_checks": t_checks,
                         "expected_proof": t_expected},
        "peak_device_bytes": {"keygen": kg_peak, "prove": peak},
        "launches": {"keygen": kg_launches, "prove": launches}}
    return {"fields": emit_fields, "launches": launches, "lanes": lanes, "kg_lanes": kg_lanes,
            "qap_domain": domain.n}


def mp_pcd_phase(contexts: dict, seed: int, errs: dict, pool) -> list:
    """The base case on MNT4753 (``mp_base_case``) and the recursive step on
    MNT6753 (``mp_recursive_step``), each followed by the kernels at its
    shapes; one ``mp_pcd`` line.  Returns the kernel entries."""
    t0 = time.perf_counter()
    base = mp_base_case(contexts["MNT4753"], seed, pool)
    base_report = kernels_after(contexts["MNT4753"], errs, "mp_base", base["lanes"],
                                base["kg_lanes"])
    step = mp_recursive_step(contexts["MNT6753"], contexts["MNT4753"], seed, pool)
    step_report = kernels_after(contexts["MNT6753"], errs, "mp_step", step["lanes"],
                                step["kg_lanes"])
    emit("mp_pcd", base=base["fields"], step=step["fields"], lanes={
        "base": top_lanes(base["lanes"]), "step": top_lanes(step["lanes"])},
         seconds=time.perf_counter() - t0)
    return [{"curve": "MNT4753", "size": {"part": "base", "arity": 0},
             "launches": base["launches"], "report": base_report},
            {"curve": "MNT6753", "size": {"part": "step", "arity": 1,
                                          "qap_domain": step["qap_domain"]},
             "launches": step["launches"], "report": step_report}]


# --------------------------------------------------------------------------
# phase: ram_zksnark (the RAM zkSNARK: one PCD proof a machine step)
# --------------------------------------------------------------------------
RAM_ZK_DEPTH = 5  # address bits of the ram_zksnark phase's memory: 32 words


def sp_pcd_verify(args) -> bool:
    """``SPPCDProver.verify`` on a pool process, on a key pair of the
    verification key and the predicate without its constraints."""
    curve, vk, pred, message, proof = args
    return pcd.SPPCDProver(curve, "cpu").verify(pcd.SPPCDKeypair(None, vk, pred), message, proof)


def ram_zksnark_phase(ctx: dict, tape_words: int, seed: int, errs: dict, pool) -> list:
    """The RAM zkSNARK on ``ctx``'s curve (MNT4753) for a program and tape
    drawn from the seed (``ram_program``, w = k = 16, ``tape_words`` tape
    words, memory of 2^RAM_ZK_DEPTH words), T its steps to acceptance by
    ``simulate``: ``ram_zksnark.generator`` (arity 0) and ``prover`` over all
    T steps, each with the launch counts set to 0 just before and read just
    after; each step's incoming state the previous step's outgoing one (the
    memory roots chain) and its pc, registers and flag the simulator's; every
    step's proof through ``SPPCDProver.verify`` on the pool; the key against
    exact multiplication of the replayed secrets, the first and last steps'
    proofs against the host's scalars; ``verifier`` accepting the final
    state and rejecting it with its root + 1 and with has_accepted 0."""
    model, hc = ctx["model"], ctx["hc"]
    rr = model.Fr.p
    t0 = time.perf_counter()
    program, tape = ram_program(seed, tape_words=tape_words)
    accepted, _, trace = simulate(program, tape, max_steps=1 << 12, init_mem=dict(enumerate(tape)))
    if not accepted:
        raise AssertionError(f"{hc.name} ram_zksnark: the program does not accept its tape")
    T = len(trace)
    t_draw = time.perf_counter() - t0
    kg_seed, pr_seed = seed + 500, seed + 501
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    kp, t_kg, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "ram_zksnark keygen",
        lambda: ram_zksnark.generator(program, RAM_ZK_DEPTH, random.Random(kg_seed), hc.name,
                                      device=model.device, profiler=kg_prof))
    spk = kp.pcd_kp
    circ, cs = spk.circuit, spk.pk.constraint_system
    bare_pred = replace(spk.predicate, constraint_system=R1CSConstraintSystem(
        cs.p, primary_input_size=spk.predicate.constraint_system.primary_input_size))
    steps, verdicts = [], []

    def on_step(k, s_in, s_out, proof):
        msg = pcd.R1CSPCDMessage(1, s_out.payload())
        verdicts.append(pool.submit(sp_pcd_verify, (hc.name, spk.vk, bare_pred, msg, proof)))
        w = [1] + circ.pb.primary_input() + circ.pb.auxiliary_input() if k in (0, T - 1) else None
        steps.append((s_in, s_out, proof, w))

    (final, last), t_prove, launches, lanes, peak = path_run(
        model, hc, "ram_zksnark prove",
        lambda: ram_zksnark.prover(kp, tape, T, random.Random(pr_seed), prof, on_step))
    t0 = time.perf_counter()
    for k, ((s_in, s_out, _, _), row) in enumerate(zip(steps, trace)):
        if k and s_in != steps[k - 1][1]:
            raise AssertionError(f"{hc.name} ram_zksnark: step {k}'s incoming state is not "
                                 f"step {k - 1}'s outgoing one")
        if (s_in.timestamp, s_in.pc, s_in.regs, s_in.flag) != (k, row.pc, row.regs, row.flag):
            raise AssertionError(f"{hc.name} ram_zksnark: step {k} is not the simulator's")
    if not (final.has_accepted and last is steps[-1][2] and len(steps) == T):
        raise AssertionError(f"{hc.name} ram_zksnark: the last state does not accept")
    t_chain = time.perf_counter() - t0

    t0 = time.perf_counter()
    keys = replay_groth16_key(model, hc, cs, kg_seed, pool)
    n = get_domain_of_min_size(model.Fr, cs.num_constraints + cs.primary_input_size + 1).n
    checked = groth16_key_checks(model, hc, spk.pk, spk.vk, keys, n, random.Random(seed + 502), pool)
    for k in (0, T - 1):
        check_groth16_proof(model, hc, keys, steps[k][3], blinding_of(pr_seed, rr, k), steps[k][2],
                            f"ram_zksnark step {k}", pool)
    del keys
    t_checks = time.perf_counter() - t0

    t0 = time.perf_counter()
    tampered = [replace(final, root=(final.root + 1) % rr), replace(final, has_accepted=0)]
    wrong = pool.submit(sp_pcd_verify, (hc.name, spk.vk, bare_pred,
                                        pcd.R1CSPCDMessage(1, tampered[0].payload()), last))
    t1 = time.perf_counter()
    if not ram_zksnark.verifier(kp, tape, final, last):
        raise AssertionError(f"{hc.name} ram_zksnark: the verifier rejects the final state")
    t_verify = time.perf_counter() - t1
    if ram_zksnark.verifier(kp, tape, tampered[1], last) or wrong.result():
        raise AssertionError(f"{hc.name} ram_zksnark: the verifier accepts a tampered final state")
    if not all(v.result() for v in verdicts):
        raise AssertionError(f"{hc.name} ram_zksnark: a step's proof does not verify")
    t_verdicts = time.perf_counter() - t0
    domain = get_domain_of_min_size(model.Fr, cs.num_constraints + cs.primary_input_size + 1)
    emit("ram_zksnark", curve=hc.name, w=program.ap.w, k=program.ap.k, memory_depth=RAM_ZK_DEPTH,
         instructions=len(program.instructions), tape_words=len(tape), T=T,
         constraints=cs.num_constraints, variables=cs.num_variables, qap_domain=domain.n,
         qap_domain_kind=type(domain).__name__, final_state=final.payload(),
         steps_verified=len(verdicts), proofs_equal=[0, T - 1], queries_checked=checked,
         proof_sha256=[hashlib.sha256(steps[k][2].to_bytes(model)).hexdigest() for k in (0, T - 1)],
         verifier={"accepts": "the final state", "rejects": ["root + 1", "has_accepted 0"]},
         seconds={"generate": t_kg, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                  "prove_per_step": t_prove / T, "prove_phases": dict(prof.cumulative),
                  "verify": t_verify, "verdicts": t_verdicts},
         host_seconds={"draw": t_draw, "chain_checks": t_chain, "key_and_proof_checks": t_checks},
         peak_device_bytes={"keygen": kg_peak, "prove": peak},
         launches={"keygen": kg_launches, "prove": launches}, lanes=top_lanes(lanes),
         keygen_lanes=top_lanes(kg_lanes))
    report = kernels_after(ctx, errs, "ram_zksnark", lanes, kg_lanes)
    return [{"curve": hc.name, "size": {"T": T, "qap_domain": domain.n}, "launches": launches,
             "report": report}]


# --------------------------------------------------------------------------
# phase: fixnum (the stage-1 field-arithmetic stream)
# --------------------------------------------------------------------------
FIXNUM_CHUNKS = 2


def mont_product_bytes(args) -> bytes:
    """a_i * b_i * 2^-768 mod q over Python integers, 96 bytes each."""
    a, b, q = args
    rinv = pow(1 << 768, -1, q)
    return b"".join((int.from_bytes(a[i : i + 96], "little") * int.from_bytes(b[i : i + 96], "little")
                     * rinv % q).to_bytes(96, "little") for i in range(0, len(a), 96))


def fixnum_phase(contexts: dict, n: int, seed: int, workdir: Path, errs: dict, pool) -> list:
    """``cli_fixnum.main`` on the card over a stream of FIXNUM_CHUNKS chunks
    of n (n / 2 Montgomery products over q(MNT4753), then over q(MNT6753), a
    chunk), words drawn from the seed below 2^751, with the launch counts set
    to 0 just before and read just after; its output held byte for byte
    against Python-integer products on the pool; then the Montgomery kernel
    at its lane count on each curve (Fr of one curve is Fq of the other)."""
    ctx = contexts["MNT4753"]
    t0 = time.perf_counter()
    src, dst = workdir / "fixnum-inputs", workdir / "fixnum-outputs"
    rng = np.random.default_rng(seed + 700)
    chunks = []
    with open(src, "wb") as f:
        for _ in range(FIXNUM_CHUNKS):
            words = rng.integers(0, 1 << 32, size=(2 * n, 24), dtype=np.uint32)
            words[:, 23] &= 0x7FFF  # below 2^751, so below both moduli
            data = words.astype("<u4").tobytes()
            f.write(struct.pack("<Q", n) + data)
            chunks.append(data)
    t_write = time.perf_counter() - t0
    _, t_run, launches, lanes, peak = path_run(
        ctx["model"], ctx["hc"], "fixnum", lambda: cli_fixnum.main([str(src), str(dst)]),
        kernels=["mont_mul"])
    t0 = time.perf_counter()
    half, tasks = 48 * n, []
    for data in chunks:
        for j, q in enumerate(contexts[c]["model"].Fq.p for c in ("MNT4753", "MNT6753")):
            a, b = data[2 * j * half : (2 * j + 1) * half], data[(2 * j + 1) * half : (2 * j + 2) * half]
            step = -(-n // 2 // HOST_PIECES) * 96
            tasks += [(a[i : i + step], b[i : i + step], q) for i in range(0, half, step)]
    want = b"".join(pool.map(mont_product_bytes, tasks))
    got = dst.read_bytes()
    if got != want:
        raise AssertionError("fixnum: the card's products differ from the integers'")
    t_check = time.perf_counter() - t0
    emit("fixnum", chunks=FIXNUM_CHUNKS, n=n, products_per_curve_per_chunk=n // 2,
         output_bytes=len(got), output_sha256=hashlib.sha256(got).hexdigest(), equal=True,
         seconds={"stream": t_run}, host_seconds={"write_stream": t_write, "check": t_check},
         peak_device_bytes=peak, launches=launches, lanes=top_lanes(lanes))
    mont = {"mont_mul": lanes["mont_mul"]}
    return [{"curve": c, "size": {"n": n, "modulus": f"Fr of {c}"}, "launches": launches,
             "report": kernels_after(contexts[c], errs, "fixnum", mont)} for c in contexts]


# --------------------------------------------------------------------------
# phase: pedersen (the batch Pedersen hash, one staged MSM)
# --------------------------------------------------------------------------
PEDERSEN_COEFFS = 2048  # the coefficient strip: max_input_size


def pedersen_host_hashes(args) -> list:
    ped, rows = args
    return [ped.hash_bits([bool(b) for b in row])[0] for row in rows]


def pedersen_phase(ctx: dict, messages: int, seed: int, errs: dict, pool) -> list:
    """``pedersen.hash_batch_device`` for a batch of ``messages`` messages of
    PEDERSEN_COEFFS bits drawn from the seed (the last all ones), over
    ``ctx``'s curve's G1 (MNT6753, the inner curve of MNT4753), with the
    launch counts set to 0 just before and read just after; every digest
    against ``PedersenSchnorr.hash_bits`` on the pool; one ``sign`` /
    ``verify`` pair on top, and a flipped message bit rejected."""
    model, hc = ctx["model"], ctx["hc"]
    t0 = time.perf_counter()
    ped = pedersen.PedersenSchnorr("MNT4753", random.Random(seed + 800), PEDERSEN_COEFFS)
    if ped.hc.name != hc.name:
        raise AssertionError(f"pedersen: the hash is over {ped.hc.name}, not {hc.name}")
    rng = random.Random(seed + 801)
    bits = [[rng.randrange(2) for _ in range(PEDERSEN_COEFFS)] for _ in range(messages - 1)]
    bits.append([1] * PEDERSEN_COEFFS)
    t_setup = time.perf_counter() - t0
    got, t_hash, launches, lanes, peak = path_run(
        model, hc, "pedersen",
        lambda: pedersen.hash_batch_device("MNT4753", ped.coeffs, bits, model.device),
        kernels=["ec_add_fp", "ec_dbl_fp"])
    t0 = time.perf_counter()
    want = list(chain.from_iterable(pool.map(pedersen_host_hashes, [(ped, part)
                                                                    for part in pieces(bits)])))
    if got != want:
        raise AssertionError("pedersen: the card's digests differ from the host's")
    t_check = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk, pk = ped.keygen()
    msg = [bool(b) for b in bits[0][:256]]
    sig = ped.sign(sk, msg)
    flipped = [not msg[0]] + msg[1:]
    if not ped.verify(pk, msg, sig) or ped.verify(pk, flipped, sig):
        raise AssertionError("pedersen: the Schnorr verdicts are wrong")
    t_sign = time.perf_counter() - t0
    emit("pedersen", curve=hc.name, messages=messages, bits=PEDERSEN_COEFFS, digests_equal=len(got),
         schnorr={"accepts": "256-bit message", "rejects": ["first bit flipped"]},
         seconds={"hash_batch": t_hash}, host_seconds={"setup": t_setup, "check": t_check,
                                                       "sign_and_verify": t_sign},
         peak_device_bytes=peak, launches=launches, lanes=top_lanes(lanes))
    report = kernels_after(ctx, errs, "pedersen", lanes)
    return [{"curve": hc.name, "size": {"messages": messages, "bits": PEDERSEN_COEFFS},
             "launches": launches, "report": report}]


# --------------------------------------------------------------------------
# phase: caml (circuits built through the camlsnark_* C ABI, as Mina's snarky
# drives libsnark; keys and proofs in libsnark's iostream bytes)
# --------------------------------------------------------------------------
def caml_chain_circuit(ffi, num_constraints: int, num_inputs: int, rng):
    """The field-input chain of r1cs_examples.tcc (``relations.examples.
    generate_r1cs_example_with_field_input``, drawing from ``rng`` in its
    order) built through the C ABI on a new protoboard of ``ffi``: the
    constraints (a + b) * 1 = c and a * b = c, then (sum of the variables)^2
    = the last one, and the assignment.  Returns the protoboard."""
    pb, p = ffi.protoboard(), ffi.modulus()
    n_vars = num_constraints + 2
    vars_ = [pb.allocate() for _ in range(n_vars)]
    pb.set_input_sizes(num_inputs)
    a, b = rng.randrange(p), rng.randrange(p)
    assignment = [a, b]
    for i in range(num_constraints - 1):
        if i % 2:
            A, B, tmp = pb.lc([(1, vars_[i])]), pb.lc([(1, vars_[i + 1])]), a * b % p
        else:
            A, B, tmp = pb.lc([(1, vars_[i]), (1, vars_[i + 1])]), pb.lc([(1, 0)]), (a + b) % p
        assignment.append(tmp)
        a, b = b, tmp
        pb.add_constraint(A, B, pb.lc([(1, vars_[i + 2])]))
    fin = sum(assignment) % p
    total = [(1, v) for v in vars_[:-1]]
    pb.add_constraint(pb.lc(total), pb.lc(total), pb.lc([(1, vars_[-1])]))
    assignment.append(fin * fin % p)
    for v, val in zip(vars_, assignment):
        pb.set(v, val)
    return pb


CAML_INPUTS = 2  # primary inputs of the caml phase's circuits
CAML_COUNT_LANES = 4099  # lanes of the kernel-against-plain op-count comparison


def lane_sum(lanes: dict, name: str) -> int:
    """Lanes of all launches of a kernel (for a doubling, lanes times k)."""
    return sum(math.prod(as_tuple(shape)) * count for shape, count in lanes.get(name, {}).items())


def check_op_counts(model, report: dict, lanes: dict) -> dict:
    """A prove's op-count report against its launches: each group's add is
    its K2 lanes, its dbl the lanes times k of its K3 launches, and the
    field products counted outside the group kernels (every mul and sqr
    less those ``cuda_group.formula_ops`` records for the kernels) are K1's
    lanes.  Raises on a difference; returns the sums."""
    got, in_groups = {}, 0
    for G in (model.G1, model.G2):
        for op, kern in (("add", "ec_add"), ("dbl", "ec_dbl")):
            n = report.get(f"{G.name}.{op}", 0)
            got[f"{G.name}.{op}"] = (n, lane_sum(lanes, f"{kern}_{G.kernel_field}"))
            in_groups += n * sum(v for k, v in cuda_group.formula_ops(G, op).items()
                                 if k.endswith((".mul", ".sqr")))
    products = sum(v for k, v in report.items() if k.endswith((".mul", ".sqr")))
    got["products outside the group kernels"] = (products - in_groups,
                                                 lane_sum(lanes, "mont_mul"))
    bad = {k: v for k, v in got.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"{model.name}: op counts against launched lanes "
                             f"(counted, launched): {bad}")
    return {k: v[0] for k, v in got.items()}


def kernel_and_plain_counts(ctx: dict, n: int) -> dict:
    """A G1 and a G2 addition and doubling (k = 1 and 4) at n lanes,
    counted through the kernel (``Curve.add`` / ``double`` on the card) and
    through its plain version on the card: equal reports.  Returns them."""
    model = ctx["model"]
    out = {}
    for G, strip in ((model.G1, ctx["g1_strip"]), (model.G2, ctx["g2_strip"])):
        P = point_tensors(model, G, strip, n, 0)
        Q = point_tensors(model, G, strip, n, 1)
        for what, kern, plain in (
                ("add", lambda: G.add(P, Q), lambda: cuda_group.ec_add_plain(G, P, Q)),
                ("dbl", lambda: G.double(P), lambda: cuda_group.ec_dbl_plain(G, P)),
                ("dbl k=4", lambda: G.double(P, 4), lambda: cuda_group.ec_dbl_plain(G, P, 4))):
            reports = []
            for run in (kern, plain):
                with op_counts.counting() as c:
                    run()
                reports.append(c.report())
            if reports[0] != reports[1]:
                raise AssertionError(f"{G.name} {what}: kernel {reports[0]} != plain {reports[1]}")
            out[f"{G.name} {what}"] = reports[0]
    torch.cuda.synchronize()
    return out


def caml_curve(ctx: dict, n: int, seed: int, pool, counted: bool) -> dict:
    """One curve's caml path at num_constraints + num_inputs + 1 = n: the
    chain circuit built natively, extracted and its digest checked against
    the extracted terms and the port's own example; ``groth16_full`` key,
    verification key and prove on the card; the verdicts; the proof against
    the host's scalars with no MSM; the key, verification key and proof in
    libsnark's bytes through the native ``*_of_string`` / ``*_to_string``
    (bytes equal), read back onto the card, and the key read back proving to
    the same bytes under the same seed: that prove under
    ``op_counts.counting()`` when ``counted``, its report against its launches."""
    model, hc = ctx["model"], ctx["hc"]
    rr, curve = model.Fr.p, hc.name
    t0 = time.perf_counter()
    ffi = caml_ffi.CamlFFI(curve)
    t_load = time.perf_counter() - t0
    if ffi.modulus() != rr:
        raise AssertionError(f"caml {curve}: the native field is not Fr")
    nc = n - CAML_INPUTS - 1
    t0 = time.perf_counter()
    pb = caml_chain_circuit(ffi, nc, CAML_INPUTS, random.Random(seed + 900))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs, primary, aux = pb.extract()
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    digest = pb.digest()
    ex = generate_r1cs_example_with_field_input(rr, nc, CAML_INPUTS, random.Random(seed + 900))
    if digest != caml_ffi.r1cs_digest(cs) or digest != caml_ffi.r1cs_digest(ex.constraint_system):
        raise AssertionError(f"caml {curve}: the native digest differs from the extracted terms'")
    if (primary, aux) != (ex.primary_input, ex.auxiliary_input) or not cs.is_satisfied(primary, aux):
        raise AssertionError(f"caml {curve}: the extracted assignment differs or fails")
    t_digest = time.perf_counter() - t0
    del ex

    kg_seed, pr_seed = seed + 901, seed + 902
    kg_prof, prof = Profiler(model.device, verbose=False), Profiler(model.device, verbose=False)
    (pk, secrets), t_kg, kg_launches, kg_lanes, kg_peak = path_run(
        model, hc, "caml keygen",
        lambda: groth16_full.proving_key(model, cs, random.Random(kg_seed), kg_prof))
    t0 = time.perf_counter()
    vk = groth16_full.verification_key(pk, secrets)
    t_vk = time.perf_counter() - t0
    proof, t_prove, launches, lanes, peak = path_run(
        model, hc, "caml prove",
        lambda: groth16_full.prover(model, pk, primary, aux, random.Random(pr_seed), prof))
    domain = get_domain_of_min_size(model.Fr, cs.num_constraints + CAML_INPUTS + 1)
    tampered = groth16_full.Proof(hc.g1.add(proof.g_A, hc.g1_gen), proof.g_B, proof.g_C)
    verdicts = check_verdicts(hc, groth16_full, vk, primary, proof, tampered, pool)
    t0 = time.perf_counter()
    keys = replay_groth16_key(model, hc, cs, kg_seed, pool)
    check_groth16_proof(model, hc, keys, [1] + primary + aux, blinding_of(pr_seed, rr), proof,
                        "caml prove", pool)
    t_expected = time.perf_counter() - t0
    del keys

    # libsnark's bytes, through the native string entry points and back
    t0 = time.perf_counter()
    blobs = {"proving_key": cser.proving_key_to_bytes(pk),
             "verification_key": cser.verification_key_to_bytes(vk),
             "proof": cser.proof_to_bytes_caml(curve, proof)}
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = {"proving_key": ffi.proving_key_to_string(pk),
              "verification_key": ffi.verification_key_to_string(vk),
              "proof": ffi.proof_to_string(proof)}
    t_native = time.perf_counter() - t0
    if native != blobs:
        raise AssertionError(f"caml {curve}: the native strings differ from the port's bytes: "
                             f"{[k for k in blobs if native[k] != blobs[k]]}")
    t0 = time.perf_counter()
    pk2 = ffi.proving_key_of_string(native["proving_key"], model.device)
    t_read = time.perf_counter() - t0
    if (ffi.verification_key_of_string(native["verification_key"]) != vk
            or ffi.proof_of_string(native["proof"]) != proof
            or pk2.A_query[0].device != model.device
            or cser.proving_key_to_bytes(pk2) != blobs["proving_key"]):
        raise AssertionError(f"caml {curve}: what was read back differs")
    scope = op_counts.counting() if counted else contextlib.nullcontext()
    with scope as oc:
        proof2, t_prove2, launches2, lanes2, _ = path_run(
            model, hc, "caml prove (key read back)",
            lambda: groth16_full.prover(model, pk2, primary, aux, random.Random(pr_seed)))
    if cser.proof_to_bytes_caml(curve, proof2) != blobs["proof"]:
        raise AssertionError(f"caml {curve}: the key read back proves to other bytes")
    counts = None
    if counted:
        counts = {"report": oc.report(), "against_launches": check_op_counts(model, oc.report(),
                                                                            lanes2)}
        print(f"op counts, {curve} caml prove (print_cumulative_op_counts):", flush=True)
        oc.print_report()
    return {"curve": curve, "constraints": cs.num_constraints, "variables": cs.num_variables,
            "terms": sum(len(c.a.terms) + len(c.b.terms) + len(c.c.terms) for c in cs.constraints),
            "qap_domain": domain.n, "digest": digest.hex(),
            "bytes": {k: len(v) for k, v in blobs.items()},
            "proof_sha256": hashlib.sha256(blobs["proof"]).hexdigest(), "op_counts": counts,
            "seconds": {"keygen": t_kg, "keygen_phases": dict(kg_prof.cumulative), "prove": t_prove,
                        "prove_phases": dict(prof.cumulative), "prove_key_read_back": t_prove2,
                        **verdicts},
            "host_seconds": {"load_library": t_load, "build_circuit": t_build,
                             "extract": t_extract, "digest_and_example": t_digest,
                             "verification_key": t_vk, "expected_proof": t_expected,
                             "write_bytes": t_write, "native_round_trip": t_native,
                             "read_key_to_card": t_read},
            "peak_device_bytes": {"keygen": kg_peak, "prove": peak},
            "launches": {"keygen": kg_launches, "prove": launches, "prove_key_read_back": launches2},
            "lanes": top_lanes(lanes), "keygen_lanes": top_lanes(kg_lanes),
            "_lanes": lanes, "_kg_lanes": kg_lanes}


def caml_phase(contexts: dict, sizes: dict, seed: int, errs: dict, pool) -> list:
    """The caml path on each curve of ``sizes`` (num_constraints +
    num_inputs + 1; 0 skips the curve): ``caml_curve``, the MNT4753 prove
    with the key read back counted; then, under ``op_counts.counting()``, a
    G1 and a G2 addition and doubling at the towers check's lanes through
    each kernel and its plain version (``kernel_and_plain_counts``); the
    kernels at the path's lane counts."""
    out = []
    for curve, n in sizes.items():
        if not n:
            continue
        ctx = contexts[curve]
        r = caml_curve(ctx, n, seed, pool, counted=curve == "MNT4753")
        lanes, kg_lanes = r.pop("_lanes"), r.pop("_kg_lanes")
        t0 = time.perf_counter()
        r["kernel_and_plain_counts"] = kernel_and_plain_counts(ctx, CAML_COUNT_LANES)
        r["host_seconds"]["kernel_and_plain_counts"] = time.perf_counter() - t0
        emit("caml", **r)
        out.append({"curve": curve, "size": {"n": n, "qap_domain": r["qap_domain"]},
                    "launches": r["launches"]["prove"],
                    "report": kernels_after(ctx, errs, "caml", lanes, kg_lanes)})
    return out


def rand_ints(rng, n: int, bits: int) -> list:
    """n integers below 2^bits from a numpy generator, by their words."""
    nw = -(-bits // 32)
    words = rng.integers(0, 1 << 32, size=(n, nw), dtype=np.uint32)
    if bits % 32:
        words[:, -1] &= np.uint32((1 << (bits % 32)) - 1)
    raw = words.astype("<u4").tobytes()
    return [int.from_bytes(raw[i : i + 4 * nw], "little") for i in range(0, len(raw), 4 * nw)]


# --------------------------------------------------------------------------
# phase: polynomial (multiplication_fft at the challenge's QAP size)
# --------------------------------------------------------------------------
def polynomial_phase(ctx: dict, n: int, seed: int, errs: dict, pool) -> list:
    """``ops.polynomial.multiplication`` of two polynomials of n coefficients
    over MNT4753's Fr drawn from the seed (a domain of 2n), with the launch
    counts set to 0 just before and read just after; a(x) b(x) = c(x) at two
    points drawn from the seed by host Horner on the pool; the kernels at its
    lane counts."""
    model, hc = ctx["model"], ctx["hc"]
    F, rr = model.Fr, model.Fr.p
    rng = np.random.default_rng(seed + 1000)
    t0 = time.perf_counter()
    a, b = ([v % rr for v in rand_ints(rng, n, 753)] for _ in range(2))
    t_draw = time.perf_counter() - t0
    c, t_mul, launches, lanes, peak = path_run(
        model, hc, "polynomial", lambda: polynomial.multiplication(F, a, b), kernels=["mont_mul"])
    t0 = time.perf_counter()
    points = [v % rr for v in rand_ints(rng, 2, 753)]
    for x in points:
        if (pool_horner(pool, a, x, rr) * pool_horner(pool, b, x, rr) - pool_horner(pool, c, x, rr)) % rr:
            raise AssertionError(f"polynomial: a(x) b(x) != c(x) at x = {x}")
    t_check = time.perf_counter() - t0
    emit("polynomial", field=F.name, coefficients=[n, n], product_coefficients=len(c),
         domain=1 << (2 * n - 2).bit_length(), points_checked=2,
         seconds={"multiplication": t_mul}, host_seconds={"draw": t_draw, "check": t_check},
         peak_device_bytes=peak, launches=launches, lanes=top_lanes(lanes))
    return [{"curve": hc.name, "size": {"coefficients": n}, "launches": launches,
             "report": kernels_after(ctx, errs, "polynomial", lanes)}]


# --------------------------------------------------------------------------
# phase: functions (batched modexp, modinv, quorem, divexact, chinese)
# --------------------------------------------------------------------------
def modexp_piece(args) -> list:
    bases, exps, p = args
    return [pow(b, e, p) for b, e in zip(bases, exps)]


def modinv_piece(args) -> list:
    vals, p = args
    return [pow(v, -1, p) if v % p else 0 for v in vals]


def quorem_piece(args) -> list:
    nums, dens = args
    return [divmod(u, d) for u, d in zip(nums, dens)]


def pooled(pool, fn, *cols, extra=()) -> list:
    """fn over the columns in pieces on ``pool``, flattened."""
    parts = list(zip(*(pieces(c) for c in cols)))
    return list(chain.from_iterable(pool.map(fn, [(*p, *extra) for p in parts])))


def functions_phase(ctx: dict, n: int, seed: int, errs: dict, pool) -> list:
    """``ops.functions`` at n lanes on MNT4753, with the launch counts set to
    0 just before and read just after: ``modexp`` and ``modinv`` on Fr with
    753-bit exponents, ``quorem`` of 753-bit numerators by 400-bit
    denominators, ``divexact`` of exact products (370 by 370 bits),
    ``chinese`` over (r, q); every lane against Python integers on the pool;
    the kernels at its lane counts."""
    model, hc = ctx["model"], ctx["hc"]
    Fr, Fq = model.Fr, model.Fq
    rr, qq = Fr.p, Fq.p
    rng = np.random.default_rng(seed + 1100)
    t0 = time.perf_counter()
    bases = [v % rr for v in rand_ints(rng, n, 753)]
    exps = rand_ints(rng, n, 753)
    nums, dens = rand_ints(rng, n, 753), [d | 1 for d in rand_ints(rng, n, 400)]
    quots, divs = rand_ints(rng, n, 370), [d | 1 for d in rand_ints(rng, n, 370)]
    xs = [v % (rr * qq) for v in rand_ints(rng, n, 1506)]
    words = canonical_words
    inputs = {"modexp": (Fr.from_canonical(words(Fr, bases)), words(Fr, exps)),
              "modinv": (Fr.from_canonical(words(Fr, bases)),),
              "quorem": (words(Fr, nums), words(Fr, dens)),
              "divexact": (words(Fr, [u * v for u, v in zip(quots, divs)]), words(Fr, divs)),
              "chinese": (words(Fq, [x % rr for x in xs]), words(Fq, [x % qq for x in xs]))}
    t_draw = time.perf_counter() - t0
    calls = {"modexp": lambda e: functions.modexp(Fr, *e), "modinv": lambda e: functions.modinv(Fr, *e),
             "quorem": lambda e: functions.quorem(*e), "divexact": lambda e: functions.divexact(*e),
             "chinese": lambda e: functions.chinese(Fr, Fq, *e)}
    secs = {}

    def run():
        outs = {}
        for name, call in calls.items():
            t = time.perf_counter()
            outs[name] = call(inputs[name])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
        return outs

    outs, t_all, launches, lanes, peak = path_run(model, hc, "functions", run, kernels=["mont_mul"])
    t0 = time.perf_counter()
    ints = lambda t: words_to_ints(t.cpu().numpy())
    got_exp = ints(Fr.to_canonical(outs["modexp"]))
    got_inv = ints(Fr.to_canonical(outs["modinv"]))
    q, r = (ints(t) for t in outs["quorem"])
    got_div = ints(outs["divexact"])
    crt = np.ascontiguousarray(outs["chinese"].cpu().numpy().view(np.uint32).T).astype("<u4").tobytes()
    got_crt = [int.from_bytes(crt[i : i + 192], "little") for i in range(0, len(crt), 192)]
    failed = [name for name, ok in (
        ("modexp", got_exp == pooled(pool, modexp_piece, bases, exps, extra=(rr,))),
        ("modinv", got_inv == pooled(pool, modinv_piece, bases, extra=(rr,))),
        ("quorem", list(zip(q, r)) == pooled(pool, quorem_piece, nums, dens)),
        ("divexact", got_div == quots),
        ("chinese", got_crt == xs)) if not ok]
    if failed:
        raise AssertionError(f"functions: lanes differ from Python integers in {failed}")
    t_check = time.perf_counter() - t0
    emit("functions", n=n, field=Fr.name, chinese_moduli=[Fr.name, Fq.name],
         bits={"modexp_exponents": 753, "quorem": [753, 400], "divexact": [740, 370]},
         lanes_equal=n, seconds={**secs, "all": t_all},
         host_seconds={"draw": t_draw, "check": t_check}, peak_device_bytes=peak,
         launches=launches, lanes=top_lanes(lanes))
    return [{"curve": hc.name, "size": {"lanes": n}, "launches": launches,
             "report": kernels_after(ctx, errs, "functions", lanes)}]


def largest_and_commonest(name: str, seen: dict) -> set:
    """The largest shape of ``seen`` ({shape: launches}; a doubling's (lanes,
    k) by lanes times k) and the one launched most."""
    size = (lambda s: (s[0] * s[1], s)) if name.startswith("ec_dbl") else (lambda s: s)
    return {max(seen, key=size), max(seen, key=lambda s: (seen[s], s))}


def shape_picks(lanes: dict) -> dict:
    """A path's lane counts cut to what ``check_kernels_at_path_shapes``
    times: the doublings at their largest and commonest (lanes, k)."""
    out = dict(lanes)
    for name in (k for k in lanes if k.startswith("ec_dbl")):
        seen = lanes[name]
        picks = sorted(largest_and_commonest(name, seen), key=lambda s: (s[0] * s[1], s),
                       reverse=True)
        out[name] = {s: seen[s] for s in picks}
    return out


def run_curve(curve: str, sizes, args, workdir: Path, errs: dict, pool):
    """All phases of one curve.  Returns the launch counts of its largest
    prove, the kernels' numbers at that prove's lane counts, and by path
    ("keygen", "groth16", "gm17" and, unless their arguments are 0,
    "pghr13", "adsnark", "ram" and "tbcs") the same for its key generation
    and its blinded Groth16, GM17, PGHR13, ADSNARK, RAM and TBCS proves, with
    the path's size; and what the pcd phase needs of the curve (its model,
    strips, generator and compared shapes) with the towers check's
    numbers."""
    model = MODELS[curve].get("cuda")
    hc = host_curve(curve)
    g1_strip, g2_strip = strips(hc)
    rng = random.Random(args.seed)
    done = {}  # (kernel, shape) -> its row, for the shapes compared on this curve
    at_shapes = lambda lanes, phase: check_kernels_at_path_shapes(
        model, g1_strip, g2_strip, rng, lanes, errs, done, phase)
    at_new_shapes = lambda lanes, phase: check_kernels_at_new_shapes(
        model, g1_strip, g2_strip, rng, lanes, errs, done, phase)
    towers = (check_towers(model, hc, g2_strip, args.towers, random.Random(args.seed + 13), pool)
              if args.towers else {})
    check_kernels(model, g1_strip, g2_strip, rng, errs, (1, default_window_bits(max(sizes))))
    prove_small(curve, workdir)
    runs = []
    for n in sizes:  # ascending: the last prove is the largest
        runs.append(prove_full(model, hc, g1_strip, g2_strip, workdir, n, args.seed, pool))
        torch.cuda.empty_cache()
    launches, path_lanes = runs[-1]
    # the doublings at every prove's (lanes, k), the largest prove's first
    for _, lanes in runs[-2::-1]:
        for name in (k for k in lanes if k.startswith("ec_dbl")):
            for shape, count in lanes[name].items():
                path_lanes[name].setdefault(shape, count)
    report = at_shapes(path_lanes, "kernels_at_path_shapes")
    torch.cuda.empty_cache()

    kg_launches, kg_lanes, gen, keys = keygen(model, hc, workdir, args.keygen[curve], args.seed,
                                              pool)
    torch.cuda.empty_cache()
    kg_report = at_shapes(shape_picks(kg_lanes), "kernels_at_keygen_shapes")
    torch.cuda.empty_cache()

    g16_launches, g16_lanes = groth16(model, hc, workdir, args.keygen[curve], args.seed, gen, keys,
                                      pool)
    ex = gen.example
    del gen, keys
    torch.cuda.empty_cache()
    g16_report = at_shapes(shape_picks(g16_lanes), "kernels_at_groth16_shapes")
    torch.cuda.empty_cache()

    # GM17 and PGHR13 on the key generation's example (on MNT4753 on examples
    # of their own, --gm17-4 and --pghr13-4), ADSNARK on its own, then BACS and the
    # RAM ppzkSNARK (MNT4753), then TBCS; the kernels also at the generators'
    # and BACS's shapes that are new on this curve
    kg_n = args.keygen[curve]
    paths = {"keygen": (kg_launches, kg_report, {"d_plus_1": kg_n}),
             "groth16": (g16_launches, g16_report, {"d_plus_1": kg_n})}

    def path_phase(name: str, size: dict, run):
        path_launches, path_lanes, gen_lanes = run()
        torch.cuda.empty_cache()
        paths[name] = (path_launches, at_shapes(shape_picks(path_lanes), f"kernels_at_{name}_shapes"),
                       size)
        at_new_shapes(gen_lanes, f"kernels_at_{name}_generator_shapes")
        torch.cuda.empty_cache()

    n17 = args.gm17[curve]
    if n17:
        ex17 = ex if n17 == kg_n else generate_r1cs_example_with_field_input(
            model.Fr.p, n17 - 2, 1, random.Random(args.seed + 5))
        path_phase("gm17", {"d_plus_1": n17},
                   lambda: gm17_phase(model, hc, n17, args.seed, ex17, pool))
        del ex17
    n13 = args.pghr13[curve]
    if n13:
        ex13 = ex if n13 == kg_n else generate_r1cs_example_with_field_input(
            model.Fr.p, n13 - 2, 1, random.Random(args.seed + 4))
        path_phase("pghr13", {"d_plus_1": n13},
                   lambda: pghr13_phase(model, hc, n13, args.seed, ex13, pool))
        del ex13
    del ex
    if args.adsnark[curve]:
        n_ads, l_ads = args.adsnark[curve]
        path_phase("adsnark", {"d_plus_1": n_ads, "inputs": l_ads},
                   lambda: adsnark_phase(model, hc, n_ads, l_ads, args.seed, pool))
    if curve == "MNT4753" and args.bacs_gates:
        for what, lanes in bacs_phase(model, hc, args.bacs_gates, args.seed).items():
            torch.cuda.empty_cache()
            at_new_shapes(lanes, f"kernels_at_bacs_{what}_shapes")
    if curve == "MNT4753" and args.ram4:
        path_phase("ram", {"qap_domain": args.ram4},
                   lambda: ram_phase(model, hc, args.ram4, args.seed, pool))
    if args.tbcs[curve]:
        path_phase("tbcs", {"gates": args.tbcs[curve][0]},
                   lambda: tbcs_phase(model, hc, args.tbcs[curve], args.seed, pool))
    ctx = {"model": model, "hc": hc, "g1_strip": g1_strip, "g2_strip": g2_strip, "rng": rng,
           "done": done, "towers": towers}
    return launches, report, paths, ctx


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes4", default="250,98304,1048576",
                    help="d + 1 of the MNT4753 full-size proves (the challenge's size is "
                         "2^20; 98304 = 2^16 + 2^15 takes a step domain, 250 a geometric "
                         "sequence domain, whose exact set-up is O(n^2))")
    ap.add_argument("--sizes6", default="24576,32768,819200",
                    help="d + 1 of the MNT6753 full-size proves (the challenge's size is "
                         "32768; 24576 = 2^14 + 2^13 takes a step domain; 819200 = 25 * 2^15 "
                         "is the largest domain of its scalar field)")
    ap.add_argument("--keygen4", type=int, default=1 << 17,
                    help="d + 1 of the MNT4753 key generation and groth16 phase (a power of "
                         "two; the reference's default is 2^20, which the challenge prove "
                         "at --sizes4's 2^20 keeps on the path)")
    ap.add_argument("--keygen6", type=int, default=1 << 15,
                    help="d + 1 of the MNT6753 key generation (a power of two; the "
                         "reference's default is 2^15)")
    ap.add_argument("--bacs-gates", type=int, default=1 << 14,
                    help="gates of the BACS circuit proved on MNT4753 (0: no bacs phase)")
    ap.add_argument("--gm17-4", type=int, default=1 << 16,
                    help="d + 1 of the MNT4753 gm17 phase's example, one of its own drawn from "
                         "the seed (a power of two; its SAP domain is twice that; --keygen4's "
                         "value takes the key generation's example; 0: no gm17 phase on "
                         "MNT4753); MNT6753's runs on its key generation's example")
    ap.add_argument("--pghr13-4", type=int, default=1 << 16,
                    help="d + 1 of the MNT4753 pghr13 phase's example, one of its own drawn "
                         "from the seed (a power of two; --keygen4's value takes the key "
                         "generation's example; 0: no pghr13 phase on MNT4753); MNT6753's "
                         "runs on its key generation's example")
    ap.add_argument("--adsnark4", default="65536,16",
                    help="d + 1 and authenticated inputs of the MNT4753 adsnark phase's "
                         "example (d + 1 - inputs - 1 constraints, a QAP domain of d + 1, a "
                         "power of two; 0: no adsnark phase)")
    ap.add_argument("--adsnark6", default="32768,8",
                    help="the same on MNT6753 (0: no adsnark phase)")
    ap.add_argument("--ram4", type=int, default=1 << 16,
                    help="the QAP domain that the MNT4753 ram phase's circuit fills (a power "
                         "of two, at least 2^16: its program runs about 85 steps; 0: no ram "
                         "phase; its circuit is over MNT4753's Fr alone)")
    ap.add_argument("--tbcs4", default="31744,1024,32,1024",
                    help="gates, inputs, primary inputs and outputs of the TBCS circuit proved "
                         "on MNT4753 (2 gates + inputs + outputs USCS constraints: 2^16 by "
                         "default; 0: no tbcs phase)")
    ap.add_argument("--tbcs6", default="16128,256,8,256",
                    help="the same on MNT6753 (2^15 constraints by default, its scalar "
                         "field's largest radix-2 domain; 0: no tbcs phase)")
    ap.add_argument("--towers", type=int, default=4099,
                    help="lanes of the towers check on each curve, before its kernel "
                         "comparisons (the GT tower, its Frobenius maps and G2 mul_by_q "
                         "against exact host values; 0: no towers check)")
    ap.add_argument("--pcd", type=int, default=2,
                    help="recursive steps of the pcd phase after the base case: a chain of "
                         "--pcd + 1 proofs alternating MNT4753 and MNT6753, after both curves' "
                         "phases (needs both curves; 0: no pcd phase)")
    ap.add_argument("--mp-pcd", type=int, default=1,
                    help="1: the mp_pcd phase after the pcd chain (the multi-predicate base case "
                         "on MNT4753 over two predicates, and the recursive step on MNT6753 at "
                         "a QAP of 409600; needs both curves; 0: no mp_pcd phase)")
    ap.add_argument("--ram-zksnark", type=int, default=2,
                    help="tape words of the ram_zksnark phase's program on MNT4753 (w = k = 16, "
                         "a memory of 32 words; 1 to 16: more words, more steps; 0: no "
                         "ram_zksnark phase)")
    ap.add_argument("--fixnum", type=int, default=1 << 20,
                    help="n of each of the two chunks of the fixnum stream (n / 2 products a "
                         "curve a chunk; even; needs both curves; 0: no fixnum phase)")
    ap.add_argument("--pedersen", type=int, default=32,
                    help="messages of 2048 bits in the pedersen phase's batch hash, over "
                         "MNT6753's G1 (at least 2; 0: no pedersen phase)")
    ap.add_argument("--caml4", type=int, default=1 << 15,
                    help="num_constraints + num_inputs + 1 of the MNT4753 circuit of the caml "
                         "phase, built through the camlsnark_* C ABI (2 inputs; 0: none)")
    ap.add_argument("--caml6", type=int, default=1 << 10,
                    help="the same on MNT6753 (0: none)")
    ap.add_argument("--polynomial", type=int, default=1 << 19,
                    help="coefficients of each factor of the polynomial phase's product over "
                         "MNT4753's Fr (a domain of twice that; 0: no polynomial phase)")
    ap.add_argument("--functions", type=int, default=1 << 14,
                    help="lanes of the functions phase (modexp, modinv, quorem, divexact, "
                         "chinese on MNT4753; 0: no functions phase)")
    ap.add_argument("--curves", default="MNT4753,MNT6753",
                    help="curves to drive; the default is both, as a full smoke needs")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    curves = args.curves.split(",")
    if not curves or any(c not in MODELS for c in curves):
        raise SystemExit(f"--curves takes a comma-separated subset of {', '.join(MODELS)}")
    for flag, value in (("--pcd", args.pcd), ("--mp-pcd", args.mp_pcd), ("--fixnum", args.fixnum)):
        if value and set(curves) != set(MODELS):
            raise SystemExit(f"{flag} needs both curves ({flag} 0 skips the phase)")
    if args.ram_zksnark and ("MNT4753" not in curves or not 1 <= args.ram_zksnark <= 16):
        raise SystemExit("--ram-zksnark takes 0 or 1 to 16 tape words, and needs MNT4753")
    if args.pedersen and ("MNT6753" not in curves or args.pedersen < 2):
        raise SystemExit("--pedersen takes 0 or at least 2 messages, and needs MNT6753")
    if args.fixnum % 2:
        raise SystemExit("--fixnum takes an even n")
    args.caml = {"MNT4753": args.caml4, "MNT6753": args.caml6}
    for curve, n in args.caml.items():
        if n and (n < 8 or curve not in curves):
            raise SystemExit("--caml4/--caml6 take 0 or at least 8, and need their curve")
    if (args.polynomial or args.functions) and "MNT4753" not in curves:
        raise SystemExit("--polynomial and --functions need MNT4753")
    sizes = {"MNT4753": sorted(int(v) for v in args.sizes4.split(",")),  # int() refuses ""
             "MNT6753": sorted(int(v) for v in args.sizes6.split(","))}
    if any(n < 8 for v in sizes.values() for n in v):
        raise SystemExit("full-size proves need d + 1 >= 8")
    args.keygen = {"MNT4753": args.keygen4, "MNT6753": args.keygen6}
    if any(n < 8 or n & (n - 1) for n in args.keygen.values()):
        raise SystemExit("key generation needs d + 1 a power of two, at least 8")
    args.gm17 = {"MNT4753": args.gm17_4, "MNT6753": args.keygen6}
    args.pghr13 = {"MNT4753": args.pghr13_4, "MNT6753": args.keygen6}
    for flag, n in (("--gm17-4", args.gm17_4), ("--pghr13-4", args.pghr13_4)):
        if n and (n < 8 or n & (n - 1)):
            raise SystemExit(f"{flag} takes 0 or a power of two, at least 8")
    if args.ram4 and args.ram4 & (args.ram4 - 1):
        raise SystemExit("--ram4 takes 0 or a power of two")
    args.adsnark = {"MNT4753": args.adsnark4, "MNT6753": args.adsnark6}
    for curve, spec in args.adsnark.items():
        nl = tuple(int(v) for v in spec.split(","))  # d + 1, inputs
        if nl == (0,):
            args.adsnark[curve] = None
        elif len(nl) != 2 or nl[0] < 8 or nl[0] & (nl[0] - 1) or not 1 <= nl[1] <= nl[0] - 3:
            raise SystemExit("--adsnark4/--adsnark6 take 0 or d + 1 (a power of two, at least 8) "
                             "and the inputs (1 to d - 2)")
        else:
            args.adsnark[curve] = nl
    args.tbcs = {"MNT4753": args.tbcs4, "MNT6753": args.tbcs6}
    for curve, spec in args.tbcs.items():
        gips = tuple(int(v) for v in spec.split(","))  # gates, inputs, primary, outputs
        if gips == (0,):
            args.tbcs[curve] = None
        elif len(gips) != 4 or not (0 < gips[2] <= gips[1] and 0 < gips[3] <= gips[0] - 16):
            raise SystemExit("--tbcs4/--tbcs6 take 0 or gates, inputs, primary inputs (1 to "
                             "inputs) and outputs (1 to gates - 16)")
        else:
            args.tbcs[curve] = gips

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    errs, results = {}, {}
    workers = min(8, os.cpu_count() or 1)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        # host processes for the Lagrange basis of the checks, their longest host work;
        # they start, and import this script, while nvcc builds the kernels
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            for _ in range(workers):
                pool.submit(os.getpid)
            # the caml phase's library builds with g++ beside nvcc
            t0 = time.perf_counter()
            with ThreadPoolExecutor(1) as gxx:
                caml_lib = gxx.submit(caml_ffi.build) if any(args.caml.values()) else None
                libs = _build.build_all()
                if caml_lib is not None:
                    caml_lib.result()
            emit("build", seconds=_build.build_seconds, with_caml_library=time.perf_counter() - t0,
                 ptxas=[ln.strip() for ln in _build.build_log.splitlines()
                        if "Compiling entry" in ln or "Function properties" in ln or "Used" in ln
                        or ("stack frame" in ln and not ln.strip().startswith("0 bytes"))])
            for stem in ("ec_add", "ec_dbl"):
                emit("sass", **sass_counts(libs[stem]))
            for curve in curves:
                results[curve] = run_curve(curve, sizes[curve], args, workdir, errs, pool)
            contexts = {c: r[3] for c, r in results.items()}
            chain_steps = pcd_phase(contexts, args.pcd, args.seed, errs, pool) if args.pcd else []
            # the paths after the chain: kernel entries by path
            later = {}
            if args.mp_pcd:
                later["mp_pcd"] = mp_pcd_phase(contexts, args.seed, errs, pool)
            if args.ram_zksnark:
                later["ram_zksnark"] = ram_zksnark_phase(contexts["MNT4753"], args.ram_zksnark,
                                                         args.seed, errs, pool)
            if args.fixnum:
                later["fixnum"] = fixnum_phase(contexts, args.fixnum, args.seed, workdir, errs,
                                               pool)
            if args.pedersen:
                later["pedersen"] = pedersen_phase(contexts["MNT6753"], args.pedersen, args.seed,
                                                   errs, pool)
            if any(args.caml.values()):
                later["caml"] = caml_phase(contexts, args.caml, args.seed, errs, pool)
            if args.polynomial:
                later["polynomial"] = polynomial_phase(contexts["MNT4753"], args.polynomial,
                                                       args.seed, errs, pool)
            if args.functions:
                later["functions"] = functions_phase(contexts["MNT4753"], args.functions,
                                                     args.seed, errs, pool)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # one entry per kernel: its numbers from the first curve whose path runs it,
    # and under "also" those of a later curve that runs it with other moduli and lanes;
    # under "keygen", "groth16", "gm17", "pghr13", "adsnark", "ram" and "tbcs" its
    # numbers on each curve's key generation and on its blinded Groth16, GM17,
    # PGHR13, ADSNARK, RAM and TBCS proves; under "towers" the towers check's
    # launches and times (mont_mul alone), under "pcd" each chain step's prove;
    # under "mp_pcd", "ram_zksnark", "fixnum", "pedersen", "caml", "polynomial" and
    # "functions" those phases' runs
    kernels = {}
    for curve, (launches, report, paths, ctx) in results.items():
        for name, r in report.items():
            entry = {"curve": curve, "launches": launches[name], **r}
            if name in kernels:
                kernels[name].setdefault("also", []).append(entry)
            else:
                source, replaces, _, _ = KERNELS[name]
                kernels[name] = {"name": name, "route": "cuda", "source": source,
                                 "replaces": replaces, "max_abs_err": errs[name],
                                 "library_ms": None, **entry}
            for key, (path_launches, path_report, size) in paths.items():
                kernels[name].setdefault(key, []).append(
                    {"curve": curve, **size, "launches": path_launches[name], **path_report[name]})
            if args.towers:
                kernels[name].setdefault("towers", []).append(
                    {"curve": curve, "lanes": args.towers, "launches": 0,
                     **ctx["towers"].get(name, {})})
    for step in chain_steps:
        for name, r in step["report"].items():
            kernels[name].setdefault("pcd", []).append(
                {"curve": step["curve"], "step": step["step"], "qap_domain": step["qap_domain"],
                 "launches": step["launches"][name], **r})
    for key, entries in later.items():
        for e in entries:
            for name, r in e["report"].items():
                kernels[name].setdefault(key, []).append(
                    {"curve": e["curve"], **e["size"], "launches": e["launches"][name], **r})
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
