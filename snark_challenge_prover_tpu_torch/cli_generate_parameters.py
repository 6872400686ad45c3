"""Challenge parameter generator: the reference's ``generate_parameters``
(libsnark/generate_parameters.cpp:24-137), counterpart of the JAX
package's ``cli_generate_parameters.py``.

Builds a satisfiable R1CS with d - 1 constraints and one public input,
makes the Groth16 proving key, evaluates A, B and C on the domain, draws
r, and writes ``<curve>-parameters`` and ``<curve>-input`` in the challenge's
wire format.  For the same seed the files are byte for byte the JAX
package's.  Runs on the GPU; the CPU is used only with ``--device cpu``.

    python -m snark_challenge_prover_tpu_torch.cli_generate_parameters [fast]
        [--log2d-mnt4 N] [--log2d-mnt6 N] [--seed S] [--outdir DIR]
        [--curve both|MNT4753|MNT6753] [--device cuda|cpu]

Defaults are the reference's: log2(d + 1) = 20 (MNT4753) and 15 (MNT6753);
``fast`` takes 14 and 10 (generate_parameters.cpp:125-137).
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from .io import serialization as ser
from .ops.field import canonical_words
from .proof_systems.groth16_full import KeySecrets, ProvingKey, proving_key
from .reductions.r1cs_to_qap import assemble_abc_evaluations
from .relations.examples import R1CSExample, generate_r1cs_example_with_field_input
from .utils.profiling import Profiler


class Generated(NamedTuple):
    """What ``generate_for_curve`` made: the two files, and the proving key,
    the secrets ``groth16_full.verification_key`` needs and the example
    (constraint system and assignment), which a caller may go on to prove
    and verify with."""

    params_path: Path
    input_path: Path
    pk: ProvingKey
    secrets: KeySecrets
    example: R1CSExample


def generate_for_curve(model, log2_d: int, rng, outdir: Path,
                       profiler: Profiler | None = None) -> Generated:
    """Writes the two files of d + 1 = 2^log2_d for the model's curve.
    Phases (``profiler``): "example", then those of
    ``groth16_full.proving_key``, then "write".  The files need no
    verification key, so none is made."""
    prof = profiler if profiler is not None else Profiler(model.device)
    Fr = model.Fr
    p = Fr.p
    d = (1 << log2_d) - 1
    prof.enter_block("example")
    ex = generate_r1cs_example_with_field_input(p, d - 1, 1, rng)
    prof.leave_block("example")
    cs = ex.constraint_system
    pk, secrets = proving_key(model, cs, rng, prof)
    m = cs.num_variables
    if m != d + 1:  # d - 1 constraints and one input: m = d + 1 (generate_parameters.cpp:38)
        raise RuntimeError(f"m = {m}, d + 1 = {d + 1} expected")

    prof.enter_block("write")
    params_path = Path(outdir) / f"{model.name}-parameters"
    ser.write_params(params_path, d, m, pk.A_query, pk.B_query_g1, pk.B_query_g2, pk.L_query,
                     pk.H_query)
    # the input file (generate_parameters.cpp:44-57, 86-108): w = (1, assignment),
    # A, B and C on the domain, then r, all in Montgomery form
    aA, aB, aC = assemble_abc_evaluations(cs, ex.primary_input, ex.auxiliary_input, Fr)
    if len(aA) != d + 1:
        raise RuntimeError(f"domain of {len(aA)} points, d + 1 = {d + 1} expected")
    r = rng.randrange(p)
    words = Fr.from_canonical(canonical_words(Fr, [1] + ex.primary_input + ex.auxiliary_input
                                      + aA + aB + aC + [r]))
    ends = [0, m + 1, m + 1 + (d + 1), m + 1 + 2 * (d + 1), m + 1 + 3 * (d + 1), words.shape[1]]
    input_path = Path(outdir) / f"{model.name}-input"
    ser.write_input(input_path, *(words[:, a:b] for a, b in zip(ends, ends[1:])))
    prof.leave_block("write")
    return Generated(params_path, input_path, pk, secrets, ex)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the challenge's parameters and input files.")
    ap.add_argument("mode", nargs="?", default="full", choices=["full", "fast"])
    ap.add_argument("--log2d-mnt4", type=int, default=None)
    ap.add_argument("--log2d-mnt6", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--curve", default="both", choices=["both", "MNT4753", "MNT6753"])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from .models import mnt4753, mnt6753

    log4 = args.log2d_mnt4 or (14 if args.mode == "fast" else 20)
    log6 = args.log2d_mnt6 or (10 if args.mode == "fast" else 15)
    rng = random.Random(args.seed) if args.seed is not None else random.Random()
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    jobs = []  # both curves draw from one generator, MNT4753 first, as the JAX package's do
    if args.curve in ("both", "MNT4753"):
        jobs.append((mnt4753, log4))
    if args.curve in ("both", "MNT6753"):
        jobs.append((mnt6753, log6))
    for module, lg in jobs:
        model = module.get(args.device)
        out = generate_for_curve(model, lg, rng, outdir)
        print(f"{model.name}: wrote {out.params_path} and {out.input_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
