"""Command-line prover: drop-in equivalent of the reference binary
(libsnark/main.cpp:274-295):

    python -m snark_challenge_prover_tpu_torch.cli MNT4753 compute \
        MNT4753-parameters MNT4753-input MNT4753-output [--device cpu]
    python -m snark_challenge_prover_tpu_torch.cli MNT6753 compute \
        MNT6753-parameters MNT6753-input MNT6753-output [--device cpu]

Prints the same coarse phase timings ("load params", "load inputs",
"cpu", "store", total) as main.cpp:201-270.  Runs on the GPU; the CPU is
used only with ``--device cpu``.
"""

from __future__ import annotations

import sys
import time

CURVES = ("MNT4753", "MNT6753")
USAGE = "usage: cli.py MNT4753|MNT6753 compute <params> <input> <output> [--device cuda|cpu]"


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print(USAGE, file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) != 5 or argv[1] != "compute":
        print(USAGE, file=sys.stderr)
        return 2
    curve, _, params_path, input_path, output_path = argv
    if curve not in CURVES:
        print(f"unknown curve {curve} (one of {', '.join(CURVES)})", file=sys.stderr)
        return 2

    import torch

    from .io import serialization as ser
    from .models import mnt4753, mnt6753
    from .proof_systems.groth16 import ChallengeProver

    t_start = time.perf_counter()
    t = t_start

    def print_time(label):
        nonlocal t
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)  # the label's device work is done
        t2 = time.perf_counter()
        print(f"{label}: {int((t2 - t) * 1000)} ms")
        t = t2

    model = {"MNT4753": mnt4753, "MNT6753": mnt6753}[curve].get(device)
    prover = ChallengeProver(model)
    params = prover.read_params(params_path)  # straight onto the card on a CUDA model
    print_time("load params")
    inp = prover.read_input(input_path, params.d, params.m)
    print_time("load inputs")

    proof = prover.prove_arrays(params, inp)
    print_time("cpu")

    ser.write_proof(output_path, *proof)
    print_time("store")
    print(f"Total time from input to output: {int((time.perf_counter() - t_start) * 1000)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
