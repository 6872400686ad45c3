"""Stage-1 field-arithmetic stream: the counterpart of the JAX package's
``cli_fixnum.py`` (the cuda-fixnum bridge binary, cuda-fixnum/main.cu:129-193
do_fixnum_example).

    python -m snark_challenge_prover_tpu_torch.cli_fixnum <inputs> <outputs> [--device cuda|cpu]

Stream format (the reference's): repeat until EOF
    size_t n
    n/2 Fq(MNT4753) elements x0, n/2 elements x1   (96-byte Montgomery LE)
    n/2 Fq(MNT6753) elements y0, n/2 elements y1
and for each chunk write the n/2 Montgomery products x0[i] * x1[i] mod q4,
then the n/2 products y0[i] * y1[i] mod q6.  A chunk's two halves are read
with ``io/serialization.Reader``, copied to the device as one word tensor
each, multiplied by ``Fp.mul`` (the Montgomery kernel on the card) and
written back.  Runs on the GPU; the CPU is used only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .io import serialization as ser


def mul_block(F, data: bytes, half: int) -> bytes:
    """The first ``half`` elements of ``data`` times the next ``half``,
    elementwise in Montgomery form: ``half`` * 96 bytes."""
    reader = ser.Reader(data)
    a, b = (torch.from_numpy(reader.fq_block(half)).to(F.device) for _ in range(2))
    return ser.words_to_bytes(F.mul(a, b).cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Montgomery products over q(MNT4753), then "
                                             "q(MNT6753), one chunk of the stream at a time")
    ap.add_argument("inputs")
    ap.add_argument("outputs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .models import mnt4753, mnt6753

    fields = (mnt4753.get(args.device).Fq, mnt6753.get(args.device).Fq)
    with open(args.inputs, "rb") as f, open(args.outputs, "wb") as out:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            half = ser.Reader(hdr).size_t() // 2
            for F in fields:
                out.write(mul_block(F, f.read(2 * half * ser.FQ_BYTES), half))
    return 0


if __name__ == "__main__":
    sys.exit(main())
