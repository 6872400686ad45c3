"""The addition kernel's own source, run on the CPU.

``csrc/ec_add.cu`` (over ``csrc/fp753_fast.cuh``) is built for the host
with g++, ``__global__`` and ``__launch_bounds__`` defined away and the
carry flag of the PTX chains kept in a variable, and run lane by lane
against ``ec_add_plain`` for all four compiled curve groups: the same
lazy bounds, conditional subtracts, chains and curve constants as on the
card.  Besides random lanes: every coordinate p - 1 (the largest
Karatsuba sums), both Z = p - 1, and lanes of 0, 1 and p - 2 mixed in,
where a wrong lazy bound would show."""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import cuda_group
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

CSRC = Path(cuda_group.__file__).resolve().parent.parent / "csrc"
N = 48

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
struct Dim { long x; };
static Dim blockIdx{0}, blockDim{1}, threadIdx{0};
#define __global__
#define __launch_bounds__(...)
#include "ec_add.cu"

template <class M, int D, int NR, int A_K, int A_S, int B3_S>
static void run(long n, FILE* in, FILE* out)
{
    std::vector<u32> a[6], r[3], cst(32 + 3 * D * NW);
    for (auto& v : a) {
        v.resize((size_t)D * NW * n);
        if (fread(v.data(), 4, v.size(), in) != v.size()) exit(2);
    }
    if (fread(cst.data(), 4, cst.size(), in) != cst.size()) exit(2);
    for (auto& v : r) v.assign((size_t)D * NW * n, 0);
    for (blockIdx.x = 0; blockIdx.x < n; blockIdx.x++)
        ec_add_kernel<M, D, NR, A_K, A_S, B3_S>(a[0].data(), a[1].data(), a[2].data(), a[3].data(),
                                                a[4].data(), a[5].data(), r[0].data(), r[1].data(),
                                                r[2].data(), n, cst.data());
    for (auto& v : r) fwrite(v.data(), 4, v.size(), out);
}

int main(int argc, char** argv)
{
    const std::string which = argv[1];  // a launcher's name without "_launch"
    const long n = atol(argv[2]);
    FILE* in = fopen(argv[3], "rb");
    FILE* out = fopen(argv[4], "wb");
#define RUN(name, ...) if (which == #name) run<__VA_ARGS__>(n, in, out); else
    EC_ADD_INSTANTIATIONS(RUN) return 3;
    fclose(out);
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("ec_add_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    # -O2 with strict aliasing, as nvcc's -O3 builds the device code, and a
    # type-punning warning fails the build
    subprocess.run([gxx, "-std=c++17", "-O2", "-Werror=strict-aliasing", "-Wno-unknown-pragmas",
                    "-I", str(CSRC), "-o", str(exe), str(d / "harness.cpp")], check=True,
                   capture_output=True)
    return exe


def _lanes(p: int, deg: int, kinds, rng) -> torch.Tensor:
    """One coordinate: lane i is p - 1, 0, 1, p - 2 or random in every component."""
    fixed = {0: p - 1, 1: 0, 2: 1, 3: p - 2}
    vals = [fixed.get(k, None) for k in kinds]
    flat = [v if v is not None else rng.randrange(p) for v in vals for _ in range(deg)]
    t = torch.from_numpy(ints_to_words(flat)).reshape(24, len(kinds), deg).permute(2, 0, 1)
    return t[0].contiguous() if deg == 1 else t.contiguous()


@pytest.mark.parametrize("name,group", [("MNT4753", "G1"), ("MNT4753", "G2"),
                                        ("MNT6753", "G1"), ("MNT6753", "G2")])
def test_kernel_source_matches_plain_version(harness, tmp_path, name, group):
    model = {"MNT4753": mnt4753, "MNT6753": mnt6753}[name].get("cpu")
    curve = getattr(model, group)
    launcher = cuda_group.add_kernel(curve).launcher
    rng = random.Random(f"{name} {group}")
    p, deg = model.Fq.p, curve.deg
    # lane 0: every coordinate p - 1; lane 1: P all p - 1; lanes 2..: mixed
    kinds = [0, 0] + [rng.choice([0, 1, 2, 3, 9, 9, 9]) for _ in range(N - 2)]
    P = [_lanes(p, deg, kinds, rng) for _ in range(3)]
    Q = [_lanes(p, deg, [0] + [9] * (N - 1), rng) for _ in range(3)]
    for T in (P, Q):  # lane 2: both Z = p - 1
        T[2][..., 2] = _lanes(p, deg, [0], rng)[..., 0]
    want = cuda_group.ec_add_plain(curve, tuple(P), tuple(Q))

    consts = torch.zeros(32 + 3 * deg * 24, dtype=torch.int32)
    consts[: curve.kconst.numel()] = curve.kconst
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(b"".join(t.numpy().tobytes() for t in (*P, *Q, consts)))
    subprocess.run([str(harness), launcher, str(N), str(src), str(dst)], check=True, timeout=120)
    got = np.fromfile(dst, dtype=np.int32).reshape(3, deg * 24, N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.reshape(deg * 24, N).numpy())
