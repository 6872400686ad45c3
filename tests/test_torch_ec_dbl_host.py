"""The doubling kernel's own source, run on the CPU.

``csrc/ec_dbl.cu`` (over ``csrc/fp753_fast.cuh``) is built for the host
with g++, the CUDA keywords defined away and the carry flag of the PTX
chains kept in a variable, and run against ``ec_dbl_plain`` for all four
compiled curve groups, for k = 1, 2, 3, 7, 12 (the window size of the
MNT6753 2^15 prove) and the window size c of the curve's largest challenge
prove.  The kernel's stages run for the warp's threads 0..31 in order,
stage after stage, on shared slots filled with a pattern beforehand (so
that a slot read before it is written shows).  The lanes: the identity (0, 1, 0), (0, y, 0) with
y != 1, Y = 0 (which the first doubling maps to (0, -w^3, 0)), every
coordinate p - 1, Z = p - 1 and X = Y = p - 1, then random ones."""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import cuda_group, msm
from snark_challenge_prover_tpu_torch.utils.bigint import ints_to_words

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

CSRC = Path(cuda_group.__file__).resolve().parent.parent / "csrc"
N = 10
# the window size of each curve's largest challenge prove (d + 1 = 2^20 and 819200)
C_LARGEST = {"MNT4753": msm.default_window_bits(1 << 20), "MNT6753": msm.default_window_bits(819200)}

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
struct Dim { long x; };
static Dim blockIdx{0}, threadIdx{0};
#define __global__
#define __launch_bounds__(...)
#define __shared__
#define __syncwarp()
#include "ec_dbl.cu"

template <class M, int D, int NR, int A_K, int A_S>
static void run(long n, int k, FILE* in, FILE* out)
{
    using C = DblCurve<M, D, NR, A_K, A_S>;
    std::vector<u32> a[3], r[3];
    for (auto& v : a) {
        v.resize((size_t)D * NW * n);
        if (fread(v.data(), 4, v.size(), in) != v.size()) exit(2);
    }
    for (auto& v : r) v.assign((size_t)D * NW * n, 0);
    // ec_dbl_warp_kernel with its 32 threads run one after another between
    // two synchronisations
    auto* sh = new DblSlots<C>;
    for (long idx = 0; idx < n; idx++) {
        memset((void*)sh, 0xa5, sizeof *sh);
        for (int t = 0; t < WARP; t++) warp_load<C>(*sh, a[0].data(), a[1].data(), a[2].data(), n, idx, t);
        for (int i = 0; i < k; i++)
            for (int stage = 0; stage < DBL_STAGES; stage++)
                for (int t = 0; t < WARP; t++) dbl_stage<C>(*sh, stage, t);
        for (int t = 0; t < WARP; t++) warp_store<C>(*sh, r[0].data(), r[1].data(), r[2].data(), n, idx, t);
    }
    delete sh;
    for (auto& v : r) fwrite(v.data(), 4, v.size(), out);
}

int main(int argc, char** argv)
{
    const std::string which = argv[1];  // a launcher's name without "_launch"
    const long n = atol(argv[2]);
    const int k = atoi(argv[3]);
    FILE* in = fopen(argv[4], "rb");
    FILE* out = fopen(argv[5], "wb");
#define RUN(name, ...) if (which == #name) run<__VA_ARGS__>(n, k, in, out); else
    EC_DBL_INSTANTIATIONS(RUN) return 3;
    fclose(out);
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("ec_dbl_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    # -O2 with strict aliasing, as nvcc's -O3 builds the device code, and a
    # type-punning warning fails the build
    subprocess.run([gxx, "-std=c++17", "-O2", "-Werror=strict-aliasing", "-Wno-unknown-pragmas",
                    "-I", str(CSRC), "-o", str(exe), str(d / "harness.cpp")], check=True,
                   capture_output=True)
    return exe


def _coordinate(p: int, deg: int, vals) -> torch.Tensor:
    """Lane i holds vals[i] (an int for every component, or a tuple of deg ints)."""
    flat = [c for v in vals for c in (v if isinstance(v, tuple) else (v,) * deg)]
    t = torch.from_numpy(ints_to_words(flat)).reshape(24, len(vals), deg).permute(2, 0, 1)
    return t[0].contiguous() if deg == 1 else t.contiguous()


def _edge_points(p: int, deg: int, rng):
    """Lanes 0..5: the identity (0, 1, 0); (0, y, 0) with y != 1; Y = 0;
    every coordinate p - 1; Z = p - 1; X = Y = p - 1.  The others random."""
    one = ((1 << 768) % p,) + (0,) * (deg - 1)  # Montgomery form
    r = lambda: tuple(rng.randrange(p) for _ in range(deg))
    X = [0, 0, r(), p - 1, r(), p - 1] + [r() for _ in range(N - 6)]
    Y = [one, r(), 0, p - 1, r(), p - 1] + [r() for _ in range(N - 6)]
    Z = [0, 0, r(), p - 1, p - 1, r()] + [r() for _ in range(N - 6)]
    return tuple(_coordinate(p, deg, v) for v in (X, Y, Z))


@pytest.fixture(scope="module", params=[("MNT4753", "G1"), ("MNT4753", "G2"),
                                        ("MNT6753", "G1"), ("MNT6753", "G2")],
                ids=lambda g: "-".join(g))
def group(request):
    name, grp = request.param
    model = {"MNT4753": mnt4753, "MNT6753": mnt6753}[name].get("cpu")
    curve = getattr(model, grp)
    P = _edge_points(model.Fq.p, curve.deg, random.Random(f"{name} {grp}"))
    # the plain version's doublings, once for every k the tests ask for
    c = C_LARGEST[name]
    want, Q = {}, P
    for k in range(1, c + 1):
        Q = cuda_group.ec_dbl_plain(curve, Q)
        want[k] = Q
    assert torch.equal(cuda_group.ec_dbl_plain(curve, P, 3)[1], want[3][1])
    return name, curve, P, want


@pytest.mark.parametrize("times", [1, 2, 3, 7, 12, "c"])
def test_kernel_source_matches_plain_version(harness, tmp_path, group, times):
    name, curve, P, want = group
    k = C_LARGEST[name] if times == "c" else times
    deg = curve.deg
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(b"".join(t.numpy().tobytes() for t in P))
    launcher = cuda_group.dbl_kernel(curve).launcher
    subprocess.run([str(harness), launcher, str(N), str(k), str(src), str(dst)],
                   check=True, timeout=120)
    got = np.fromfile(dst, dtype=np.int32).reshape(3, deg * 24, N)
    for g, w in zip(got, want[k]):
        np.testing.assert_array_equal(g, w.reshape(deg * 24, N).numpy())
    # the identity and (0, y, 0) are kept; Y = 0 became a point with X = Z = 0
    ident = curve.is_zero(tuple(torch.from_numpy(g).reshape(w.shape) for g, w in zip(got, P)))
    assert ident[:3].tolist() == [True, True, True]
    assert torch.equal(torch.from_numpy(got[1]).reshape(P[1].shape)[..., :2], P[1][..., :2])
