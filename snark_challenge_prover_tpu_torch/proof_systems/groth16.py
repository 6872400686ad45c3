"""Groth16 challenge-prover pipeline (libsnark/main.cpp:188-272):

    H      = compute_H(d, ca, cb, cc)          # 7 FFT passes + pointwise
    At     = MSM_G1(w,         A[0..m])
    Bt1    = MSM_G1(w,         B1[0..m])
    Bt2    = MSM_G2(w,         B2[0..m])
    Ht     = MSM_G1(H[0..d-1], H_query[0..d-1])
    Lt     = MSM_G1(w[2..],    L[0..m-2])       # primary_input_size == 1
    C      = Ht + Lt + r * Bt1
    proof  = (At affine, Bt2 affine, C affine)  # 96-byte Montgomery LE

The FFT stack (``reductions.r1cs_to_qap.quotient_coefficients``), the four
G1 MSMs (one batched staged MSM) and the G2 MSM (``groth16_msms``, which
the blinded prover of ``groth16_full`` shares) run on the model's device.
The O(1) tail (C, affine conversion, byte packing) runs on host exact
integers: affine coordinates are the unique canonical representatives
either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.curves import host_curve
from ..io import serialization as ser
from ..ops import msm as msm_mod
from ..ops.fft import get_evaluation_domain
from ..reductions.r1cs_to_qap import quotient_coefficients
from ..utils.bigint import int_to_words, words_to_ints
from ..utils.profiling import Profiler


def compute_h(model, domain, ca, cb, cc):
    """The FFT dance (main.cpp:105-163): evaluations of A, B, C on the
    domain -> coefficients of the quotient H, shape (24, d+1), of which
    the prover consumes the first d (main.cpp:243)."""
    return quotient_coefficients(model.Fr, domain, ca, cb, cc)


def _first_int(spec, words: torch.Tensor) -> int:
    """The first element of a (24, ...) Montgomery tensor as a canonical int."""
    w = words.reshape(24, -1)[:, :1].cpu().numpy()
    return spec.from_mont(words_to_ints(w)[0])


def _g1_proj_to_host(model, P):
    """Projective Montgomery point (one element) -> host affine ints / None."""
    q = model.Fq.p
    X, Y, Z = (_first_int(model.Fq.spec, t) for t in P)
    if Z == 0:
        return None
    zi = pow(Z, -1, q)
    return (X * zi % q, Y * zi % q)


def _g2_proj_to_host(model, P):
    spec = model.Fq.spec
    X, Y, Z = (tuple(_first_int(spec, comp) for comp in t) for t in P)
    F = host_curve(model.name).g2.F
    if F.is_zero(Z):
        return None
    zi = F.inv(Z)
    return (F.mul(X, zi), F.mul(Y, zi))


def query_point(model, pair, i: int):
    """Entry i of a stored affine query ((x, y) Montgomery words, each
    (24, N) or (deg, 24, N)) -> host affine integers; y = 0 stores the
    identity, which gives None."""
    spec = model.Fq.spec
    x, y = (t[..., i].reshape(-1, 24).T.cpu().numpy() for t in pair)
    if not y.any():
        return None
    xs, ys = ([spec.from_mont(v) for v in words_to_ints(c)] for c in (x, y))
    return (xs[0], ys[0]) if len(xs) == 1 else (tuple(xs), tuple(ys))


def groth16_msms(model, A, B1, B2, H, L, w_can, h_can, num_inputs: int,
                 msm_window: int | None, prof: Profiler):
    """The five MSMs of a Groth16 prove on the model's device: the four G1
    MSMs (A, B1 and H over w, H over the quotient's coefficients, L over
    the auxiliary part of w) as one staged multi-MSM, then the G2 MSM (B2
    over w).  A, B1, B2, H, L: affine (x, y) Montgomery query words; w_can
    = (1, assignment) and h_can = H[:, :n - 1], canonical words.  Phases
    "G1 multiexp x4" and "G2 multiexp".  Returns the projective results,
    batch (4,) in the order A, B1, H, L, and batch ()."""
    G1, G2 = model.G1, model.G2
    prof.enter_block("G1 multiexp x4")
    pts4, scal4 = msm_mod.pad_and_stack(
        G1, [G1.from_affine(x, y) for x, y in (A, B1, H, L)],
        [w_can, w_can, h_can, w_can[:, num_inputs + 1 :]])
    g1_res = msm_mod.msm_multi_staged(G1, pts4, scal4, msm_window)
    del pts4, scal4
    prof.leave_block("G1 multiexp x4")
    prof.enter_block("G2 multiexp")
    g2_res = msm_mod.msm_staged(G2, G2.from_affine(*B2), w_can, msm_window)
    prof.leave_block("G2 multiexp")
    return g1_res, g2_res


def msm_results_to_host(model, g1_res, g2_res):
    """``groth16_msms``'s results -> host affine (At, Bt1, Ht, Lt, Bt2)."""
    At, Bt1, Ht, Lt = (_g1_proj_to_host(model, tuple(t[..., i] for t in g1_res))
                       for i in range(4))
    return At, Bt1, Ht, Lt, _g2_proj_to_host(model, g2_res)


def g1_words(model, P):
    """Host affine G1 point (None: the identity) -> (x, y, z) Montgomery words."""
    if P is None:
        z = np.zeros(24, np.int32)
        return (z, z, z)
    to_mont = model.Fq.spec.to_mont
    return tuple(int_to_words(to_mont(v)) for v in (P[0], P[1], 1))


def g2_words(model, P):
    """Host affine G2 point -> (x, y, z), each (deg, 24) Montgomery words."""
    deg = model.g2_deg
    if P is None:
        z = np.zeros((deg, 24), np.int32)
        return (z, z, z)
    to_mont = model.Fq.spec.to_mont
    one = (1,) + (0,) * (deg - 1)
    return tuple(np.stack([int_to_words(to_mont(c)) for c in t]) for t in (P[0], P[1], one))


class ChallengeProver:
    """One curve's challenge prover on the model's device."""

    def __init__(self, model, msm_window: int | None = None, verbose: bool = True):
        self.model = model
        self.msm_window = msm_window
        self.profiler = Profiler(model.device, verbose)
        # a CUDA model reads its files straight onto the card, the CPU through numpy
        self._reader = ser.DeviceReader(model.device) if model.device.type == "cuda" else None

    def read_params(self, path) -> ser.Groth16Params:
        """The params file as word arrays on the model's device."""
        if self._reader is None:
            return ser.read_params(path, self.model.g2_deg)
        return self._reader.read_params(path, self.model.g2_deg)

    def read_input(self, path, d: int, m: int) -> ser.Groth16Input:
        """The input file as word arrays on the model's device."""
        if self._reader is None:
            return ser.read_input(path, d, m)
        return self._reader.read_input(path, d, m)

    def prove_files(self, params_path, input_path, output_path=None) -> bytes:
        """File -> file pipeline, matching `main <CURVE> compute`
        (main.cpp:274-295); returns the proof bytes.  On a CUDA model the
        load phases include the copy to the card and the unpacking there
        (each phase ends in a synchronize), so "compute H" and the MSM
        phases start with their inputs on the card."""
        prof = self.profiler
        prof.enter_block("load params")
        params = self.read_params(params_path)
        prof.leave_block("load params")
        prof.enter_block("load inputs")
        inp = self.read_input(input_path, params.d, params.m)
        prof.leave_block("load inputs")
        proof = self.prove_arrays(params, inp)
        prof.enter_block("store")
        data = ser.write_proof(output_path, *proof)
        prof.leave_block("store")
        return data

    def prove_arrays(self, params: ser.Groth16Params, inp: ser.Groth16Input):
        """Word arrays (tensors on the model's device, or host arrays, which
        are copied there) -> affine proof (A, B, C) as host word arrays."""
        model = self.model
        prof = self.profiler
        Fr = model.Fr
        d = params.d
        dev = model.device

        def up(arr):
            if isinstance(arr, torch.Tensor):
                if arr.device != dev:
                    raise ValueError(f"words on {arr.device}, model on {dev}")
                return arr
            return torch.from_numpy(arr).to(dev)

        prof.enter_block("compute H")
        domain = get_evaluation_domain(Fr, d + 1)
        h = compute_h(model, domain, up(inp.ca), up(inp.cb), up(inp.cc))
        h_can = Fr.to_canonical(h[:, :d])
        w_can = Fr.to_canonical(up(inp.w))
        del h, domain
        prof.leave_block("compute H")

        g1_res, g2_res = groth16_msms(
            model, *((up(x), up(y)) for x, y in (params.A, params.B1, params.B2, params.H,
                                                  params.L)),
            w_can, h_can, 1, self.msm_window, prof)  # primary_input_size == 1

        prof.enter_block("assemble proof (host)")
        hc = host_curve(model.name)
        At, Bt1, Ht, Lt, Bt2 = msm_results_to_host(model, g1_res, g2_res)
        r_int = _first_int(Fr.spec, up(inp.r))
        C = hc.g1.add(hc.g1.add(Ht, Lt), hc.g1.mul(r_int, Bt1))
        prof.leave_block("assemble proof (host)")
        return (g1_words(model, At), g2_words(model, Bt2), g1_words(model, C))
