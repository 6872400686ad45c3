"""Groth16 challenge-prover pipeline (libsnark/main.cpp:188-272):

    H      = compute_H(d, ca, cb, cc)          # 7 FFT passes + pointwise
    At     = MSM_G1(w,         A[0..m])
    Bt1    = MSM_G1(w,         B1[0..m])
    Bt2    = MSM_G2(w,         B2[0..m])
    Ht     = MSM_G1(H[0..d-1], H_query[0..d-1])
    Lt     = MSM_G1(w[2..],    L[0..m-2])       # primary_input_size == 1
    C      = Ht + Lt + r * Bt1
    proof  = (At affine, Bt2 affine, C affine)  # 96-byte Montgomery LE

The FFT stack, the four G1 MSMs (one batched staged MSM) and the G2 MSM
run on the model's device.  The O(1) tail (C, affine conversion, byte
packing) runs on host exact integers: affine coordinates are the unique
canonical representatives either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.curves import host_curve
from ..io import serialization as ser
from ..ops import msm as msm_mod
from ..ops.fft import get_evaluation_domain
from ..utils.bigint import int_to_words, words_to_ints
from ..utils.profiling import Profiler


def compute_h(model, domain, ca, cb, cc):
    """The FFT dance (main.cpp:105-163): evaluations of A, B, C on the
    domain -> coefficients of the quotient H, shape (24, d+1), of which
    the prover consumes the first d (main.cpp:243)."""
    F = model.Fr
    a = domain.coset_fft(domain.ifft(ca))
    b = domain.coset_fft(domain.ifft(cb))
    hab = F.mul(a, b)
    del a, b
    h = F.sub(hab, domain.coset_fft(domain.ifft(cc)))
    h = domain.divide_by_z_on_coset(h)
    return domain.icoset_fft(h)


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
        Fr, G1, G2 = model.Fr, model.G1, model.G2
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

        prof.enter_block("G1 multiexp x4")
        pts4, scal4 = msm_mod.pad_and_stack(
            G1,
            [G1.from_affine(up(x), up(y)) for x, y in (params.A, params.B1, params.H, params.L)],
            [w_can, w_can, h_can, w_can[:, 2:]],  # primary_input_size == 1
        )
        g1_res = msm_mod.msm_multi_staged(G1, pts4, scal4, self.msm_window)
        del pts4, scal4
        prof.leave_block("G1 multiexp x4")

        prof.enter_block("G2 multiexp")
        g2_res = msm_mod.msm_staged(
            G2, G2.from_affine(up(params.B2[0]), up(params.B2[1])), w_can, self.msm_window
        )
        prof.leave_block("G2 multiexp")

        prof.enter_block("assemble proof (host)")
        hc = host_curve(model.name)
        At, Bt1, Ht, Lt = (
            _g1_proj_to_host(model, tuple(t[..., i] for t in g1_res)) for i in range(4)
        )
        Bt2 = _g2_proj_to_host(model, g2_res)
        r_int = _first_int(Fr.spec, up(inp.r))
        C = hc.g1.add(hc.g1.add(Ht, Lt), hc.g1.mul(r_int, Bt1))
        prof.leave_block("assemble proof (host)")

        to_mont = model.Fq.spec.to_mont

        def g1_words(P):
            if P is None:
                z = np.zeros(24, np.int32)
                return (z, z, z)
            return tuple(int_to_words(to_mont(v)) for v in (P[0], P[1], 1))

        def g2_words(P):
            deg = model.g2_deg
            if P is None:
                z = np.zeros((deg, 24), np.int32)
                return (z, z, z)
            one = (1,) + (0,) * (deg - 1)
            return tuple(np.stack([int_to_words(to_mont(c)) for c in t]) for t in (P[0], P[1], one))

        return (g1_words(At), g2_words(Bt2), g1_words(C))
