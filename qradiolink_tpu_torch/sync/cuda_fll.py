"""The FLL band-edge loop: wrapper, plain version and the CUDA kernel
`fll_band_edge_f32` (csrc/fll_band_edge.cu).

Not the port of a Pallas kernel: the JAX package runs the loop as a
`lax.scan` over sub-blocks (qradiolink_tpu/sync/fll.py:78-93), its two
band-edge filters FIRs with complex taps. Per row, for each sub-block of
sb samples, in the JAX package's order:

    ph    = phase + freq n                  n = 0 .. sb-1
    y     = x exp(-1j ph)                   plane by plane, (c, s) =
                                            (cos ph, -sin ph)
    U, L  = the upper and lower band-edge FIRs over [tail | y], complex
            taps: (rr - ii, ri + ir) of the four real FIRs
    err   = clip(mean(|U|^2 - |L|^2), -1, 1)
    freq' = clip(freq + beta err, -max_freq, max_freq)
    phase = mod(phase + freq sb, 2 pi);  freq = freq'
    tail  = the last K-1 samples of [tail | y]

On a CPU tensor the wrapper takes the plain version (the loop over the
sub-blocks, about 36 PyTorch ops each, the FIRs as F.conv1d); on a CUDA
tensor it launches the kernel, one warp a row and the whole block in one
launch, or raises. The kernel sums each FIR fmaf in tap order (the plain
loop's F.conv1d sums in the library's order) and the sub-block's
|U|^2 - |L|^2 in its own order (the plain loop leaves that to
torch.mean), so the two agree within a bound, not bit for bit
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from qradiolink_tpu_torch.ops.cuda_fir import fir_stream_plain
from qradiolink_tpu_torch.ops.fir import next_tail
from qradiolink_tpu_torch.sync.cuda_costas import TWO_PI, mod_2pi
from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "fll_band_edge_f32"


def inv_sb(sb: int) -> float:
    """The f32 of 1/sb, computed in f32: PyTorch's CUDA mean multiplies its
    sum by it."""
    return float(np.float32(1.0) / np.float32(sb))


def fll_plain(xr, xi, phase, freq, tail, taps, beta: float, max_freq: float,
              sb: int):
    """Plain PyTorch version: the loop over the sub-blocks of sb samples of
    the planes xr, xi (..., T). taps: (4, K) f32, the flipped upper re,
    upper im, lower re and lower im taps; tail (..., K-1) complex64.
    Returns (y complex64 (..., T), phase, freq, tail)."""
    T = xr.shape[-1]
    k1 = taps.shape[1] - 1
    n = torch.arange(sb, dtype=torch.float32, device=xr.device)
    tr, ti = tail.real.contiguous(), tail.imag.contiguous()
    ys_r, ys_i = [], []

    def band_edge(planes, t_re, t_im):
        (rr, ir), (ri, ii) = (fir_stream_plain(planes, t, 1, sb,
                                               tails=(tr, ti))
                              for t in (t_re, t_im))
        return rr - ii, ri + ir

    for k in range(T // sb):
        ar = xr[..., k * sb:(k + 1) * sb]
        ai = xi[..., k * sb:(k + 1) * sb]
        ph = phase[..., None] + freq[..., None] * n
        c, s = torch.cos(ph), -torch.sin(ph)  # exp(-1j ph)
        yr = ar * c - ai * s
        yi = ar * s + ai * c
        ur, ui = band_edge((yr, yi), taps[0], taps[1])
        lr, li = band_edge((yr, yi), taps[2], taps[3])
        err = torch.mean((ur * ur + ui * ui) - (lr * lr + li * li), dim=-1)
        err = torch.clamp(err, -1.0, 1.0)
        new_freq = torch.clamp(freq + beta * err, -max_freq, max_freq)
        phase = mod_2pi(phase + freq * sb)
        freq = new_freq
        tr, ti = next_tail(tr, yr, k1), next_tail(ti, yi, k1)
        ys_r.append(yr)
        ys_i.append(yi)
    y = torch.complex(torch.cat(ys_r, dim=-1), torch.cat(ys_i, dim=-1))
    return y, phase, freq, torch.complex(tr, ti)


def shape_key(xr, sb: int) -> str:
    """A call's key in the launch report: rows x samples, the sub-block."""
    return f"{math.prod(xr.shape[:-1])}x{xr.shape[-1]} sb{sb}"


def _lib():
    lib = kernels.load("fll_band_edge")
    if not getattr(lib, "_qrl_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fll_band_edge_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, i,
                                          i, i, i, f, f, f, f, f, p]
        lib.fll_band_edge_f32.restype = ctypes.c_int
        lib.fll_band_edge_smem_bytes.argtypes = [i, i]
        lib.fll_band_edge_smem_bytes.restype = ctypes.c_longlong
        lib.fll_band_edge_error_string.argtypes = [i]
        lib.fll_band_edge_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def fll_band_edge(xr, xi, phase, freq, tail, taps, beta: float,
                  max_freq: float, sb: int):
    """The FLL over the planes xr, xi (..., T) f32 (xi None for real
    input), T a multiple of sb, from phase, freq (...) f32 and tail
    (..., K-1) complex64; taps (4, K) as fll_plain takes them. Returns
    (y complex64 (..., T), phase, freq, tail)."""
    lead, T = tuple(xr.shape[:-1]), xr.shape[-1]
    K = taps.shape[-1] if taps.ndim == 2 else 0
    dev = xr.device
    ok = (xr.dtype == torch.float32 and xr.ndim >= 1
          and (xi is None or (xi.dtype == torch.float32
                              and xi.shape == xr.shape and xi.device == dev))
          and phase.dtype == freq.dtype == taps.dtype == torch.float32
          and tuple(phase.shape) == tuple(freq.shape) == lead
          and taps.ndim == 2 and taps.shape[0] == 4 and K >= 2
          and tail.dtype == torch.complex64
          and tuple(tail.shape) == lead + (K - 1,)
          and phase.device == freq.device == tail.device == taps.device
          == dev and sb >= 1 and T % sb == 0)
    if not ok:
        raise ValueError(
            f"planes must be f32 (..., T), T a multiple of sb {sb}, phase "
            f"and freq f32 of their leading shape, tail complex64 (..., K-1)"
            f" and taps f32 (4, K), all on one device; got {tuple(xr.shape)}"
            f" {xr.dtype}, {tuple(phase.shape)}, {tuple(tail.shape)} "
            f"{tail.dtype}, taps {tuple(taps.shape)}")
    key = shape_key(xr, sb)
    if dev.type == "cpu":
        kernel_paths.record(OP, False, key)
        return fll_plain(xr, torch.zeros_like(xr) if xi is None else xi,
                         phase, freq, tail, taps, beta, max_freq, sb)
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    C = math.prod(lead)
    xr = xr.contiguous()
    xi = None if xi is None else xi.contiguous()
    y = torch.empty(lead + (T,), dtype=torch.complex64, device=dev)
    ph_out, fr_out = torch.empty_like(phase), torch.empty_like(freq)
    tail_out = torch.empty_like(tail)
    if C == 0:
        return y, ph_out.copy_(phase), fr_out.copy_(freq), tail_out.copy_(
            tail)
    lib = _lib()
    if not 0 <= lib.fll_band_edge_smem_bytes(sb, K) <= kernels.SMEM_MAX:
        raise ValueError(f"{OP} takes no sub-block of {sb} with {K} taps")
    phase, freq = phase.contiguous(), freq.contiguous()
    tail, taps = tail.contiguous(), taps.contiguous()
    with torch.cuda.device(dev):
        err = lib.fll_band_edge_f32(
            xr.data_ptr(), None if xi is None else xi.data_ptr(),
            tail.data_ptr(), phase.data_ptr(), freq.data_ptr(),
            taps.data_ptr(), y.data_ptr(), tail_out.data_ptr(),
            ph_out.data_ptr(), fr_out.data_ptr(), C, T, sb, K, beta,
            max_freq, inv_sb(sb), float(sb), TWO_PI,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.fll_band_edge_error_string(err).decode()}")
    kernel_paths.record(OP, True, key)
    return y, ph_out, fr_out, tail_out
