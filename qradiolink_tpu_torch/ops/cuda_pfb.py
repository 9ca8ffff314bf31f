"""Fused polyphase channelizer: wrapper, plain version, tables and the CUDA
kernel `pfb_channelize_f32` (csrc/pfb.cu).

Port of the Pallas TPU kernel qradiolink_tpu/ops/pallas_pfb.py `channelize`
(K5), which computes the whole PFB channelizer in one pass. With the input
viewed as x2d[t, c] = x[t*M + c] (rows before the block from the raw
history state), the commutator's one-row delay and branch order fold into
per-column taps ct (kp+1, M), and the channels are the inverse DFT of the
columns taken in polyphase order p = (M - c) mod M (the TPU kernel's
column-permuted DFT matrix W):

    v[t, c] = sum_{l=0..kp} ct[l, c] * x2d[t - l, c]
    y[k, t] = sum_p exp(+2 pi i k p / M) * v[t, (M - p) mod M]

The kernel computes the DFT in two factored stages (M = M1 * M2,
`dft_factors`) from the tables of `pfb_tables`. The TPU kernel's lane
packing (`_pack`, the g_str/fold plan) and its remainder rows have no
counterpart here: every call on a CUDA tensor launches the kernel and
computes all Tm rows.

On a CPU tensor the wrapper takes the plain version (kp+1 shifted FMAs,
then torch.fft.ifft); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "pfb_channelize_f32"


def dft_factors(M: int):
    """(M1, M2) with M = M1 * M2, M1 the largest divisor with M1^2 <= M:
    the kernel's two-stage DFT (M1 = 1 leaves one dense DFT)."""
    M1 = max(d for d in range(1, int(np.sqrt(M)) + 1) if M % d == 0)
    return M1, M // M1


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def pfb_tables(btq: np.ndarray):
    """(ct (kp+1, M), dft) as f32 numpy, from the commutator-ordered branch
    taps btq (M, kp) (row q filters branch p = M-1-q). ct is ported from
    qradiolink_tpu/ops/pallas_pfb.py `_tables`, without the 128-lane
    tiling. dft packs the kernel's factored inverse-DFT tables (see
    csrc/pfb.cu), with (M1, M2) = dft_factors(M) and each k axis padded
    with zeros to a multiple of 8:
    A[p1, p2, k2] = exp(2 pi i k2 (p1 + M1 p2) / M), (M1, M2, MP2), and
    Bt[p1, k1] = exp(2 pi i k1 p1 / M1), (M1, MP1); flat as
    [Re A | Im A | Re Bt | Im Bt]."""
    btq = np.asarray(btq, np.float32)
    M, kp = btq.shape
    ct = np.zeros((kp + 1, M), np.float32)
    ct[:kp, 0] = btq[M - 1]
    for c in range(1, M):
        ct[1:, c] = btq[c - 1]
    M1, M2 = dft_factors(M)
    p = np.arange(M1)[:, None] + M1 * np.arange(M2)[None, :]  # (p1, p2)
    a = np.zeros((M1, M2, _pad8(M2)), np.complex128)
    a[..., :M2] = np.exp(2j * np.pi * p[..., None] * np.arange(M2) / M)
    bt = np.zeros((M1, _pad8(M1)), np.complex128)
    bt[:, :M1] = np.exp(2j * np.pi * np.outer(np.arange(M1),
                                              np.arange(M1)) / M1)
    dft = np.concatenate([a.real.ravel(), a.imag.ravel(), bt.real.ravel(),
                          bt.imag.ravel()]).astype(np.float32)
    return ct, dft


def channelize_plain(xs, hist, ct):
    """Plain PyTorch version of the fused channelizer. xs: (x_re, x_im),
    each (..., Tm*M); hist: (..., 2, kp*M); ct (kp+1, M). The column FIR
    as kp+1 shifted FMAs, then the columns in polyphase order
    p = (M - c) mod M through an unscaled inverse FFT. Returns
    (y_re, y_im), each (..., M, Tm)."""
    kp1, M = ct.shape
    kp = kp1 - 1
    lead = tuple(xs[0].shape[:-1])
    Tm = xs[0].shape[-1] // M
    vs = []
    for p, x in enumerate(xs):
        x2d = torch.cat([hist[..., p, :].reshape(lead + (kp, M)),
                         x.reshape(lead + (Tm, M))], dim=-2)
        v = x2d[..., kp:kp + Tm, :] * ct[0]
        for l in range(1, kp + 1):
            v = v + x2d[..., kp - l:kp - l + Tm, :] * ct[l]
        vs.append(v)
    order = (-torch.arange(M, device=ct.device)) % M
    y = torch.fft.ifft(torch.complex(*vs)[..., order], dim=-1,
                       norm="forward").transpose(-1, -2)
    return y.real.contiguous(), y.imag.contiguous()


def _lib():
    lib = kernels.load("pfb")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pfb_channelize_f32.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
        lib.pfb_channelize_f32.restype = ctypes.c_int
        lib.pfb_smem_bytes.argtypes = [i, i, i]
        lib.pfb_smem_bytes.restype = ctypes.c_longlong
        lib.pfb_error_string.argtypes = [i]
        lib.pfb_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def _check(xs, hist, ct, dft):
    if len(xs) != 2:
        raise ValueError(f"2 planes (re, im), got {len(xs)}")
    x0 = xs[0]
    kp1, M = ct.shape
    kp = kp1 - 1
    for t in (*xs, hist, ct, dft):
        if t.dtype != torch.float32 or t.device != x0.device:
            raise ValueError("every tensor must be f32 on the planes' device")
    if xs[1].shape != x0.shape or x0.shape[-1] % M:
        raise ValueError(f"planes must share a shape (..., Tm*{M})")
    if tuple(hist.shape) != tuple(x0.shape[:-1]) + (2, kp * M):
        raise ValueError(f"hist must be {tuple(x0.shape[:-1])} + "
                         f"(2, {kp * M})")
    M1, M2 = dft_factors(M)
    if tuple(dft.shape) != (2 * M1 * (M2 * _pad8(M2) + _pad8(M1)),):
        raise ValueError(f"dft is not the table pfb_tables makes for M={M}")
    if kp < 1:
        raise ValueError("ct needs at least 2 rows")
    return M, kp, M1


def channelize(xs, hist, ct, dft):
    """Fused PFB channelizer over f32 planes.

    xs: (x_re, x_im), each (..., T) with T = Tm*M; hist: (..., 2, kp*M)
    raw input history (the last kp*M samples before the block, oldest
    first); ct, dft: the tables of pfb_tables, as f32 tensors on the
    planes' device. Returns (y_re, y_im), each (..., M, Tm). The new
    history is the caller's (the last kp*M samples of [hist | x]).
    """
    xs = tuple(xs)
    M, kp, M1 = _check(xs, hist, ct, dft)
    shape = f"M{M} kp{kp}"
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(OP, False, shape)
        return channelize_plain(xs, hist, ct)
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    for t in (*xs, hist, ct, dft):
        if not t.is_contiguous():
            raise ValueError("every tensor must be contiguous")
    lib = _lib()
    if lib.pfb_smem_bytes(M, kp, M1) > kernels.SMEM_MAX:
        raise ValueError(f"M={M}, kp={kp} needs more shared memory than a "
                         f"block has")
    lead = tuple(xs[0].shape[:-1])
    B = xs[0].numel() // xs[0].shape[-1] if xs[0].numel() else 0
    Tm = xs[0].shape[-1] // M
    ys = tuple(torch.empty(lead + (M, Tm), dtype=torch.float32, device=dev)
               for _ in range(2))
    if B == 0 or Tm == 0:
        return ys
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pfb_channelize_f32(
            xs[0].data_ptr(), xs[1].data_ptr(), hist.data_ptr(),
            ct.data_ptr(), dft.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr(), B, Tm, M, kp, M1, stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.pfb_error_string(err).decode()}")
    kernel_paths.record(OP, True, shape)
    return ys
