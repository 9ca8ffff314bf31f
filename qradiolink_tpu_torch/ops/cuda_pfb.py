"""Fused polyphase channelizer: wrapper, plain version, tables and the two
CUDA kernels that compute it, `pfb_fft_f32` (csrc/pfb_fft.cu) and
`pfb_channelize_f32` (csrc/pfb.cu).

Port of the Pallas TPU kernel qradiolink_tpu/ops/pallas_pfb.py `channelize`
(K5), which computes the whole PFB channelizer in one pass. With the input
viewed as x2d[t, c] = x[t*M + c] (rows before the block from the raw
history state), the commutator's one-row delay and branch order fold into
per-column taps ct (kp+1, M), and the channels are the inverse DFT of the
columns taken in polyphase order p = (M - c) mod M (the TPU kernel's
column-permuted DFT matrix W):

    v[t, c] = sum_{l=0..kp} ct[l, c] * x2d[t - l, c]
    y[k, t] = sum_p exp(+2 pi i k p / M) * v[t, (M - p) mod M]

`route(M, kp)` picks the kernel: `pfb_fft_f32`, the DFT as two radix-2/4/5/8
butterfly stages (M = R1 * R2, `FFT_RADICES`, twiddles from `fft_table`)
and the rows staged asynchronously, for the shapes in FFT_SHAPES: M in 8,
16, 32, 64 with kp in 8, 16, 24, 32 (the mixed path's M = 64, kp = 24),
and M 10 with kp 56 (MMDVMmulti's channelizer); `pfb_channelize_f32`, the
DFT in two dense factored stages (M = M1 * M2, `dft_factors`, tables from
`pfb_tables`), for every other shape (M 10 at other kp, M 13). The
TPU kernel's lane packing (`_pack`, the g_str/fold plan) and its remainder
rows have no counterpart here: every call on a CUDA tensor launches a
kernel and computes all Tm rows.

On a CPU tensor the wrapper takes the plain version (kp+1 shifted FMAs,
then torch.fft.ifft) and records it under the routed kernel's name; on a
CUDA tensor it launches that kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "pfb_channelize_f32"
FFT_OP = "pfb_fft_f32"
# pfb_fft_f32's instances (`pick` in csrc/pfb_fft.cu): M = R1 * R2
# (Radix<M>); at M 8-64 the taps a branch FFT_KP, at most their tile of 32
# rows; at M 10 MMDVMmulti's kp 56 alone (Shape<10, 56>: tiles of 64 rows)
FFT_RADICES = {8: (2, 4), 10: (2, 5), 16: (4, 4), 32: (4, 8), 64: (8, 8)}
FFT_KP = (8, 16, 24, 32)
FFT_SHAPES = frozenset([(M, kp) for M in (8, 16, 32, 64) for kp in FFT_KP]
                       + [(10, 56)])


def route(M: int, kp: int) -> str:
    """The kernel that channelizes M channels with kp taps a branch:
    pfb_fft_f32 for (M, kp) in FFT_SHAPES, pfb_channelize_f32 otherwise."""
    if (M, kp) in FFT_SHAPES:
        return FFT_OP
    return OP


def fft_table(M: int) -> np.ndarray:
    """pfb_fft_f32's twiddles W^(k2 p1) = exp(2 pi i k2 p1 / M), p1 < R1,
    k2 < R2, computed in float64 and rounded once to f32; flat (2 M,) as
    [Re | Im], each laid out [p1][k2]."""
    R1, R2 = FFT_RADICES[M]
    w = np.exp(2j * np.pi * np.outer(np.arange(R1), np.arange(R2)) / M)
    return np.concatenate([w.real.ravel(), w.imag.ravel()]).astype(
        np.float32)


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


def _pfb_lib():
    """csrc/pfb.cu's library."""
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


def _fft_lib():
    """csrc/pfb_fft.cu's library."""
    lib = kernels.load("pfb_fft")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pfb_fft_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.pfb_fft_f32.restype = ctypes.c_int
        lib.pfb_fft_error_string.argtypes = [i]
        lib.pfb_fft_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def _check(xs, hist, ct):
    """Checks the planes, history and taps; returns (M, kp)."""
    if len(xs) != 2:
        raise ValueError(f"2 planes (re, im), got {len(xs)}")
    x0 = xs[0]
    kp1, M = ct.shape
    kp = kp1 - 1
    for t in (*xs, hist, ct):
        if t.dtype != torch.float32 or t.device != x0.device:
            raise ValueError("every tensor must be f32 on the planes' device")
    if xs[1].shape != x0.shape or x0.shape[-1] % M:
        raise ValueError(f"planes must share a shape (..., Tm*{M})")
    if tuple(hist.shape) != tuple(x0.shape[:-1]) + (2, kp * M):
        raise ValueError(f"hist must be {tuple(x0.shape[:-1])} + "
                         f"(2, {kp * M})")
    if kp < 1:
        raise ValueError("ct needs at least 2 rows")
    return M, kp


def _prepare(xs, hist, tables):
    """Checks contiguity; returns (ys, B, Tm) with the outputs allocated,
    each (..., M, Tm)."""
    for t in (*xs, hist, *tables):
        if not t.is_contiguous():
            raise ValueError("every tensor must be contiguous")
    M = tables[0].shape[1]
    lead = tuple(xs[0].shape[:-1])
    B = xs[0].numel() // xs[0].shape[-1] if xs[0].numel() else 0
    Tm = xs[0].shape[-1] // M
    ys = tuple(torch.empty(lead + (M, Tm), dtype=torch.float32,
                           device=xs[0].device) for _ in range(2))
    return ys, B, Tm


def _run(op, fn, error_string, tensors, *ints):
    """fn(pointers of tensors..., ints..., stream) on the planes' device;
    raises with error_string's message on a CUDA error."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{op} launch failed: "
                           f"{error_string(err).decode()}")


def _launch(xs, hist, ct, dft):
    """pfb_channelize_f32 on CUDA tensors (any M; the factored DFT)."""
    M, kp = _check(xs, hist, ct)
    M1, M2 = dft_factors(M)
    if dft.dtype != torch.float32 or dft.device != xs[0].device or \
            tuple(dft.shape) != (2 * M1 * (M2 * _pad8(M2) + _pad8(M1)),):
        raise ValueError(f"dft is not the table pfb_tables makes for M={M}")
    lib = _pfb_lib()
    if lib.pfb_smem_bytes(M, kp, M1) > kernels.SMEM_MAX:
        raise ValueError(f"M={M}, kp={kp} needs more shared memory than a "
                         f"block has")
    ys, B, Tm = _prepare(xs, hist, (ct, dft))
    if B and Tm:
        _run(OP, lib.pfb_channelize_f32, lib.pfb_error_string,
             (*xs, hist, ct, dft, *ys), B, Tm, M, kp, M1)
        kernel_paths.record(OP, True, f"M{M} kp{kp}")
    return ys


@functools.cache
def _twiddles(M: int, device: torch.device) -> torch.Tensor:
    """fft_table(M) as a tensor on `device`, made once for each (M,
    device) and never written."""
    return torch.from_numpy(fft_table(M)).to(device)


def _aligned(t):
    """t, or a copy of it at a fresh allocation when its data is not
    16-byte aligned (pfb_fft_f32 stages rows with 16-byte copies, 8-byte at
    M 10)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fft(xs, hist, ct):
    """pfb_fft_f32 on CUDA tensors ((M, kp) in FFT_SHAPES)."""
    M, kp = _check(xs, hist, ct)
    if route(M, kp) != FFT_OP:
        raise ValueError(f"{FFT_OP} does not take M={M}, kp={kp}")
    ys, B, Tm = _prepare(xs, hist, (ct,))
    if B and Tm:
        lib = _fft_lib()
        _run(FFT_OP, lib.pfb_fft_f32, lib.pfb_fft_error_string,
             (*map(_aligned, xs), _aligned(hist), ct,
              _twiddles(M, ct.device), *ys), B, Tm, M, kp)
        kernel_paths.record(FFT_OP, True, f"M{M} kp{kp}")
    return ys


def channelize(xs, hist, ct, dft):
    """Fused PFB channelizer over f32 planes.

    xs: (x_re, x_im), each (..., T) with T = Tm*M; hist: (..., 2, kp*M)
    raw input history (the last kp*M samples before the block, oldest
    first); ct, dft: the tables of pfb_tables, as f32 tensors on the
    planes' device (pfb_fft_f32 takes its twiddles from fft_table(M)
    instead of dft). Returns (y_re, y_im), each (..., M, Tm). The new
    history is the caller's (the last kp*M samples of [hist | x]).
    """
    xs = tuple(xs)
    M, kp = ct.shape[1], ct.shape[0] - 1
    op = route(M, kp)
    dev = xs[0].device
    if dev.type == "cpu":
        _check(xs, hist, ct)
        kernel_paths.record(op, False, f"M{M} kp{kp}")
        return channelize_plain(xs, hist, ct)
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    if op == OP:
        return _launch(xs, hist, ct, dft)
    return _launch_fft(xs, hist, ct)
