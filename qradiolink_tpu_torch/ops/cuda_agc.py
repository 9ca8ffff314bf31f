"""The Agc2 stage: wrappers, plain versions and the CUDA kernels of
csrc/agc2.cu, `agc2_f32` (the stage in one launch) and `agc2_gain_f32`
(the gain recurrence alone, the stage's design before; no chain runs it).

Not the port of a Pallas kernel: the JAX package runs the recurrence as a
per-sample `lax.scan` (qradiolink_tpu/ops/agc.py:43-53), one device loop.
Per row, from g = g0, for each sample n, each operation rounded on its own:

    m        = |x[n]|              (torch.abs)
    y[n]     = x[n] * g            (plane by plane; g before the update)
    gains[n] = g
    err      = reference - m * g
    rate     = attack if err < 0 else decay
    g        = clamp(g + rate * err, 1e-6, max_gain)

`agc2` returns (y, the gain after the last sample), `agc2_gain` (gains, the
gain after the last sample) of magnitudes m. On a CPU tensor each wrapper
takes its plain version (a loop over the samples, a handful of PyTorch ops
each); on a CUDA tensor it launches its kernel or raises. Kernel and plain
version are equal bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "agc2_gain_f32"
OP_FUSED = "agc2_f32"
# the gain's floor, as the JAX package clips it
MIN_GAIN = 1e-6


def agc2_gain_plain(m, g0, attack: float, decay: float, reference: float,
                    max_gain: float):
    """Plain PyTorch version: the recurrence a sample at a time over the
    last axis. Returns (gains like m, the gain after the last sample)."""
    gains = torch.empty_like(m)
    g = g0.clone()
    for n in range(m.shape[-1]):
        gains[..., n] = g
        err = reference - m[..., n] * g
        rate = torch.where(err < 0, attack, decay)
        g = torch.clamp(g + rate * err, MIN_GAIN, max_gain)
    return gains, g


def agc2_plain(x, g0, attack: float, decay: float, reference: float,
               max_gain: float):
    """Plain PyTorch version of the stage: torch.abs, the recurrence
    (agc2_gain_plain) and the products, plane by plane for complex x (the
    reference's complex-by-real product gives those bits, PyTorch's complex
    one need not). Returns (y like x, the gain after the last sample)."""
    gains, g_last = agc2_gain_plain(torch.abs(x).float(), g0, attack, decay,
                                    reference, max_gain)
    if torch.is_complex(x):
        return torch.complex(x.real * gains, x.imag * gains), g_last
    return x * gains, g_last


def shape_key(m) -> str:
    """A call's key in the launch report: rows x samples."""
    return f"{math.prod(m.shape[:-1])}x{m.shape[-1]}"


def fused_key(x) -> str:
    """An agc2 call's key in the launch report: kind, rows x samples."""
    kind = "complex" if torch.is_complex(x) else "real"
    return f"{kind} {math.prod(x.shape[:-1])}x{x.shape[-1]}"


def _lib():
    lib = kernels.load("agc2")
    if not getattr(lib, "_qrl_bound", False):
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.agc2_gain_f32.argtypes = [p, p, p, p, i, i, f, f, f, f, f, p]
        lib.agc2_f32.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f, p]
        lib.agc2_abs_f32.argtypes = [p, p, ll, p]
        for fn in (lib.agc2_gain_f32, lib.agc2_f32, lib.agc2_abs_f32):
            fn.restype = ctypes.c_int
        lib.agc2_error_string.argtypes = [i]
        lib.agc2_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def _check(lib, err: int, op: str):
    if err:
        raise RuntimeError(f"{op} launch failed: "
                           f"{lib.agc2_error_string(err).decode()}")


def agc2(x, g0, attack: float, decay: float, reference: float,
         max_gain: float):
    """The Agc2 stage on x (..., T), complex64 or f32, from the gains g0
    (...) f32: (y like x, the gain after the last sample (...))."""
    if g0.dtype != torch.float32 or x.device != g0.device or x.ndim < 1 \
            or tuple(g0.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"x must be (..., T) and g0 f32 of its leading "
                         f"shape on its device; got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(g0.shape)} {g0.dtype}")
    dev = x.device
    key = fused_key(x)
    if dev.type == "cpu":
        kernel_paths.record(OP_FUSED, False, key)
        return agc2_plain(x, g0, attack, decay, reference, max_gain)
    if dev.type != "cuda":
        raise ValueError(f"no {OP_FUSED} kernel for device {dev}")
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"{OP_FUSED} takes complex64 or f32, not {x.dtype}")
    x = x.contiguous()
    g0 = g0.contiguous()
    C, T = math.prod(x.shape[:-1]), x.shape[-1]
    y = torch.empty_like(x)
    g_last = torch.empty_like(g0)
    if C == 0 or T == 0:
        return y, g_last.copy_(g0)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.agc2_f32(
            x.data_ptr(), g0.data_ptr(), y.data_ptr(), g_last.data_ptr(),
            C, T, int(torch.is_complex(x)), reference, attack, decay,
            MIN_GAIN, max_gain, torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, OP_FUSED)
    kernel_paths.record(OP_FUSED, True, key)
    return y, g_last


def abs_complex(x):
    """agc2_f32's |x| of a complex64 CUDA tensor, f32 of its shape (the
    card test holds it to torch.abs's bits)."""
    if x.dtype != torch.complex64 or x.device.type != "cuda":
        raise ValueError("abs_complex takes a complex64 CUDA tensor")
    x = x.contiguous()
    m = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.agc2_abs_f32(x.data_ptr(), m.data_ptr(), x.numel(),
                               torch.cuda.current_stream(x.device)
                               .cuda_stream)
    _check(lib, err, "agc2_abs_f32")
    return m


def agc2_gain(m, g0, attack: float, decay: float, reference: float,
              max_gain: float):
    """The gains of Agc2 for magnitudes m (..., T) f32 from the gains g0
    (...) f32: (gains (..., T), the gain after the last sample (...))."""
    if m.dtype != torch.float32 or g0.dtype != torch.float32 \
            or m.device != g0.device or m.ndim < 1 \
            or tuple(g0.shape) != tuple(m.shape[:-1]):
        raise ValueError(f"m must be f32 (..., T) and g0 f32 of its leading "
                         f"shape on its device; got {tuple(m.shape)} "
                         f"{m.dtype}, {tuple(g0.shape)} {g0.dtype}")
    dev = m.device
    key = shape_key(m)
    if dev.type == "cpu":
        kernel_paths.record(OP, False, key)
        return agc2_gain_plain(m, g0, attack, decay, reference, max_gain)
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    m = m.contiguous()
    g0 = g0.contiguous()
    C, T = math.prod(m.shape[:-1]), m.shape[-1]
    gains = torch.empty_like(m)
    g_last = torch.empty_like(g0)
    if C == 0 or T == 0:
        return gains, g_last.copy_(g0)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.agc2_gain_f32(
            m.data_ptr(), g0.data_ptr(), gains.data_ptr(), g_last.data_ptr(),
            C, T, reference, attack, decay, MIN_GAIN, max_gain,
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, OP)
    kernel_paths.record(OP, True, key)
    return gains, g_last
