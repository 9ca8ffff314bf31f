"""The Agc2 gain recurrence: wrapper, plain version and the CUDA kernel
`agc2_gain_f32` (csrc/agc2.cu).

Not the port of a Pallas kernel: the JAX package runs the recurrence as a
per-sample `lax.scan` (qradiolink_tpu/ops/agc.py:43-53), one device loop.
Per row, from g = g0, for each sample n, each operation rounded on its own:

    gains[n] = g                   (the gain before the update)
    err      = reference - m[n] * g
    rate     = attack if err < 0 else decay
    g        = clamp(g + rate * err, 1e-6, max_gain)

On a CPU tensor the wrapper takes the plain version (a loop over the
samples, a handful of PyTorch ops each); on a CUDA tensor it launches the
kernel, one thread a row, or raises. The two are equal bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "agc2_gain_f32"
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


def shape_key(m) -> str:
    """A call's key in the launch report: rows x samples."""
    return f"{math.prod(m.shape[:-1])}x{m.shape[-1]}"


def _lib():
    lib = kernels.load("agc2")
    if not getattr(lib, "_qrl_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.agc2_gain_f32.argtypes = [p, p, p, p, i, i, f, f, f, f, f, p]
        lib.agc2_gain_f32.restype = ctypes.c_int
        lib.agc2_error_string.argtypes = [i]
        lib.agc2_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


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
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.agc2_error_string(err).decode()}")
    kernel_paths.record(OP, True, key)
    return gains, g_last
