"""The Costas loop's recurrence: wrapper, plain version and the CUDA kernel
`costas_loop_f32` (csrc/costas.cu).

Not the port of a Pallas kernel: the JAX package runs the loop as a
per-sample `lax.scan` (qradiolink_tpu/sync/costas.py:53-64), one device
loop. Per row, from (phase, freq), for each sample x[n], in the JAX
package's order, each operation rounded on its own:

    nco   = (cos(phase), -sin(phase))        exp(-1j phase): a zero real
                                             argument, so exp gives these
    y[n]  = (xr c - xi s', xr s' + xi c)     s' = -sin(phase); XLA's complex
                                             product
    err   = yi sign(yr)                      (order 2)
          = sign(yr) yi - sign(yi) yr        (order 4)
    err   = clip(err, -1, 1)
    freq  = clip(freq + beta err, -max_freq, max_freq)
    phase = (phase + freq) + alpha err
    phase = mod(phase + pi, 2 pi) - pi       mod as JAX's: fmod, then + 2 pi
                                             where the remainder is < 0

On a CPU tensor the wrapper takes the plain version (a loop over the
samples, about 25 PyTorch ops each); on a CUDA tensor it launches the
kernel, one lane a row, or raises. On the card the two are equal bit for
bit: the kernel's sincosf gives torch.cos/torch.sin's bits there for every
f32 (`nco` below; tests/test_torch_cuda.py checks all 2^32), and its wrap
is an exact select for fmod's (chip_smoke.py and the card tests check the
loop).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "costas_loop_f32"
# pi and 2 pi as the f32 constants JAX makes of np.pi and 2 * np.pi
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2 * np.pi))


def mod_2pi(v: torch.Tensor) -> torch.Tensor:
    """jnp.mod(v, 2 pi), JAX's floor-mod: the remainder of fmod, plus 2 pi
    where it is negative."""
    r = torch.fmod(v, TWO_PI)
    return torch.where(r < 0, r + TWO_PI, r)


def wrap_pm_pi(phase: torch.Tensor) -> torch.Tensor:
    """mod(phase + pi, 2 pi) - pi, as the JAX loop wraps its phase."""
    return mod_2pi(phase + PI) - PI


def costas_error(yr, yi, order: int):
    if order == 2:
        return yi * torch.sign(yr)
    return torch.sign(yr) * yi - torch.sign(yi) * yr


def costas_loop_plain(xr, xi, phase, freq, order: int, alpha: float,
                      beta: float, max_freq: float):
    """Plain PyTorch version: the loop a sample at a time over the last
    axis of the planes xr, xi (..., T). Returns (yr, yi, phase, freq)."""
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    for n in range(xr.shape[-1]):
        c = torch.cos(phase)
        s = -torch.sin(phase)
        a, b = xr[..., n], xi[..., n]
        ur = a * c - b * s
        ui = a * s + b * c
        err = torch.clamp(costas_error(ur, ui, order), -1.0, 1.0)
        freq = torch.clamp(freq + beta * err, -max_freq, max_freq)
        phase = wrap_pm_pi((phase + freq) + alpha * err)
        yr[..., n] = ur
        yi[..., n] = ui
    return yr, yi, phase, freq


def shape_key(x, order: int) -> str:
    """A call's key in the launch report: the order, rows x samples."""
    return f"order{order} {math.prod(x.shape[:-1])}x{x.shape[-1]}"


def _lib():
    lib = kernels.load("costas")
    if not getattr(lib, "_qrl_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.costas_loop_f32.argtypes = [p, p, p, p, p, p, i, i, i, f, f, f,
                                        f, f, p]
        lib.costas_loop_f32.restype = ctypes.c_int
        lib.costas_nco_f32.argtypes = [p, p, p, ctypes.c_longlong, p]
        lib.costas_nco_f32.restype = ctypes.c_int
        lib.costas_error_string.argtypes = [i]
        lib.costas_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def costas_loop(x, phase, freq, order: int, alpha: float, beta: float,
                max_freq: float):
    """The Costas loop over complex64 x (..., T) from phase, freq (...)
    f32: (y complex64 like x, phase, freq after the last sample)."""
    if not torch.is_complex(x) or x.dtype != torch.complex64 \
            or phase.dtype != torch.float32 or freq.dtype != torch.float32 \
            or not (x.device == phase.device == freq.device) or x.ndim < 1 \
            or tuple(phase.shape) != tuple(x.shape[:-1]) \
            or tuple(freq.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"x must be complex64 (..., T) and phase, freq f32 "
                         f"of its leading shape on its device; got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(phase.shape)} "
                         f"{phase.dtype}, {tuple(freq.shape)} {freq.dtype}")
    if order not in (2, 4):
        raise ValueError("order must be 2 (BPSK) or 4 (QPSK)")
    dev = x.device
    key = shape_key(x, order)
    if dev.type == "cpu":
        kernel_paths.record(OP, False, key)
        yr, yi, ph, fr = costas_loop_plain(
            x.real, x.imag, phase, freq, order, alpha, beta, max_freq)
        return torch.complex(yr, yi), ph, fr
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    x = x.contiguous()
    phase, freq = phase.contiguous(), freq.contiguous()
    C, T = math.prod(x.shape[:-1]), x.shape[-1]
    y = torch.empty_like(x)
    ph_out, fr_out = torch.empty_like(phase), torch.empty_like(freq)
    if C == 0 or T == 0:
        return y, ph_out.copy_(phase), fr_out.copy_(freq)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.costas_loop_f32(
            x.data_ptr(), phase.data_ptr(), freq.data_ptr(), y.data_ptr(),
            ph_out.data_ptr(), fr_out.data_ptr(), C, T, order, alpha, beta,
            max_freq, PI, TWO_PI, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.costas_error_string(err).decode()}")
    kernel_paths.record(OP, True, key)
    return y, ph_out, fr_out


def nco(ph):
    """The kernel's NCO, exp(-1j ph) as (cos ph, -sin ph), over f32 phases:
    on a CUDA tensor by the kernel's own code (costas_nco_f32), on the CPU
    by torch.cos and torch.sin, which the kernel's must equal bit for
    bit."""
    if ph.dtype != torch.float32:
        raise ValueError(f"ph must be f32, got {ph.dtype}")
    if ph.device.type == "cpu":
        return torch.cos(ph), -torch.sin(ph)
    if ph.device.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {ph.device}")
    ph = ph.contiguous()
    c, s = torch.empty_like(ph), torch.empty_like(ph)
    lib = _lib()
    with torch.cuda.device(ph.device):
        err = lib.costas_nco_f32(ph.data_ptr(), c.data_ptr(), s.data_ptr(),
                                 ph.numel(),
                                 torch.cuda.current_stream(
                                     ph.device).cuda_stream)
    if err:
        raise RuntimeError(f"costas_nco_f32 launch failed: "
                           f"{lib.costas_error_string(err).decode()}")
    return c, s
