"""Per-row-taps stride-1 FIR: wrapper, plain version and the CUDA kernel
`depthwise_fir_f32` (csrc/depthwise.cu).

Port of the Pallas TPU kernel qradiolink_tpu/ops/pallas_fir.py
`depthwise_fir` (K4), which runs the PFB channelizer's and synthesizer's
branch filters:

    y[c, m] = sum_k taps[c, k] * x[c, m + kp-1 - k],   m in [0, out_len)

over (..., C, Tc) planes, every row c with its own kp taps. The TPU
kernel's 2048-lane slabs and `depthwise_plan` gate have no counterpart
here: every call on a CUDA tensor launches the kernel and computes all
out_len outputs.

On a CPU tensor the wrapper takes the plain version (the kp slice-MAC
terms of the JAX package's `_branch_fir`, in the same order); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "depthwise_fir_f32"
_GRID_Y_MAX = 65_535


def depthwise_fir_plain(xs, taps_flipped, out_len: int):
    """Plain PyTorch version: acc = sum over k of x[..., k:k+out_len] times
    column k of the flipped taps, k = 0 .. kp-1 in order."""
    kp = taps_flipped.shape[-1]
    ys = []
    for x in xs:
        acc = None
        for k in range(kp):
            term = x[..., :, k:k + out_len] * taps_flipped[:, k:k + 1]
            acc = term if acc is None else acc + term
        ys.append(acc)
    return tuple(ys)


def _lib():
    lib = kernels.load("depthwise")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.depthwise_fir_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.depthwise_fir_f32.restype = ctypes.c_int
        lib.depthwise_smem_bytes.argtypes = [i]
        lib.depthwise_smem_bytes.restype = ctypes.c_longlong
        lib.depthwise_error_string.argtypes = [i]
        lib.depthwise_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def _check(xs, taps_flipped, out_len):
    if len(xs) not in (1, 2):
        raise ValueError(f"1 or 2 planes, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        if x.dtype != torch.float32 or x.shape != x0.shape \
                or x.device != x0.device or x.ndim < 2:
            raise ValueError("planes must be f32 (..., C, Tc) tensors of one "
                             "shape and device")
    C, Tc = x0.shape[-2], x0.shape[-1]
    if taps_flipped.ndim != 2 or taps_flipped.shape[0] != C \
            or taps_flipped.dtype != torch.float32 \
            or taps_flipped.device != x0.device:
        raise ValueError(f"taps must be a ({C}, kp) f32 tensor on the "
                         f"planes' device")
    kp = taps_flipped.shape[1]
    if kp < 1 or not 0 <= out_len <= Tc - kp + 1:
        raise ValueError(f"{out_len} outputs of a {kp}-tap filter need more "
                         f"than {Tc} input samples")
    return C, Tc, kp


def depthwise_fir(xs, taps_flipped, out_len: int):
    """Per-row FIR of each plane in `xs`, out_len outputs per row.

    xs: tuple of 1 or 2 f32 planes (..., C, Tc) of one shape; taps_flipped:
    (C, kp) f32, each row's taps reversed (row c of every leading index
    uses taps row c). Returns a tuple of (..., C, out_len) f32 planes.
    """
    xs = tuple(xs)
    C, Tc, kp = _check(xs, taps_flipped, out_len)
    shape = f"C{C} kp{kp}"
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(OP, False, shape)
        return depthwise_fir_plain(xs, taps_flipped, out_len)
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("planes must be contiguous")
    if not taps_flipped.is_contiguous():
        raise ValueError("taps must be contiguous")
    rows = xs[0].numel() // Tc
    if rows > _GRID_Y_MAX:
        raise ValueError(f"{rows} rows exceed the grid's {_GRID_Y_MAX}")
    lib = _lib()
    if lib.depthwise_smem_bytes(kp) > kernels.SMEM_MAX:
        raise ValueError(f"kp={kp} needs more shared memory than a block has")
    lead = xs[0].shape[:-1]
    ys = tuple(torch.empty(lead + (out_len,), dtype=torch.float32,
                           device=dev) for _ in xs)
    if out_len == 0 or rows == 0:
        return ys
    two = len(xs) == 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.depthwise_fir_f32(
            xs[0].data_ptr(), xs[1].data_ptr() if two else None,
            taps_flipped.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if two else None,
            rows, C, Tc, kp, out_len, len(xs), stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.depthwise_error_string(err).decode()}")
    kernel_paths.record(OP, True, shape)
    return ys
