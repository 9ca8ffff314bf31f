"""Strided streaming FIR: wrapper, plain version and the CUDA kernel
`fir_stream_f32` (csrc/fir.cu).

Port of the two Pallas TPU kernels of qradiolink_tpu/ops/pallas_fir.py,
`banded_fir_stream` (K1) and `banded_fir` (K2), which compute the same
function, so one kernel serves both:

    y[m] = sum_k h[k] * xc[m*D + shift + K-1-k],   m in [0, n_out)

over each row of the virtual stream xc = [tail | x] (K1, with a carried
tail of K-1 samples) or xc = x (K2, no tail). The TPU kernels' banded
matrices, 128-lane slabs and `plan()` gates have no counterpart here: every
call on a CUDA tensor launches the kernel and computes all n_out outputs.

On a CPU tensor the wrapper takes the plain version (F.conv1d over the
explicit concatenation); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "fir_stream_f32"
_GRID_Y_MAX = 65_535


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full f32: TF32 (cuDNN's default) keeps about
    three decimal digits, the reference computes its FIRs in f32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fir_stream_plain(xs, taps_flipped, stride: int, n_out: int,
                     tails=None, shift: int = 0):
    """Plain PyTorch version of fir_stream: F.conv1d with the flipped taps
    and stride D over the explicit [tail | x] concatenation."""
    K = taps_flipped.shape[0]
    w = taps_flipped.reshape(1, 1, K)
    ys = []
    for i, x in enumerate(xs):
        xc = x if tails is None else torch.cat([tails[i], x], dim=-1)
        lead = xc.shape[:-1]
        seg = xc.reshape(-1, 1, xc.shape[-1])[
            ..., shift: shift + (n_out - 1) * stride + K]
        with _no_tf32():
            y = F.conv1d(seg, w, stride=stride)
        ys.append(y.reshape(lead + (n_out,)))
    return tuple(ys)


def _lib():
    lib = kernels.load("fir")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fir_stream_f32.argtypes = [p, p, i, p, p, p, p, p,
                                       i, i, i, i, i, i, i, p]
        lib.fir_stream_f32.restype = ctypes.c_int
        lib.fir_stream_smem_bytes.argtypes = [i, i]
        lib.fir_stream_smem_bytes.restype = ctypes.c_longlong
        lib.fir_error_string.argtypes = [i]
        lib.fir_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def _check(xs, taps_flipped, stride, n_out, tails, shift):
    if len(xs) not in (1, 2):
        raise ValueError(f"1 or 2 planes, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        if x.dtype != torch.float32 or x.shape != x0.shape \
                or x.device != x0.device:
            raise ValueError("planes must be f32 tensors of one shape and "
                             "device")
    if taps_flipped.ndim != 1 or taps_flipped.dtype != torch.float32 \
            or taps_flipped.device != x0.device:
        raise ValueError("taps must be a 1-D f32 tensor on the planes' "
                         "device")
    K = taps_flipped.shape[0]
    T = x0.shape[-1]
    tail_len = 0
    if tails is not None:
        if len(tails) != len(xs):
            raise ValueError("one tail per plane")
        for t in tails:
            if t.dtype != torch.float32 or t.device != x0.device \
                    or tuple(t.shape) != tuple(x0.shape[:-1]) + (K - 1,):
                raise ValueError(f"tails must be f32 {tuple(x0.shape[:-1])}"
                                 f" + ({K - 1},) on the planes' device")
        tail_len = K - 1
    if stride < 1 or shift < 0 or n_out < 0:
        raise ValueError(f"stride {stride}, shift {shift}, n_out {n_out}")
    if n_out and (n_out - 1) * stride + shift + K > tail_len + T:
        raise ValueError(f"{n_out} outputs need more than the {tail_len} + "
                         f"{T} input samples")
    return K, T


def fir_stream(xs, taps_flipped, stride: int, n_out: int, tails=None,
               shift: int = 0):
    """Strided FIR of each plane in `xs`, n_out outputs per row.

    xs: tuple of 1 or 2 f32 planes (..., T) of one shape; taps_flipped:
    (K,) f32, the taps reversed; tails: None (K2: the input is already
    [history | block]) or one (..., K-1) tail per plane (K1: the virtual
    stream is [tail | x], never concatenated in memory); 0 <= shift is an
    input offset (the polyphase resampler's per-phase q_r). Returns a tuple
    of (..., n_out) f32 planes.
    """
    xs = tuple(xs)
    tails = None if tails is None else tuple(tails)
    K, T = _check(xs, taps_flipped, stride, n_out, tails, shift)
    shape = f"K{K} D{stride}" + (" tail" if tails is not None else "")
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(OP, False, shape)
        return fir_stream_plain(xs, taps_flipped, stride, n_out, tails,
                                shift)
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")

    lead = xs[0].shape[:-1]
    C = 1
    for d in lead:
        C *= d
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("planes must be contiguous")
    if not taps_flipped.is_contiguous():
        raise ValueError("taps must be contiguous")
    tail_ptrs = [None, None]
    tail_ld = 0
    if tails is not None:
        for i, t in enumerate(tails):
            # a tail is a strided view into the (..., 2, K-1) filter state:
            # rows must sit at one stride, samples adjacent
            tv = t.view(C, K - 1)
            if tv.stride(1) != 1 and K > 2:
                raise ValueError("tail samples must be adjacent in memory")
            if i and tv.stride(0) != tail_ld and C > 1:
                raise ValueError("both tails need one row stride")
            tail_ld = tv.stride(0) if C > 1 else K - 1
            tail_ptrs[i] = t.data_ptr()
    if C > _GRID_Y_MAX:
        raise ValueError(f"{C} rows exceed the grid's {_GRID_Y_MAX}")
    lib = _lib()
    if lib.fir_stream_smem_bytes(K, stride) > kernels.SMEM_MAX:
        raise ValueError(f"K={K}, D={stride} needs more shared memory than "
                         f"a block has")
    ys = tuple(torch.empty(lead + (n_out,), dtype=torch.float32, device=dev)
               for _ in xs)
    if n_out == 0:
        return ys
    two = len(xs) == 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fir_stream_f32(
            tail_ptrs[0], tail_ptrs[1] if two else None, tail_ld,
            xs[0].data_ptr(), xs[1].data_ptr() if two else None,
            taps_flipped.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if two else None,
            C, T, K, stride, shift, n_out, len(xs), stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.fir_error_string(err).decode()}")
    kernel_paths.record(OP, True, shape)
    return ys
