"""Per-row-taps stride-1 FIR: wrapper, plain version and the two CUDA
kernels that compute it, `depthwise_run_f32` (csrc/depthwise_run.cu) and
`depthwise_fir_f32` (csrc/depthwise.cu).

Port of the Pallas TPU kernel qradiolink_tpu/ops/pallas_fir.py
`depthwise_fir` (K4), which runs the PFB channelizer's and synthesizer's
branch filters:

    y[c, m] = sum_k taps[c, k] * xc[c, m + kp-1 - k],   m in [0, out_len)

over (..., C, Tc) rows, every row c with its own kp taps. xc is the input
row itself (the VALID form: the channelizer's commutated rows), or the
carried tail followed by the block (the tail form: the synthesizer, whose
tails are read in place from its (..., 2, C, kp-1) state). The TPU
kernel's 2048-lane slabs and `depthwise_plan` gate have no counterpart
here: every call on a CUDA tensor launches a kernel and computes all
out_len outputs.

`route(kp)` picks the kernel: `depthwise_run_f32`, runs of a row with the
taps in registers and the samples staged asynchronously, for kp in RUN_KP
(23, the synthesizer's with default taps at M 8-64; 24, the channelizer's,
rounded up to a multiple of 8; 53, MMDVMmulti's synthesizer at M 10);
`depthwise_fir_f32` for every other kp, the tail form after an explicit
concatenation.

On a CPU tensor the wrapper takes the plain version (the kp slice-MAC
terms of the JAX package's `_branch_fir`, in the same order) and records
it under the routed kernel's name; on a CUDA tensor it launches that kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "depthwise_fir_f32"
RUN_OP = "depthwise_run_f32"
# depthwise_run_f32's instances (`pick` in csrc/depthwise_run.cu)
RUN_KP = (23, 24, 53)
_GRID_Y_MAX = 65_535


def route(kp: int) -> str:
    """The kernel that filters rows of kp taps: depthwise_run_f32 for kp
    in RUN_KP, depthwise_fir_f32 otherwise."""
    return RUN_OP if kp in RUN_KP else OP


def depthwise_fir_plain(xs, taps_flipped, out_len: int, tails=None):
    """Plain PyTorch version: acc = sum over k of xc[..., k:k+out_len] times
    column k of the flipped taps, k = 0 .. kp-1 in order, with xc = x, or
    [tail | x] where tails are given."""
    kp = taps_flipped.shape[-1]
    ys = []
    for i, x in enumerate(xs):
        if tails is not None:
            x = torch.cat([tails[i], x], dim=-1)
        acc = None
        for k in range(kp):
            term = x[..., :, k:k + out_len] * taps_flipped[:, k:k + 1]
            acc = term if acc is None else acc + term
        ys.append(acc)
    return tuple(ys)


def _run_lib():
    lib = kernels.load("depthwise_run")
    if not getattr(lib, "_qrl_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.depthwise_run_f32.argtypes = [p, p, ll, i, p, p, ll, i, p, p, p,
                                          i, i, i, i, i, i, p]
        lib.depthwise_run_f32.restype = ctypes.c_int
        lib.depthwise_run_runs.argtypes = [i, i, i, i]
        lib.depthwise_run_runs.restype = ll
        lib.depthwise_run_error_string.argtypes = [i]
        lib.depthwise_run_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


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


def _check(xs, taps_flipped, out_len, tails):
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
    n_in = Tc
    if tails is not None:
        if len(tails) != len(xs):
            raise ValueError("one tail per plane")
        for t in tails:
            if t.dtype != torch.float32 or t.device != x0.device \
                    or tuple(t.shape) != tuple(x0.shape[:-1]) + (kp - 1,):
                raise ValueError(f"tails must be f32 {tuple(x0.shape[:-1])}"
                                 f" + ({kp - 1},) on the planes' device")
        n_in += kp - 1
    if kp < 1 or not 0 <= out_len <= n_in - kp + 1:
        raise ValueError(f"{out_len} outputs of a {kp}-tap filter need more "
                         f"than {n_in} input samples")
    return C, kp


def depthwise_fir(xs, taps_flipped, out_len: int, tails=None):
    """Per-row FIR of each plane in `xs`, out_len outputs per row.

    xs: tuple of 1 or 2 f32 planes (..., C, Tc) of one shape; taps_flipped:
    (C, kp) f32, each row's taps reversed (row c of every leading index
    uses taps row c); tails: None (the VALID form: each row is already
    [history | block]) or one (..., C, kp-1) tail per plane (the tail
    form: the rows are [tail | x], never concatenated in memory on the
    depthwise_run_f32 route). Returns a tuple of (..., C, out_len) f32
    planes.
    """
    xs = tuple(xs)
    tails = None if tails is None else tuple(tails)
    C, kp = _check(xs, taps_flipped, out_len, tails)
    op = route(kp)
    key = f"C{C} kp{kp}" + (" tail" if tails is not None else "")
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(op, False, key)
        return depthwise_fir_plain(xs, taps_flipped, out_len, tails)
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    if op == RUN_OP:
        return _launch_run(xs, taps_flipped, out_len, tails, key)
    if tails is not None:
        xs = tuple(torch.cat([t, x], dim=-1) for t, x in zip(tails, xs))
    return _launch_fir(xs, taps_flipped, out_len, key)


def _outputs(xs, out_len):
    return tuple(torch.empty(xs[0].shape[:-1] + (out_len,),
                             dtype=torch.float32, device=xs[0].device)
                 for _ in xs)


def _row_strides(t, C):
    """(outer, inner): the row strides of a (..., C, n) view across the
    leading axes and across C; its samples must be adjacent, and view()
    raises where the leading axes do not share one stride."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError("row samples must be adjacent in memory")
    v = t.view(-1, C, t.shape[-1])
    return v.stride(0), v.stride(1)


def run_count(rows: int, kp: int, out_len: int, planes: int,
              device) -> int:
    """The runs a row-plane that depthwise_run_f32 chooses for `rows` rows
    of `planes` planes and out_len outputs on the CUDA `device` (the blocks
    the card holds over the row-planes, at most one a 512 outputs)."""
    lib = _run_lib()
    with torch.cuda.device(device):
        n = lib.depthwise_run_runs(rows, kp, out_len, planes)
    if n < 0:
        raise RuntimeError(f"{RUN_OP} plan failed: "
                           f"{lib.depthwise_run_error_string(-n).decode()}")
    return n


def _launch_run(xs, taps_flipped, out_len, tails, key, runs=0):
    """depthwise_run_f32 on CUDA planes (kp in RUN_KP). The tail form reads
    halo and body from the tails and the planes; the VALID form reads both
    from the planes, the body from sample kp-1 on. runs: the runs a
    row-plane, 0 for the kernel's own choice (run_count)."""
    C, kp = taps_flipped.shape
    if route(kp) != RUN_OP:
        raise ValueError(f"{RUN_OP} does not take kp={kp}")
    if not taps_flipped.is_contiguous():
        raise ValueError("taps must be contiguous")
    halos = xs if tails is None else tails
    bodies = xs if tails is not None else tuple(x[..., kp - 1:] for x in xs)
    strides = [{_row_strides(t, C) for t in ts} for ts in (halos, bodies)]
    if any(len(st) != 1 for st in strides):
        raise ValueError("both planes need one layout")
    (h_outer, h_inner), (b_outer, b_inner) = (st.pop() for st in strides)
    ys = _outputs(xs, out_len)
    rows = ys[0].numel() // out_len if out_len else 0
    if rows == 0:
        return ys
    two = len(xs) == 2
    lib = _run_lib()
    dev = xs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.depthwise_run_f32(
            halos[0].data_ptr(), halos[1].data_ptr() if two else None,
            h_outer, h_inner, bodies[0].data_ptr(),
            bodies[1].data_ptr() if two else None, b_outer, b_inner,
            taps_flipped.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if two else None, rows, C, kp, out_len,
            len(xs), runs, stream)
    if err:
        raise RuntimeError(f"{RUN_OP} launch failed: "
                           f"{lib.depthwise_run_error_string(err).decode()}")
    kernel_paths.record(RUN_OP, True, key)
    return ys


def _launch_fir(xs, taps_flipped, out_len, key):
    """depthwise_fir_f32 on contiguous CUDA planes (VALID form, any kp)."""
    C, kp = taps_flipped.shape
    Tc = xs[0].shape[-1]
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
    ys = _outputs(xs, out_len)
    if out_len == 0 or rows == 0:
        return ys
    two = len(xs) == 2
    dev = xs[0].device
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
    kernel_paths.record(OP, True, key)
    return ys
