"""Strided streaming FIR: wrapper, plain version and the CUDA kernels that
compute it, `fir_stream_f32` (csrc/fir.cu), `fir_decim_f32`
(csrc/fir_decim.cu), `fir_long_f32` (csrc/fir_long.cu), `fir_cols_f32`
(csrc/fir_cols.cu) and `fir_s1_f32` (csrc/fir_s1.cu), and the first design
of `fir_stream_f32`, `fir_stream_v0_f32` (csrc/fir_stream_v0.cu), which no
route names: `fir_stream_v0()` launches it for timing in turns.

Port of the two Pallas TPU kernels of qradiolink_tpu/ops/pallas_fir.py,
`banded_fir_stream` (K1) and `banded_fir` (K2), which compute the same
function:

    y[m] = sum_k h[k] * xc[m*D + shift + K-1-k],   m in [0, n_out)

over each row of the virtual stream xc = [tail | x] (K1, with a carried
tail of K-1 samples) or xc = x (K2, no tail). The TPU kernels' banded
matrices, 128-lane slabs and `plan()` gates have no counterpart here: every
call on a CUDA tensor launches a kernel and computes all n_out outputs.

`route(K, D)` picks the kernel from the shape, with A = ceil(K/D) taps a
phase:
- `fir_decim_f32`, the polyphase kernel with its taps in registers, at D
  32-64 and A <= 16 (the 4FSK resampler head, K 419 D 50);
- `fir_long_f32`, the same loop over up to 4 segments of phase rows and
  column groups of 64, at D >= 32 and A 17-64, with at most 8 warps
  (groups x segments) a block: the NBFM/AM head (K 2239 D 50) and the SSB
  head (K 5597 D 125) in every form but the resampler's (below);
- `fir_cols_f32`, a stride-1 FIR over each phase column, register-blocked
  over outputs, at D 2-31 and A 17-64: the WBFM head (K 225 D 5) and the
  WBFM audio resampler (K 1121 D 25);
- `fir_s1_f32`, register-blocked over outputs, for stride 1 with at most
  2,048 taps (the channel low-passes, the RRC, the audio filters);
- `fir_stream_f32` for every other shape: A <= 16 at D 2-31 or D > 64
  (FreeDV's head K1045 D125, 4FSK1KFM's K837 D100, 4FSK100K's K17 D2),
  A > 64, stride 1 above 2,048 taps. Its design (one stream of outputs a
  lane, a systolic ring of accumulators) takes any shape whose taps and
  rings fit a block's shared memory (`fir_stream_smem_bytes`), and rows
  past the grid's 65,535.
At the K2239 D50 head (NBFM's and AM's, the 2FSK/GMSK chains') and the
SSB head K5597 D125 (`DEC_SHAPES`), `route(K, D)` names `resample_dec_f32`
(csrc/resample_dec.cu, ops/cuda_resample.py) at L 1: `fir_long_f32`'s
segments, column groups and sum order, so the same bits, with each sample
staged once for all segments; in turns it ran 2.03x `fir_long_f32` at the
K2239 head's 2048 rows and 1.37-2.75x at 1 to 64 rows, and 1.59-2.81x at
SSB's 1 to 2048 rows (PERF.md), so no row count keeps `fir_long_f32`. It
computes the resampler's form (a tail, shift 0, every output of a block
of whole strides); other calls at those shapes take the FIR kernels'
route (`fir_route`, `stream_route`), and `RationalResampler._decimate`
keeps its `next_tail` state: the launch writes none.
`fir_s1_f32` and `fir_stream_v0_f32` sum in the order of `fir_stream_f32`,
so the three give equal bits; the polyphase kernels sum in other orders
and are held to the FIR's bound. Every default `RationalResampler(1, M)`
has A = 45 (its Kaiser design gives about 44.8 M taps), so each such head
takes one of the polyphase kernels. The rational resampler at L > 1 (the
NBFM audio resampler) is not a call of this wrapper: `ops/cuda_resample.py`
runs all its phases in one launch.

On a CPU tensor the wrapper takes the plain version (F.conv1d over the
explicit concatenation) and records it under the routed kernel's name; on a
CUDA tensor it launches that kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "fir_stream_f32"
V0_OP = "fir_stream_v0_f32"
DEC_OP = "resample_dec_f32"
DECIM_OP = "fir_decim_f32"
LONG_OP = "fir_long_f32"
COLS_OP = "fir_cols_f32"
S1_OP = "fir_s1_f32"
# fir_decim_f32's shapes: two phase columns a lane, and the kernel's
# instantiations A = ceil(K/D) = 1 .. 16 (csrc/fir_decim.cu)
DECIM_D = (32, 64)
DECIM_MAX_A = 16
# fir_long_f32's and fir_cols_f32's taps a phase: up to 4 segments of at
# most DECIM_MAX_A = 16 phase rows (csrc/fir_long.cu); fir_cols_f32 stages
# 64 taps a column (csrc/fir_cols.cu)
LONG_A = (17, 64)
# fir_long_f32's strides: two phase columns a lane from D 32, in column
# groups of 64, with G = ceil(D/64) groups x S = ceil(A/16) segments at
# most 8 warps a block
LONG_MIN_D = 32
LONG_GROUP_COLS = 64
LONG_MAX_WARPS = 8
# fir_cols_f32's strides: below fir_long_f32's, stride 1 being fir_s1_f32's
COLS_D = (2, 31)
# fir_s1_f32's longest filter: its taps and the span of a 1,024-output tile
# then take 22 KB of shared memory a block, which leaves room for several
# blocks an SM (csrc/fir_s1.cu)
S1_MAX_K = 2048
# resample_dec_f32's strided-FIR shapes, (K, D): its L 1 instances in
# csrc/resample_dec.cu (ops/cuda_resample.DEC_SHAPES), the K2239 D50 head
# and SSB's K5597 D125 head
DEC_SHAPES = ((2239, 50), (5597, 125))
_GRID_Y_MAX = 65_535


@contextlib.contextmanager
def no_tf32():
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
        with no_tf32():
            y = F.conv1d(seg, w, stride=stride)
        ys.append(y.reshape(lead + (n_out,)))
    return tuple(ys)


def _decim_takes(K: int, stride: int) -> bool:
    """Whether fir_decim_f32 computes a FIR of K taps and stride D."""
    lo, hi = DECIM_D
    return lo <= stride <= hi and -(-K // stride) <= DECIM_MAX_A


def _long_takes(K: int, stride: int) -> bool:
    """Whether fir_long_f32 computes a FIR of K taps and stride D."""
    A = -(-K // stride)
    if stride < LONG_MIN_D or not LONG_A[0] <= A <= LONG_A[1]:
        return False
    groups = -(-stride // LONG_GROUP_COLS)
    segments = -(-A // DECIM_MAX_A)
    return groups * segments <= LONG_MAX_WARPS


def _cols_takes(K: int, stride: int) -> bool:
    """Whether fir_cols_f32 computes a FIR of K taps and stride D."""
    lo, hi = COLS_D
    return lo <= stride <= hi and LONG_A[0] <= -(-K // stride) <= LONG_A[1]


def s1_takes(K: int, stride: int) -> bool:
    """Whether fir_s1_f32 computes a FIR of K taps and stride D."""
    return stride == 1 and K <= S1_MAX_K


def route(K: int, stride: int) -> str:
    """The kernel that serves a FIR of K taps and stride D in the
    resampler's form: resample_dec_f32 at a (K, D) of DEC_SHAPES, else
    fir_route(K, D)."""
    if (K, stride) in DEC_SHAPES:
        return DEC_OP
    return fir_route(K, stride)


def stream_route(K: int, stride: int, T: int, n_out: int, tails=None,
                 shift: int = 0) -> str:
    """The kernel fir_stream launches for a call: route(K, D), except that
    resample_dec_f32 computes only the resampler's form (a tail, shift 0,
    n_out * D == T); other calls take fir_route(K, D)."""
    op = route(K, stride)
    if op == DEC_OP and not (tails is not None and shift == 0
                             and n_out * stride == T):
        return fir_route(K, stride)
    return op


def fir_route(K: int, stride: int) -> str:
    """The FIR kernel that serves K taps and stride D, A = ceil(K/D):
    fir_decim_f32 at 32 <= D <= 64 and A <= 16; at 17 <= A <= 64,
    fir_long_f32 from D = 32 (at most 8 warps: ceil(D/64) * ceil(A/16) <=
    8) and fir_cols_f32 at 2 <= D <= 31; fir_s1_f32 for D = 1 and K <=
    2048; fir_stream_f32 otherwise."""
    if _decim_takes(K, stride):
        return DECIM_OP
    if _long_takes(K, stride):
        return LONG_OP
    if _cols_takes(K, stride):
        return COLS_OP
    if s1_takes(K, stride):
        return S1_OP
    return OP


def _lib(name, launch, error_string):
    """csrc/<name>.cu's library; the kernels' launchers take the same C
    arguments."""
    lib = kernels.load(name)
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, launch)
        fn.argtypes = [p, p, i, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [i]
        getattr(lib, error_string).restype = ctypes.c_char_p
        if name in ("fir", "fir_stream_v0"):
            smem = getattr(lib, f"{launch.removesuffix('_f32')}_smem_bytes")
            smem.argtypes = [i, i]
            smem.restype = ctypes.c_longlong
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
    op = stream_route(K, stride, T, n_out, tails, shift)
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(op, False, shape_key(xs, K, stride, tails))
        return fir_stream_plain(xs, taps_flipped, stride, n_out, tails,
                                shift)
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    if op == OP:
        return _launch_stream(xs, taps_flipped, stride, n_out, tails, shift)
    if op == DEC_OP:
        return _launch_dec(xs, taps_flipped, stride, tails)
    # fir_decim_f32, fir_long_f32, fir_cols_f32 or fir_s1_f32, at a shape
    # it takes
    C, tail_ptrs, tail_ld = _cuda_args(xs, taps_flipped, tails)
    name = op.removesuffix("_f32")
    lib = _lib(name, op, f"{name}_error_string")
    return _launch(op, getattr(lib, op), getattr(lib, f"{name}_error_string"),
                   xs, taps_flipped, stride, n_out, tails, shift, C,
                   tail_ptrs, tail_ld)


def _rows(x):
    n = 1
    for d in x.shape[:-1]:
        n *= d
    return n


def shape_key(xs, K, stride, tails):
    """A call's key in the launch report: taps, stride, whether it reads a
    tail, and planes x rows, which tells apart the stages that share K
    and D."""
    return (f"K{K} D{stride}" + (" tail" if tails is not None else "")
            + f" {len(xs)}x{_rows(xs[0])}")


def _cuda_args(xs, taps_flipped, tails):
    """(C, tail pointers, tail row stride) of planes on the card; raises on
    a layout the kernels do not take."""
    K = taps_flipped.shape[0]
    C = _rows(xs[0])
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
    return C, tail_ptrs, tail_ld


def _launch(op, fn, err_string, xs, taps_flipped, stride, n_out, tails,
            shift, C, tail_ptrs, tail_ld):
    """Allocate the outputs and launch one of the kernels (same C
    arguments) on the current stream; records the launch."""
    K = taps_flipped.shape[0]
    dev = xs[0].device
    ys = tuple(torch.empty(xs[0].shape[:-1] + (n_out,), dtype=torch.float32,
                           device=dev) for _ in xs)
    if n_out == 0:
        return ys
    two = len(xs) == 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tail_ptrs[0], tail_ptrs[1] if two else None, tail_ld,
                 xs[0].data_ptr(), xs[1].data_ptr() if two else None,
                 taps_flipped.data_ptr(), ys[0].data_ptr(),
                 ys[1].data_ptr() if two else None,
                 C, xs[0].shape[-1], K, stride, shift, n_out, len(xs),
                 stream)
    if err:
        raise RuntimeError(f"{op} launch failed: "
                           f"{err_string(err).decode()}")
    kernel_paths.record(op, True, shape_key(xs, K, stride, tails))
    return ys


def _launch_stream(xs, taps_flipped, stride, n_out, tails=None, shift=0):
    """fir_stream_f32 on CUDA planes, at any shape whose block fits the
    shared memory."""
    C, tail_ptrs, tail_ld = _cuda_args(xs, taps_flipped, tails)
    lib = _lib("fir", OP, "fir_error_string")
    if lib.fir_stream_smem_bytes(taps_flipped.shape[0], stride) \
            > kernels.SMEM_MAX:
        raise ValueError(f"K={taps_flipped.shape[0]}, D={stride} needs more "
                         f"shared memory than a block has")
    return _launch(OP, lib.fir_stream_f32, lib.fir_error_string, xs,
                   taps_flipped, stride, n_out, tails, shift, C, tail_ptrs,
                   tail_ld)


def _launch_dec(xs, taps_flipped, stride, tails):
    """resample_dec_f32 at L 1 on CUDA planes, the tails read in place, no
    state written; recorded under this wrapper's key."""
    from qradiolink_tpu_torch.ops import cuda_resample

    _, ys = cuda_resample.launch(
        DEC_OP, xs, taps_flipped[None], 1, stride, tails, state=False,
        key=shape_key(xs, taps_flipped.shape[0], stride, tails))
    return ys


def fir_long(xs, taps_flipped, stride: int, n_out: int, tails=None,
             shift: int = 0):
    """fir_long_f32 on CUDA planes at a shape it takes, whatever the route
    (the kernel the K2239 D50 head ran before resample_dec_f32; timed in
    turns with it)."""
    xs = tuple(xs)
    tails = None if tails is None else tuple(tails)
    K, _ = _check(xs, taps_flipped, stride, n_out, tails, shift)
    if xs[0].device.type != "cuda" or not _long_takes(K, stride):
        raise ValueError(f"no {LONG_OP} launch for K {K}, D {stride} on "
                         f"{xs[0].device}")
    C, tail_ptrs, tail_ld = _cuda_args(xs, taps_flipped, tails)
    lib = _lib("fir_long", LONG_OP, "fir_long_error_string")
    return _launch(LONG_OP, lib.fir_long_f32, lib.fir_long_error_string, xs,
                   taps_flipped, stride, n_out, tails, shift, C, tail_ptrs,
                   tail_ld)


def fir_stream_v0(xs, taps_flipped, stride: int, n_out: int, tails=None,
                  shift: int = 0):
    """fir_stream_f32's first design, `fir_stream_v0_f32`, which no route
    names: the plain version on CPU planes, the kernel on CUDA planes (one
    block a tile of 128 outputs and a row, so at most 65,535 rows)."""
    xs = tuple(xs)
    tails = None if tails is None else tuple(tails)
    K, _ = _check(xs, taps_flipped, stride, n_out, tails, shift)
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(V0_OP, False, shape_key(xs, K, stride, tails))
        return fir_stream_plain(xs, taps_flipped, stride, n_out, tails,
                                shift)
    if dev.type != "cuda":
        raise ValueError(f"no {V0_OP} kernel for device {dev}")
    C, tail_ptrs, tail_ld = _cuda_args(xs, taps_flipped, tails)
    if C > _GRID_Y_MAX:
        raise ValueError(f"{C} rows exceed the grid's {_GRID_Y_MAX}")
    lib = _lib("fir_stream_v0", V0_OP, "fir_stream_v0_error_string")
    if lib.fir_stream_v0_smem_bytes(K, stride) > kernels.SMEM_MAX:
        raise ValueError(f"K={K}, D={stride} needs more shared memory than "
                         f"a block has")
    return _launch(V0_OP, lib.fir_stream_v0_f32,
                   lib.fir_stream_v0_error_string, xs, taps_flipped, stride,
                   n_out, tails, shift, C, tail_ptrs, tail_ld)
