"""Polyphase rational resampler at L > 1: wrapper, plain version and the
five CUDA kernels that compute it, `resample_poly_f32`
(csrc/resample_poly.cu), `resample_up_f32` (csrc/resample_up.cu),
`resample_x2_f32` (csrc/resample_x2.cu), `resample_rat_f32`
(csrc/resample_rat.cu) and `resample_dec_f32` (csrc/resample_dec.cu).

Port of the Pallas TPU kernel qradiolink_tpu/ops/pallas_fir.py
`banded_fir` (K2), which the JAX package's RationalResampler runs once per
phase (qradiolink_tpu/ops/resample.py `_phases`). With q_r = floor(r*M/L)
and tf_r the flipped taps of phase r, over each row of the virtual stream
xc = [tail (K-1) | x (T)], T % M == 0:

    y[t*L + r] = sum_{j<K} tf_r[j] * xc[t*M + q_r + j]
    new state  = the last K-1 samples of xc, (..., 2, K-1)

Each kernel computes every phase, already interleaved, and the new state
in one launch, reading the tail in place from the state. All but
`resample_dec_f32` sum each output's taps in order from 0.0f, so their
outputs are equal bit for bit; `resample_dec_f32` sums by polyphase
columns and is held to the FIR's bound, except at the instances of its
taps-in-order form (`DEC_IN_ORDER`: the 2/25 K561 head), which keep
`resample_poly_f32`'s bits. One plane is real input (the new
state's second plane is zeros); two are the re and im planes of an
IqPair. `route(L, M, K, rows)` picks the kernel: `resample_x2_f32`, both
phases of 16 output times a thread, at L 2 M 1 (QpskMod's x2);
`resample_up_f32`, register-blocked over output times of one phase, at
L >= 3 and M <= 5 (the TX side's 125/1, 20/1, 25/4, 5/1 and 125/3);
`resample_poly_f32` at the interpolators' calls of few rows
(FEW_ROWS_MAX rows, L at most FEW_ROWS_MAX_L, M 1: the net path's L4 and
L2, the mixer's L6); `resample_rat_f32`, a thread a phase with its taps in
registers streaming its samples, at L >= 24 and the (M, K) it has an
instance for (MMDVM's TX 125/12 and MMDVMmulti's 25/24 at K 51,
MMDVMmulti's RX 24/25 at K 53, DSSS's TX 50/13 at K 2);
`resample_dec_f32`, the polyphase-column form with every phase's tap rows
on a block's warps, at L >= 2, M >= 25 and the (L, M, K) it has an
instance for (DMR's and M17's 3/125 heads, MMDVM's RX 12/125, the 2/25
heads; the 2/25 K561 head in its taps-in-order form, lanes walking rows,
and at up to IN_ORDER_FEW_ROWS rows on `resample_poly_f32`);
`resample_poly_f32`, one output a lane, elsewhere (the NBFM audio
resampler 2/5, DSSS's RX 13/50). `resample_phases`, the per-phase route
(one strided FIR a phase, then the interleave: DMR's head before
`resample_dec_f32`), is on no route and stays as the alternative timed in
turns.

On a CPU tensor the wrapper takes the plain version (a strided F.conv1d
per phase over the concatenation, then the interleave) and records it
under the routed kernel's name; on a CUDA tensor it launches that kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from qradiolink_tpu_torch.ops import cuda_fir
from qradiolink_tpu_torch.ops.cuda_fir import no_tf32
from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "resample_poly_f32"
UP_OP = "resample_up_f32"
X2_OP = "resample_x2_f32"
RAT_OP = "resample_rat_f32"
DEC_OP = "resample_dec_f32"
# resample_up_f32's shapes: from 3 phases (the lowest L of
# scripts/resample_route_sweep.py, where it was 2.6-5.3x faster), and the
# decimations with a ring instance in csrc/resample_up.cu
UP_MIN_L = 3
UP_MAX_M = 5
# resample_rat_f32's shapes: from 24 phases to the 128 threads of its block
# (a thread a phase), and the (M, K) with an instance in
# csrc/resample_rat.cu (has_instance)
RAT_MIN_L, RAT_MAX_L = 24, 128
RAT_SHAPES = ((12, 51), (13, 2), (24, 51), (25, 53))
# resample_dec_f32's shapes: from 2 phases and a decimation of 25, the
# (L, M, K) with an instance in csrc/resample_dec.cu (seg_rows): DMR's and
# M17's 3/125 heads, MMDVM's RX 12/125, the 2/25 heads of 4FSK10KFM and
# 2FSK10K (and GMSK10K); and at L 1 the K2239 D50 head (GMSK2K's, 2FSK2K's,
# NBFM's, AM's) and SSB's K5597 D125 head, which ops/cuda_fir.route gives
# it (L 1 is a strided FIR: that module's DEC_SHAPES)
DEC_MIN_L, DEC_MIN_M = 2, 25
DEC_SHAPES = ((3, 125, 2091), (3, 125, 349), (12, 125, 523), (2, 25, 105),
              (2, 25, 561), (1, 50, 2239), (1, 125, 5597))
# the instances of resample_dec_f32's taps-in-order form
# (QRL_DEC_SEQ_INSTANCES): each output's taps added in order from 0.0f,
# resample_poly_f32's bits. The 2/25 head of 2FSK10K and GMSK10K: the
# column form's few-ulp differences from the CPU path there reached the
# Viterbi's path metrics past their bound (scripts/gmsk10k_card_cpu.py)
DEC_IN_ORDER = ((2, 25, 561),)
# calls of at most IN_ORDER_FEW_ROWS rows at a taps-in-order instance go to
# resample_poly_f32, the same bits and faster there: its lanes run one
# output each, the form's walk their rows serially. The turns that set it
# (scripts/resample_dec_shapes.py order; ms on an H100 80GB HBM3 at 700 W,
# resample_poly_f32 against the form, 2 planes): 1 to 64 rows x 125,000
# 0.0147-0.1985 against 0.1208-0.2071; 128 and 256 rows x 200,000 0.5968 /
# 0.3580 and 1.1783 / 0.5865.
IN_ORDER_FEW_ROWS = 64
# calls of at most FEW_ROWS_MAX rows at M 1 and L up to FEW_ROWS_MAX_L go
# to resample_poly_f32, whose one output a lane spreads a row over more
# SMs. The turns that set them (scripts/resample_dec_shapes.py rows, ms on
# an H100 80GB HBM3 at 700 W; resample_poly_f32 against the kernel of many
# rows): at 1 row the net path's L4 K12 0.0070 / 0.0208, L2 K46 0.0110 /
# 0.0270, the mixer's L6 K45 0.0072 / 0.0098, the 5/1 shapers 0.0067 /
# 0.0089 and 0.0072 / 0.0101, FreeDvMod's L125 K17 0.1155 / 0.0320; at 7
# rows L2 K46 0.0423 / 0.0271 (L4-L6 still 0.0067-0.0188 / 0.0090-0.0209);
# at 256 rows every one slower, 0.0299-2.5775 / 0.0122-0.4478.
FEW_ROWS_MAX = 1
FEW_ROWS_MAX_L = 6
_GRID_Y_MAX = 65_535


def phase_offsets(L: int, M: int) -> list:
    """q_r = floor(r*M/L): where phase r's windows start, r < L."""
    return [r * M // L for r in range(L)]


def resample_poly_plain(xs, phase_taps, L: int, M: int, tails):
    """Plain PyTorch version: per phase, F.conv1d with the flipped taps and
    stride M over [tail | x] from q_r, then the phases interleaved.
    Returns (new_state (..., 2, K-1), tuple of (..., T/M*L) planes)."""
    K = phase_taps.shape[1]
    n_pp = xs[0].shape[-1] // M
    ys, tails_new = [], []
    for x, t in zip(xs, tails):
        xc = torch.cat([t, x], dim=-1)
        lead = xc.shape[:-1]
        flat = xc.reshape(-1, 1, xc.shape[-1])
        phases = []
        # no output times (T = 0): no phase to filter, only the new state
        for r, q in enumerate(phase_offsets(L, M) if n_pp else ()):
            seg = flat[..., q: q + (n_pp - 1) * M + K]
            with no_tf32():
                phases.append(F.conv1d(seg, phase_taps[r].reshape(1, 1, K),
                                       stride=M))
        ys.append(torch.stack(phases, dim=-1).reshape(lead + (n_pp * L,))
                  if phases else xc.new_zeros(lead + (0,)))
        tails_new.append(xc[..., xc.shape[-1] - (K - 1):])
    if len(xs) == 1:
        tails_new.append(torch.zeros_like(tails_new[0]))
    return torch.stack(tails_new, dim=-2), tuple(ys)


def _check(xs, phase_taps, L, M, tails):
    if len(xs) not in (1, 2):
        raise ValueError(f"1 or 2 planes, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        if x.dtype != torch.float32 or x.shape != x0.shape \
                or x.device != x0.device or x.ndim < 1:
            raise ValueError("planes must be f32 tensors of one shape and "
                             "device")
    if phase_taps.ndim != 2 or phase_taps.shape[0] != L \
            or phase_taps.dtype != torch.float32 \
            or phase_taps.device != x0.device:
        raise ValueError(f"phase taps must be an ({L}, K) f32 tensor on the "
                         f"planes' device")
    K = phase_taps.shape[1]
    if L < 1 or M < 1 or K < 1 or x0.shape[-1] % M:
        raise ValueError(f"L {L}, M {M}, K {K}, block length "
                         f"{x0.shape[-1]}")
    if len(tails) != len(xs):
        raise ValueError("one tail per plane")
    for t in tails:
        if t.dtype != torch.float32 or t.device != x0.device \
                or tuple(t.shape) != tuple(x0.shape[:-1]) + (K - 1,):
            raise ValueError(f"tails must be f32 {tuple(x0.shape[:-1])} + "
                             f"({K - 1},) on the planes' device")
    return K


def shape_key(xs, L, K, M):
    """A call's key in the launch report: phases, taps a phase,
    decimation, and planes x rows."""
    rows = math.prod(xs[0].shape[:-1])
    return f"L{L} K{K} D{M} tail {len(xs)}x{rows}"


def route(L: int, M: int, K: int, rows: int | None = None) -> str:
    """The kernel that serves an L/M resampler of K taps a phase (L > 1)
    on `rows` rows (None: many). resample_x2_f32 at L 2 M 1 (QpskMod's x2,
    measured faster in turns than resample_poly_f32 in chip_smoke.py, and
    than resample_up_f32 at that shape as PERF.md records), resample_up_f32
    at L >= 3 and M <= 5, except at calls of few rows: at M 1, L <=
    FEW_ROWS_MAX_L and rows <= FEW_ROWS_MAX, resample_poly_f32, faster
    there in turns and bit-equal (the net path's L4 K12 and L2 K46, the
    mixer's L6 K45, the 5/1 shapers at one row; FreeDvMod's L125 K17
    stays on resample_up_f32; the turns at 1, 7 and 256 rows beside
    FEW_ROWS_MAX); resample_rat_f32 at 24 <= L <= 128 and an (M, K) of
    RAT_SHAPES (the wide rational shapes, where resample_poly_f32 lost
    1.1-4.5x to one F.conv1d: MMDVM's TX 125/12, MMDVMmulti's 25/24 and
    24/25, DSSS's TX 50/13); resample_dec_f32 at L >= 2, M >= 25 and an
    (L, M, K) of DEC_SHAPES (DMR's 3/125 head, K2091, which ran
    fir_long_f32 once a phase, and M17's at K349, MMDVM's RX 12/125 and
    the 2/25 heads, which ran resample_poly_f32, whose lanes each run a
    chain of K FMAs with two shared-memory loads apiece), except at its
    taps-in-order instances (DEC_IN_ORDER, the 2/25 K561 head) on calls of
    at most IN_ORDER_FEW_ROWS rows, which take resample_poly_f32 (the same
    bits, faster there in turns); resample_poly_f32 otherwise (the NBFM
    audio resampler 2/5, DSSS's RX 13/50).
    resample_x2_f32, resample_up_f32 and resample_poly_f32 stage all L*K
    taps in one block, and the wrapper raises where they do not fit."""
    if (M == 1 and L <= FEW_ROWS_MAX_L and rows is not None
            and rows <= FEW_ROWS_MAX):
        return OP
    if L == 2 and M == 1:
        return X2_OP
    if L >= UP_MIN_L and M <= UP_MAX_M:
        return UP_OP
    if RAT_MIN_L <= L <= RAT_MAX_L and (M, K) in RAT_SHAPES:
        return RAT_OP
    if ((L, M, K) in DEC_IN_ORDER and rows is not None
            and rows <= IN_ORDER_FEW_ROWS):
        return OP
    if L >= DEC_MIN_L and M >= DEC_MIN_M and (L, M, K) in DEC_SHAPES:
        return DEC_OP
    return OP


def _lib(op):
    name = op.removesuffix("_f32")
    lib = kernels.load(name)
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, op)
        fn.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [i, i, i] + ([i] if op == UP_OP else [])
        smem.restype = ctypes.c_longlong
        if op == OP:
            lib.resample_poly_empty.argtypes = [p]
            lib.resample_poly_empty.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def resample_phases(xs, phase_taps, L: int, M: int, tails):
    """The per-phase route, as the JAX package runs the resampler: one
    strided FIR a phase (cuda_fir.fir_stream with shift q_r, on the kernel
    cuda_fir.route(K, M) picks, or its plain version on the CPU), the
    phases interleaved, the new state [tail | x]'s last K-1 samples.
    resample_poly's arguments and result."""
    xs, tails = tuple(xs), tuple(tails)
    K = _check(xs, phase_taps, L, M, tails)
    T = xs[0].shape[-1]
    n_pp = T // M
    phases = [cuda_fir.fir_stream(xs, phase_taps[r], M, n_pp, tails=tails,
                                  shift=q)
              for r, q in enumerate(phase_offsets(L, M))]
    ys = tuple(torch.stack([p[i] for p in phases], dim=-1).reshape(
        xs[0].shape[:-1] + (n_pp * L,)) for i in range(len(xs)))
    new = [x[..., T - (K - 1):] if T >= K - 1
           else torch.cat([t, x], dim=-1)[..., T:] for x, t in zip(xs, tails)]
    if len(new) == 1:
        new.append(torch.zeros_like(new[0]))
    return torch.stack(new, dim=-2), ys


def resample_poly(xs, phase_taps, L: int, M: int, tails):
    """Polyphase L/M resampling of each plane in `xs`, all phases at once,
    on the kernel route(L, M, K, rows) names.

    xs: tuple of 1 or 2 f32 planes (..., T) of one shape, T % M == 0;
    phase_taps: (L, K) f32, row r phase r's taps reversed; tails: one
    (..., K-1) tail per plane, the carried input (strided views into the
    (..., 2, K-1) state do: it is read in place). Returns (new_state
    (..., 2, K-1), tuple of (..., T/M*L) planes, phase r of output time t
    at t*L + r)."""
    xs, tails = tuple(xs), tuple(tails)
    K = _check(xs, phase_taps, L, M, tails)
    op = route(L, M, K, math.prod(xs[0].shape[:-1]))
    dev = xs[0].device
    if dev.type == "cpu":
        kernel_paths.record(op, False, shape_key(xs, L, K, M))
        return resample_poly_plain(xs, phase_taps, L, M, tails)
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    return launch(op, xs, phase_taps, L, M, tails)


def launch(op, xs, phase_taps, L: int, M: int, tails, state: bool = True,
           key: str | None = None):
    """One launch of kernel `op` (OP, UP_OP, X2_OP, RAT_OP or DEC_OP) on
    CUDA planes, whatever the route: resample_poly's arguments and
    result. state False (DEC_OP only): the kernel writes no new state and
    the first item is None; key: the launch report's key (shape_key's by
    default)."""
    xs, tails = tuple(xs), tuple(tails)
    K = _check(xs, phase_taps, L, M, tails)
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    if op == UP_OP and M > UP_MAX_M:
        raise ValueError(f"{op} takes M <= {UP_MAX_M}, not {M}")
    if op == X2_OP and (L, M) != (2, 1):
        raise ValueError(f"{op} takes L 2 M 1 only, not L {L} M {M}")
    if op == RAT_OP and (M, K) not in RAT_SHAPES:
        raise ValueError(f"{op} has no instance for M {M}, K {K}")
    if op == DEC_OP and (L, M, K) not in DEC_SHAPES:
        raise ValueError(f"{op} has no instance for L {L}, M {M}, K {K}")
    if not state and op != DEC_OP:
        raise ValueError(f"{op} always writes the new state")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("planes must be contiguous")
    if not phase_taps.is_contiguous():
        raise ValueError("phase taps must be contiguous")
    lead, T = tuple(xs[0].shape[:-1]), xs[0].shape[-1]
    C = math.prod(lead)
    if op == OP and C > _GRID_Y_MAX:
        raise ValueError(f"{C} rows exceed the grid's {_GRID_Y_MAX}")
    tail_ld, tail_ptrs = K - 1, []
    for i, t in enumerate(tails):
        # a tail is a strided view into the (..., 2, K-1) state: rows at
        # one stride, samples adjacent (view() raises otherwise)
        tv = t.view(C, K - 1)
        if K > 2 and tv.stride(1) != 1:
            raise ValueError("tail samples must be adjacent in memory")
        if C > 1:
            if i and tv.stride(0) != tail_ld:
                raise ValueError("both tails need one row stride")
            tail_ld = tv.stride(0)
        tail_ptrs.append(t.data_ptr())
    lib = _lib(op)
    name = op.removesuffix("_f32")
    smem_args = (L, M, K, T) if op == UP_OP else (L, M, K)
    smem = getattr(lib, f"{name}_smem_bytes")(*smem_args)
    if smem < 0 or smem > kernels.SMEM_MAX:
        raise ValueError(f"L={L}, M={M}, K={K} needs more shared memory "
                         f"than a block of {op} has")
    n_out = T // M * L
    ys = tuple(torch.empty(lead + (n_out,), dtype=torch.float32, device=dev)
               for _ in xs)
    new_state = torch.empty(lead + (2, K - 1), dtype=torch.float32,
                            device=dev) if state else None
    if C == 0:
        return new_state, ys
    two = len(xs) == 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, op)(
            tail_ptrs[0], tail_ptrs[1] if two else None, tail_ld,
            xs[0].data_ptr(), xs[1].data_ptr() if two else None,
            phase_taps.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if two else None,
            new_state.data_ptr() if state else None, C, T, K, L, M, len(xs),
            stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{op} launch failed: {msg}")
    kernel_paths.record(op, True, key or shape_key(xs, L, K, M))
    return new_state, ys


def empty_launch(device) -> None:
    """One launch of an empty kernel on `device`'s current stream: the
    launch floor that chip_smoke.py prints beside resample_poly_f32."""
    lib = _lib(OP)
    with torch.cuda.device(device):
        err = lib.resample_poly_empty(
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: "
                           f"{lib.resample_poly_error_string(err).decode()}")
