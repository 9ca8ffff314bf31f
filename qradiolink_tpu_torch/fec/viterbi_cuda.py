"""Tiled Viterbi decode of overlapped windows: wrappers, plain versions and
the CUDA kernels `viterbi_tiled_k7` (csrc/viterbi.cu) and `viterbi_bfly_k7`
(csrc/viterbi_bfly.cu).

Port of the Pallas TPU kernel qradiolink_tpu/fec/viterbi_pallas.py
`decode_windows`: each of R tile rows of soft pairs runs add-compare-select
over S steps from zero metrics, picks the lowest-index best end state and
traces back, giving the bits of steps keep_from .. S-1. The plain version is
a transcription of the jnp path of qradiolink_tpu/fec/conv_ff.py
(`viterbi_decode_tiled`), op for op, so both round alike on non-integer
soft values; its traceback walks an integer state instead of a one-hot
vector, which gives the same bits.

Two forms:
  * `decode_windows(code, win, keep_from)` decodes prebuilt windows
    (R, S, n) on `viterbi_tiled_k7`;
  * `decode_stream(code, state, soft, chunk, overlap)` is one streamed
    block of `TiledViterbi`: the windows of [state | soft | pad] are read
    in place by `viterbi_bfly_k7`, which writes only the block's bits and
    the new carried tail. `decode_stream_tiled` is the same function
    composed in PyTorch around a window decoder (the plain version, and the
    route of codes the new kernel does not take).

On a CPU tensor a wrapper takes the plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "viterbi_tiled_k7"
BFLY_OP = "viterbi_bfly_k7"


def edge_metric_tables(code):
    """Branch-metric tables in FMA form (port of conv_ff._edge_metric_tables):

    bm_d[s'] = sum_i (e_d[s',i] ? 255 - soft_i : soft_i)
             = c_d[s'] + a_d0[s']*soft_0 + a_d1[s']*soft_1
    with a = 1-2e and c = 255*sum(e). Returns (a0, a1, c, flip) numpy, a_d
    (ns, n) and c (2, ns); flip when the high edge is the complement of the
    low one (bm1 = 255*n - bm0), as for CCSDS.
    """
    e0 = code.edge_out[0].astype(np.float32)
    e1 = code.edge_out[1].astype(np.float32)
    a0 = 1.0 - 2.0 * e0
    a1 = 1.0 - 2.0 * e1
    c = np.stack([255.0 * e0.sum(-1), 255.0 * e1.sum(-1)])
    flip = bool(np.all(e1 == 1.0 - e0))
    return a0, a1, c, flip


@functools.lru_cache(maxsize=8)
def _tables(code, device: torch.device):
    """Tables on `device`: a0 (ns, n), a1 (ns, n), c (2, ns) as f32 tensors,
    the kernel's (ns, 6) rows [a00 a01 a10 a11 c0 c1] (n = 2 codes only),
    and flip."""
    a0, a1, c, flip = edge_metric_tables(code)

    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            device)

    tab = None
    if code.n == 2:
        tab = t(np.stack([a0[:, 0], a0[:, 1], a1[:, 0], a1[:, 1], c[0], c[1]],
                         axis=-1))
    return t(a0), t(a1), t(c), tab, flip


def decode_windows_plain(code, win: torch.Tensor, keep_from: int):
    """Plain PyTorch version of decode_windows."""
    R, S, n = win.shape
    ns = code.num_states
    half = ns // 2
    a0, a1, c, _, flip = _tables(code, win.device)
    pm = torch.zeros((R, ns), dtype=torch.float32, device=win.device)
    decs = []
    for t in range(S):
        # predecessors of ascending s': the two halves of pm, each entry
        # repeated twice
        lo = pm[:, :half].repeat_interleave(2, dim=-1)
        hi = pm[:, half:].repeat_interleave(2, dim=-1)
        soft_t = win[:, t, :]
        bm0 = c[0]
        for i in range(n):
            bm0 = bm0 + a0[:, i] * soft_t[:, i:i + 1]
        cand0 = lo + bm0
        if flip:
            cand1 = (hi - bm0) + 255.0 * n
        else:
            bm1 = c[1]
            for i in range(n):
                bm1 = bm1 + a1[:, i] * soft_t[:, i:i + 1]
            cand1 = hi + bm1
        decs.append(cand1 < cand0)
        pm = torch.minimum(cand0, cand1)
    # end state: lowest index among the metric minima
    best = torch.min(pm, dim=-1, keepdim=True).values
    sidx = torch.arange(ns, device=win.device)
    s = torch.where(pm == best, sidx, ns).min(dim=-1).values
    hi_bit = code.K - 2
    bits = torch.empty((R, S - keep_from), dtype=torch.uint8,
                       device=win.device)
    for t in range(S - 1, keep_from - 1, -1):
        bits[:, t - keep_from] = (s & 1).to(torch.uint8)
        d = decs[t].gather(1, s[:, None])[:, 0].long()
        s = (s >> 1) | (d << hi_bit)
    return bits


def _lib():
    lib = kernels.load("viterbi")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_tiled_k7.argtypes = [p, p, p, i, i, i, i, p]
        lib.viterbi_tiled_k7.restype = ctypes.c_int
        lib.viterbi_smem_per_row.argtypes = [i]
        lib.viterbi_smem_per_row.restype = ctypes.c_longlong
        lib.viterbi_error_string.argtypes = [i]
        lib.viterbi_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def decode_windows(code, win: torch.Tensor, keep_from: int) -> torch.Tensor:
    """win: (R, S, n) f32 soft windows in [0, 255] -> bits (R, S-keep_from)
    uint8, the decisions of steps keep_from .. S-1 of each row."""
    if win.ndim != 3 or win.shape[-1] != code.n or win.dtype != torch.float32:
        raise ValueError(f"win must be f32 (R, S, {code.n}), got "
                         f"{win.dtype} {tuple(win.shape)}")
    R, S, _ = win.shape
    if not 0 <= keep_from <= S:
        raise ValueError(f"keep_from {keep_from} outside [0, {S}]")
    shape = f"R{R} S{S}"
    if win.device.type == "cpu":
        kernel_paths.record(OP, False, shape)
        return decode_windows_plain(code, win, keep_from)
    if win.device.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {win.device}")
    if code.n != 2 or code.num_states != 64:
        raise ValueError(f"{OP} decodes K=7 rate-1/2 codes only")
    if S * 510.0 >= 2 ** 24:
        raise ValueError(f"{S} steps overflow exact f32 path metrics")
    if not win.is_contiguous():
        raise ValueError("win must be contiguous")
    lib = _lib()
    if lib.viterbi_smem_per_row(S) > kernels.SMEM_MAX:
        raise ValueError(f"{S} steps need more shared memory than a block "
                         f"has")
    _, _, _, tab, flip = _tables(code, win.device)
    bits = torch.empty((R, S - keep_from), dtype=torch.uint8,
                       device=win.device)
    if R == 0 or S == keep_from:
        return bits
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        err = lib.viterbi_tiled_k7(win.data_ptr(), bits.data_ptr(),
                                   tab.data_ptr(), R, S, keep_from,
                                   int(flip), stream)
    if err:
        raise RuntimeError(f"{OP} launch failed: "
                           f"{lib.viterbi_error_string(err).decode()}")
    kernel_paths.record(OP, True, shape)
    return bits


def overlap_windows(x: torch.Tensor, L: int, W: int) -> torch.Tensor:
    """(..., T, n) -> (..., C, W+L+W, n) overlapped chunk windows; T must be
    a multiple of L, and warm-up samples outside the stream are 128."""
    if L < W:
        raise ValueError("chunk length must be >= overlap")
    lead = tuple(x.shape[:-2])
    n = x.shape[-1]
    pad = torch.full(lead + (W, n), 128.0, dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x, pad], dim=-2)
    # window c covers padded [c*L, c*L + L + 2W): x[c*L - W, (c+1)*L + W)
    win = xp.unfold(-2, L + 2 * W, L)           # (..., C, n, W+L+W)
    return win.transpose(-1, -2)


def decode_tiled(code, soft: torch.Tensor, L: int, W: int,
                 decode=None) -> torch.Tensor:
    """soft (..., T, n), T a multiple of L -> bits (..., T) uint8: every
    chunk of L decoded in its window of W+L+W steps by `decode` (a window
    decoder, `decode_windows` by default)."""
    lead = tuple(soft.shape[:-2])
    T = soft.shape[-2]
    if T % L:
        raise ValueError(f"{T} symbols not a multiple of chunk {L}")
    win = overlap_windows(soft.float(), L, W)
    R = T // L
    for d in lead:
        R *= d
    bits = (decode or decode_windows)(
        code, win.reshape(R, L + 2 * W, code.n).contiguous(), W)
    return bits[:, :L].reshape(lead + (T,))


def decode_stream_tiled(code, state: torch.Tensor, soft: torch.Tensor,
                        chunk: int, overlap: int, decode=None):
    """One streamed block composed in PyTorch: x = [state | soft | 128 pad
    to a multiple of chunk], x's bits by `decode_tiled`, the new tail
    x[T : T+W]. Returns (new_tail (..., W, n), bits (..., T))."""
    W = int(overlap)
    T = soft.shape[-2]
    parts = [state, soft.float()]
    pad = (-(T + W)) % chunk
    if pad:
        parts.append(torch.full(tuple(soft.shape[:-2]) + (pad, code.n),
                                128.0, dtype=torch.float32,
                                device=soft.device))
    x = torch.cat(parts, dim=-2)
    bits = decode_tiled(code, x, int(chunk), W, decode)
    return x[..., T: W + T, :], bits[..., W: W + T]


def decode_stream_plain(code, state, soft, chunk: int, overlap: int):
    """Plain PyTorch version of decode_stream."""
    return decode_stream_tiled(code, state, soft, chunk, overlap,
                               decode_windows_plain)


def _bfly_lib():
    lib = kernels.load("viterbi_bfly")
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_bfly_k7.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.viterbi_bfly_k7.restype = ctypes.c_int
        lib.viterbi_bfly_smem.argtypes = [i]
        lib.viterbi_bfly_smem.restype = ctypes.c_longlong
        lib.viterbi_bfly_error_string.argtypes = [i]
        lib.viterbi_bfly_error_string.restype = ctypes.c_char_p
        lib._qrl_bound = True
    return lib


def decode_stream(code, state: torch.Tensor, soft: torch.Tensor,
                  chunk: int = 128, overlap: int = 32):
    """One streamed block of TiledViterbi. state (..., W, n) f32, the last W
    soft pairs of the stream so far; soft (..., T, n) in [0, 255]. Returns
    (new_tail (..., W, n), bits (..., T) uint8): the decisions of this
    block's T pairs, each decoded in the window of its chunk of
    x = [state | soft | pad]. On CUDA the CCSDS code {109, 79} runs
    viterbi_bfly_k7, which reads the windows in place; other codes run the
    windows through decode_windows."""
    L, W = int(chunk), int(overlap)
    T = soft.shape[-2]
    lead = tuple(soft.shape[:-2])
    if (tuple(state.shape) != lead + (W, code.n)
            or soft.shape[-1] != code.n):
        raise ValueError(f"state {tuple(state.shape)} and soft "
                         f"{tuple(soft.shape)} do not match (..., {W}, "
                         f"{code.n}) and (..., T, {code.n})")
    if L < W:
        raise ValueError("chunk length must be >= overlap")
    n_ch = 1
    for d in lead:
        n_ch *= d
    C = -(-(T + W) // L)
    S = L + 2 * W
    shape = f"R{n_ch * C} S{S}"
    if soft.device.type == "cpu":
        kernel_paths.record(BFLY_OP, False, shape)
        return decode_stream_plain(code, state, soft, L, W)
    if soft.device.type != "cuda":
        raise ValueError(f"no {BFLY_OP} kernel for device {soft.device}")
    if code.K != 7 or code.polys != (109, 79):
        # the kernel's branch-metric patterns are CCSDS {109, 79}'s
        return decode_stream_tiled(code, state, soft, L, W)
    if state.dtype != torch.float32 or soft.dtype != torch.float32:
        raise ValueError("state and soft must be f32")
    if not (state.is_contiguous() and soft.is_contiguous()):
        raise ValueError("state and soft must be contiguous")
    if state.device != soft.device:
        raise ValueError("state and soft must be on one device")
    if state.data_ptr() % 8 or soft.data_ptr() % 8:
        raise ValueError("state and soft must be 8-byte aligned")
    if S * 510.0 >= 2 ** 24:
        raise ValueError(f"{S} steps overflow exact f32 path metrics")
    lib = _bfly_lib()
    if lib.viterbi_bfly_smem(S) > kernels.SMEM_MAX:
        raise ValueError(f"{S} steps need more shared memory than a block "
                         f"has")
    bits = torch.empty(lead + (T,), dtype=torch.uint8, device=soft.device)
    tail = torch.empty(lead + (W, code.n), dtype=torch.float32,
                       device=soft.device)
    if n_ch == 0:
        return tail, bits
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream(soft.device).cuda_stream
        err = lib.viterbi_bfly_k7(state.data_ptr(), soft.data_ptr(),
                                  bits.data_ptr(), tail.data_ptr(), n_ch, T,
                                  L, W, stream)
    if err:
        raise RuntimeError(f"{BFLY_OP} launch failed: "
                           f"{lib.viterbi_bfly_error_string(err).decode()}")
    kernel_paths.record(BFLY_OP, True, shape)
    return tail, bits
