"""The streaming Viterbi's decode: wrapper, plain version and the CUDA
kernel `viterbi_stream_k7` (csrc/viterbi_stream.cu).

Not the port of a Pallas kernel: the JAX package runs `StreamingViterbi`
(qradiolink_tpu/fec/conv.py:166-220) and `viterbi_decode` (:93-145) as
per-step `lax.scan`s, which XLA compiles into device loops. Per row b,
over the S = lag + T steps of x = [tail | soft] (the `lag` pending soft
pairs carried in the state, then the block's T pairs), from the metrics
pm0, each operation rounded on its own:

    bm[hi, s'] = sum_i (e[hi, s', i] ? 255 - x[t, i] : x[t, i])  (i in order)
    cand[hi]   = pm[pred[hi, s']] + bm[hi, s']
    dec[t, s'] = cand[1] < cand[0]            (ties to hi = 0, as argmin)
    pm[s']     = min(cand[0], cand[1]);  pm -= min over the states

pm1 is pm after step T (pm0 when T = 0). The traceback starts at the
lowest-index minimum of pm after the last step and walks the decisions
back, s -> (s >> 1) | (dec[t, s] << (K - 2)), emitting s & 1 at each step;
the first T bits are the block's. With lag = 0 and an empty tail this is
`viterbi_decode`, whose final metrics are pm1.

On a CPU tensor the wrapper takes the plain version (the ACS loop over the
S steps, then the traceback loop); on a CUDA tensor it launches the kernel
`route(code)` names, or raises: `viterbi_stream_k7` (csrc/viterbi_stream.cu,
eight lanes a row, the code's polynomials compiled in) for the CCSDS code
{109, 79}, `viterbi_stream_warp_k7` (csrc/viterbi_stream_warp.cu, one warp
a row, the polynomials given at launch) for the other K=7 rate-1/2 codes.
`viterbi_stream_redux_k7` (csrc/viterbi_stream_redux.cu, one warp a row,
each step's minimum from the step before; CCSDS only) is a design the
route does not take, kept for timing in turns (`viterbi_stream_redux`), as
`viterbi_stream_warp` launches the warp kernel whatever the code. All
equal the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "viterbi_stream_k7"
OP_WARP = "viterbi_stream_warp_k7"
OP_REDUX = "viterbi_stream_redux_k7"
# the code viterbi_stream_k7 is compiled for
CCSDS_POLYS = (109, 79)


@functools.lru_cache(maxsize=8)
def _tables(code, device: torch.device):
    """pred (2, ns) int64 and, for each edge (hi, s'), the index of its
    branch metric among the 2^n patterns of expected bits (bit n-1-i set
    when output i is expected to be 1), (2, ns) int64."""
    pred = torch.from_numpy(code.pred.astype(np.int64)).to(device)
    w = 1 << np.arange(code.n - 1, -1, -1)
    idx = (code.edge_out.astype(np.int64) * w).sum(-1)
    return pred, torch.from_numpy(idx).to(device)


def pattern_metrics(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., n) soft values -> (..., 2^n) branch metrics, pattern p's
    expected bit i being bit n-1-i of p: sum_i (e_i ? 255 - x_i : x_i),
    added in order of i."""
    flip = 255.0 - x
    out = []
    for p in range(1 << n):
        acc = None
        for i in range(n):
            v = flip[..., i] if (p >> (n - 1 - i)) & 1 else x[..., i]
            acc = v if acc is None else acc + v
        out.append(acc)
    return torch.stack(out, dim=-1)


def viterbi_stream_plain(code, pm0, tail, soft):
    """Plain PyTorch version of viterbi_stream: the ACS a step at a time,
    then the traceback a step at a time."""
    B, T, n = soft.shape
    lag = tail.shape[1]
    S = lag + T
    ns = code.num_states
    pred, idx = _tables(code, soft.device)
    x = torch.cat([tail, soft], dim=1)
    bm = pattern_metrics(x, n)                       # (B, S, 2^n)
    pm, pm1 = pm0, pm0
    decs = torch.empty((S, B, ns), dtype=torch.bool, device=soft.device)
    for t in range(S):
        cand = pm[:, pred] + bm[:, t, idx]           # (B, 2, ns)
        dec = cand[:, 1] < cand[:, 0]
        new = torch.where(dec, cand[:, 1], cand[:, 0])
        pm = new - new.min(dim=-1, keepdim=True).values
        decs[t] = dec
        if t == T - 1:
            pm1 = pm
    s = torch.argmin(pm, dim=-1)                     # first minimum
    hi_shift = code.K - 2
    bits = torch.empty((B, S), dtype=torch.uint8, device=soft.device)
    for t in range(S - 1, -1, -1):
        bits[:, t] = (s & 1).to(torch.uint8)
        d = decs[t].gather(1, s[:, None])[:, 0].long()
        s = (s >> 1) | (d << hi_shift)
    return pm1, bits[:, :T]


def shape_key(soft, lag: int) -> str:
    """A call's key in the launch report: rows, steps and lag."""
    return f"R{soft.shape[0]} T{soft.shape[1]} lag{lag}"


def route(code) -> str:
    """The kernel that decodes `code` on the card: viterbi_stream_k7 for
    the CCSDS code, viterbi_stream_warp_k7 for other K=7 rate-1/2 codes."""
    return OP if tuple(code.polys) == CCSDS_POLYS else OP_WARP


# op -> (csrc source, C entry, error-string entry)
_ENTRIES = {OP: ("viterbi_stream", "viterbi_stream_k7",
                 "viterbi_stream_error_string"),
            OP_WARP: ("viterbi_stream_warp", "viterbi_stream_warp_k7",
                      "viterbi_stream_warp_error_string"),
            OP_REDUX: ("viterbi_stream_redux", "viterbi_stream_redux_k7",
                       "viterbi_stream_redux_error_string")}


def _lib(op: str):
    src, entry, err = _ENTRIES[op]
    lib = kernels.load(src)
    if not getattr(lib, "_qrl_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, entry).argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, err).argtypes = [i]
        getattr(lib, err).restype = ctypes.c_char_p
        if op == OP:
            lib.viterbi_stream_scratch_steps.argtypes = [i]
            lib.viterbi_stream_scratch_steps.restype = i
        lib._qrl_bound = True
    return lib


def viterbi_stream(code, pm0, tail, soft):
    """One streamed block: pm0 (B, ns) f32 carried metrics, tail (B, lag, n)
    f32 pending soft pairs, soft (B, T, n) f32 in [0, 255] -> (pm1 (B, ns)
    the metrics after the first T steps, bits (B, T) uint8)."""
    return _decode(route(code), code, pm0, tail, soft)


def viterbi_stream_warp(code, pm0, tail, soft):
    """viterbi_stream on viterbi_stream_warp_k7 whatever the code (the
    design the CCSDS code had before, for timing the two in turns)."""
    return _decode(OP_WARP, code, pm0, tail, soft)


def viterbi_stream_redux(code, pm0, tail, soft):
    """viterbi_stream on viterbi_stream_redux_k7 (one warp a row; the CCSDS
    code only), for timing it in turns with the route."""
    return _decode(OP_REDUX, code, pm0, tail, soft)


def _decode(op, code, pm0, tail, soft):
    if soft.ndim != 3 or tail.ndim != 3 or pm0.ndim != 2 \
            or soft.shape[-1] != code.n or tail.shape[-1] != code.n \
            or tail.shape[0] != soft.shape[0] \
            or tuple(pm0.shape) != (soft.shape[0], code.num_states) \
            or not (soft.dtype == tail.dtype == pm0.dtype == torch.float32) \
            or not (soft.device == tail.device == pm0.device):
        raise ValueError(
            f"expected f32 pm0 (B, {code.num_states}), tail (B, lag, "
            f"{code.n}) and soft (B, T, {code.n}) on one device; got "
            f"{tuple(pm0.shape)} {tuple(tail.shape)} {tuple(soft.shape)}")
    dev = soft.device
    B, T, _ = soft.shape
    lag = tail.shape[1]
    key = shape_key(soft, lag)
    if dev.type == "cpu":
        kernel_paths.record(op, False, key)
        return viterbi_stream_plain(code, pm0, tail, soft)
    if dev.type != "cuda":
        raise ValueError(f"no {op} kernel for device {dev}")
    if code.K != 7 or code.n != 2:
        raise ValueError(f"{op} decodes K=7 rate-1/2 codes only")
    soft, tail, pm0 = soft.contiguous(), tail.contiguous(), pm0.contiguous()
    S = lag + T
    pm1 = torch.empty_like(pm0)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    if B == 0:
        return pm1, bits
    if S == 0:
        return pm1.copy_(pm0), bits
    # 64-bit words of decisions, one a step (viterbi_stream_k7: byte g for
    # lane g, bit r for its register r, its rows padded to whole chunks;
    # the others: bit l for state 2l, bit 32 + l for 2l + 1)
    lib = _lib(op)
    steps = lib.viterbi_stream_scratch_steps(S) if op == OP else S
    decs = torch.empty((B, steps), dtype=torch.int64, device=dev)
    _, entry, err_entry = _ENTRIES[op]
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            tail.data_ptr(), soft.data_ptr(), pm0.data_ptr(),
            pm1.data_ptr(), decs.data_ptr(), bits.data_ptr(), B, T, lag,
            code.polys[0], code.polys[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{op} launch failed: "
                           f"{getattr(lib, err_entry)(err).decode()}")
    kernel_paths.record(op, True, key)
    return pm1, bits
