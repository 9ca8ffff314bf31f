"""Convolutional coding (port of qradiolink_tpu/fec/conv.py): code tables,
the encoder, the soft-decision Viterbi decoder, its streaming form and
depuncturing.

CCSDS K=7 r=1/2 with GNU Radio's cc_encoder bit ordering (polys {109, 79},
bit-reversed relative to the classic {0o133, 0o171}; the LSB of a
polynomial taps the newest bit). Soft decisions are floats in [0, 255],
128 an erasure. `viterbi_decode` and `StreamingViterbi` run the ACS and
traceback of fec/viterbi_stream_cuda.py: on CUDA tensors the kernel
`viterbi_stream_k7`, on CPU tensors its plain loop.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import resolve_device
from qradiolink_tpu_torch.fec.viterbi_stream_cuda import viterbi_stream


def _parity(x: np.ndarray) -> np.ndarray:
    p = x.copy()
    for s in (16, 8, 4, 2, 1):
        p ^= p >> s
    return p & 1


class ConvCode:
    """Rate 1/n feed-forward convolutional code.

    At time t the encoder window is w = b[t] | b[t-1]<<1 | ... |
    b[t-K+1]<<(K-1); output_i = parity(poly_i & w). State = previous K-1
    bits, newest at LSB. All tables are numpy.
    """

    def __init__(self, k: int, polys):
        self.K = int(k)
        self.polys = tuple(int(p) for p in polys)
        self.n = len(self.polys)
        ns = 1 << (self.K - 1)
        self.num_states = ns
        s = np.arange(ns, dtype=np.uint32)
        tables = []
        for b in (0, 1):
            w = (s << 1) | b
            outs = [_parity(w & p) for p in self.polys]
            tables.append((w & (ns - 1), np.stack(outs, axis=-1)))
        self.next_state = np.stack([tables[0][0], tables[1][0]])   # (2, ns)
        self.outputs = np.stack([tables[0][1], tables[1][1]])      # (2, ns, n)
        # state s' has predecessors (s'>>1) | (hi << (K-2)), hi in {0, 1},
        # reached with input bit s' & 1
        sp = np.arange(ns, dtype=np.uint32)
        self.pred = np.stack([sp >> 1, (sp >> 1) | (1 << (self.K - 2))])
        self.pred_bit = (sp & 1).astype(np.uint32)
        # expected outputs along each predecessor edge
        self.edge_out = np.stack([self.outputs[self.pred_bit, self.pred[hi]]
                                  for hi in (0, 1)])       # (2, ns, n)


CCSDS_K7 = ConvCode(7, (109, 79))


def conv_encode(code: ConvCode, bits: torch.Tensor,
                init_state: int = 0) -> torch.Tensor:
    """bits (..., T) {0,1} -> coded (..., T*n), streams interleaved per
    input bit."""
    K = code.K
    hist = torch.tensor([(init_state >> i) & 1 for i in range(K - 1)][::-1],
                        dtype=bits.dtype, device=bits.device)
    return encode_after(code, bits, hist)


def encode_after(code: ConvCode, bits: torch.Tensor,
                 hist: torch.Tensor) -> torch.Tensor:
    """conv_encode of bits (..., T) after the K-1 bits hist (oldest first;
    (K-1,) or (..., K-1)): the XOR of shifted bit streams a polynomial."""
    K = code.K
    T = bits.shape[-1]
    hist = hist.expand(tuple(bits.shape[:-1]) + (K - 1,))
    bx = torch.cat([hist, bits], dim=-1)
    outs = []
    for p in code.polys:
        acc = torch.zeros_like(bits)
        for j in range(K):
            if (p >> j) & 1:
                acc = acc ^ bx[..., K - 1 - j: K - 1 - j + T]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(tuple(bits.shape[:-1])
                                             + (T * code.n,))


def viterbi_decode(code: ConvCode, soft: torch.Tensor,
                   start_metric: torch.Tensor | None = None):
    """Soft Viterbi decode: soft (..., T, n) in [0, 255] (255 a confident
    1, 0 a confident 0, 128 an erasure) -> (bits (..., T) uint8, final
    metrics (..., num_states)). The traceback starts at the best end
    state; start_metric pins the start metrics (zeros by default)."""
    ns = code.num_states
    lead = tuple(soft.shape[:-2])
    T = soft.shape[-2]
    x = soft.float().reshape((-1, T, code.n))
    B = x.shape[0]
    if start_metric is None:
        pm0 = torch.zeros((B, ns), dtype=torch.float32, device=soft.device)
    else:
        pm0 = start_metric.float().reshape((-1, ns)).expand(B, ns)
    tail = x.new_empty((B, 0, code.n))
    pm, bits = viterbi_stream(code, pm0, tail, x)
    return bits.reshape(lead + (T,)), pm.reshape(lead + (ns,))


class StreamingViterbi:
    """Continuous Viterbi with carried path metrics and delayed decisions:
    each call consumes T soft pairs and emits T bits, delayed by `lag`
    symbols (the traceback depth). State: (metrics (..., ns) f32 at the
    emission horizon, the `lag` pending soft pairs (..., lag, n) f32), so
    the output does not depend on how the stream is blocked."""

    def __init__(self, code: ConvCode = None, lag: int = 64,
                 lead_shape: tuple = (), device=None):
        self.code = code or CCSDS_K7
        self.lag = int(lag)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        ns = self.code.num_states
        pm = torch.zeros(self.lead_shape + (ns,), dtype=torch.float32,
                         device=self.device)
        tail = torch.full(self.lead_shape + (self.lag, self.code.n), 128.0,
                          dtype=torch.float32, device=self.device)
        return (pm, tail)

    def __call__(self, state, soft):
        """soft: (..., T, n) -> bits (..., T) uint8 (delayed by lag)."""
        pm0, tail = state
        lead = tuple(soft.shape[:-2])
        T, n = soft.shape[-2], self.code.n
        ns = self.code.num_states
        x = soft.float().reshape((-1, T, n))
        tb = tail.reshape((-1, self.lag, n))
        pm1, bits = viterbi_stream(self.code, pm0.reshape((-1, ns)), tb, x)
        # the new pending pairs: the last lag of [tail | soft]
        if T >= self.lag:
            new_tail = x[:, T - self.lag:].clone()
        else:
            new_tail = torch.cat([tb[:, T:], x], dim=1)
        return ((pm1.reshape(lead + (ns,)),
                 new_tail.reshape(lead + (self.lag, n))),
                bits.reshape(lead + (T,)))


def depuncture(soft: torch.Tensor, pattern, n: int = 2) -> torch.Tensor:
    """Insert neutral (128) soft values at punctured positions.

    pattern: 0/1 over the coded-bit cycle (1 = transmitted). soft: (..., Tp)
    received soft bits; returns (..., Tc // n, n) with Tc = Tp *
    len(pattern) / sum(pattern)."""
    pat = np.asarray(pattern, dtype=bool)
    kept = int(pat.sum())
    Tp = soft.shape[-1]
    if Tp % kept != 0:
        raise ValueError(
            "soft length not a multiple of puncture pattern keeps")
    lead = tuple(soft.shape[:-1])
    cycles = Tp // kept
    Tc = cycles * pat.size
    out = torch.full(lead + (cycles, pat.size), 128.0, dtype=soft.dtype,
                     device=soft.device)
    idx = torch.from_numpy(np.nonzero(pat)[0]).to(soft.device)
    out[..., idx] = soft.reshape(lead + (cycles, kept))
    return out.reshape(lead + (Tc // n, n))
