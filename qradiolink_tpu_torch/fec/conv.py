"""Convolutional code tables and encoder (port of ConvCode, CCSDS_K7 and
conv_encode in qradiolink_tpu/fec/conv.py).

CCSDS K=7 r=1/2 with GNU Radio's cc_encoder bit ordering (polys {109, 79},
bit-reversed relative to the classic {0o133, 0o171}; the LSB of a
polynomial taps the newest bit). Soft decisions are floats in [0, 255],
128 an erasure.
"""

from __future__ import annotations

import numpy as np
import torch


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
    T = bits.shape[-1]
    hist = torch.tensor([(init_state >> i) & 1 for i in range(K - 1)][::-1],
                        dtype=bits.dtype, device=bits.device)
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
