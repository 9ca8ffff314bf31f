"""Multiplicative descrambler (port of Descrambler in
qradiolink_tpu/fec/scrambler.py).

Tap convention (mirroring the GNU Radio LFSR, where mask bit i taps the
output from `length - i + 1` steps ago):

  ages = { length - i + 1 : mask bit i set }
  descrambler:  y[n] = x[n] XOR (XOR_{d in ages} x[n-d])

Feed-forward in the received bits, so a block is a handful of shifted XORs;
the last max(ages) input bits are the carried state.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device


def _mask_ages(mask: int, length: int):
    ages = [length - i + 1 for i in range(length + 1) if (mask >> i) & 1]
    ages = sorted(d for d in ages if d >= 1)
    if not ages:
        raise ValueError("scrambler mask selects no taps")
    return ages


class Descrambler(Block):
    def __init__(self, mask: int = 0x8A, seed: int = 0x7F, length: int = 7,
                 lead_shape: tuple = (), device=None):
        self.ages = _mask_ages(mask, length)
        self.depth = max(self.ages)
        self.seed = int(seed) & ((1 << self.depth) - 1)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        # the last `depth` INPUT bits, hist[m] = x[m - depth]; x[-(j+1)] is
        # seed bit j
        D = self.depth
        hist = [(self.seed >> (D - 1 - m)) & 1 for m in range(D)]
        h = torch.tensor(hist, dtype=torch.uint8, device=self.device)
        return h.expand(self.lead_shape + (D,)).contiguous()

    def __call__(self, state, bits):
        T = bits.shape[-1]
        D = self.depth
        xb = torch.cat([state, bits.to(torch.uint8)], dim=-1)
        y = bits.to(torch.uint8)
        for d in self.ages:
            y = y ^ xb[..., D - d: D - d + T]
        return xb[..., xb.shape[-1] - D:], y
