"""Multiplicative scrambler and descrambler (port of Scrambler and
Descrambler in qradiolink_tpu/fec/scrambler.py).

Tap convention (mirroring the GNU Radio LFSR, where mask bit i taps the
output from `length - i + 1` steps ago):

  ages = { length - i + 1 : mask bit i set }
  scrambler:    y[n] = x[n] XOR (XOR_{d in ages} y[n-d])
  descrambler:  y[n] = x[n] XOR (XOR_{d in ages} x[n-d])

The descrambler is feed-forward in the received bits, so a block is a
handful of shifted XORs; the last max(ages) input bits are the carried
state. The scrambler feeds its output back; the JAX package runs it as a
per-bit lax.scan, and here it is a few shifted XORs too (Scrambler's
docstring says how), so it costs O(log T) tensor ops a block, not O(T).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device

UINT32 = torch.uint32


def _mask_ages(mask: int, length: int):
    ages = [length - i + 1 for i in range(length + 1) if (mask >> i) & 1]
    ages = sorted(d for d in ages if d >= 1)
    if not ages:
        raise ValueError("scrambler mask selects no taps")
    return ages


def _xor_shifted(u: torch.Tensor, shifts) -> torch.Tensor:
    """u XOR (u delayed by each shift), zeros shifted in; shifts that
    reach past the end are dropped."""
    N = u.shape[-1]
    out = u.clone()
    for s in shifts:
        if s < N:
            out[..., s:] ^= u[..., :N - s]
    return out


class Scrambler(Block):
    """Output-feedback scrambler; state: the register (lead_shape) uint32,
    bit j the output bit from j+1 steps ago.

    Over GF(2) the recurrence is y * g = x with g(z) = 1 + sum_d z^d over
    the ages d. Since g(z)^2 = g(z^2) there, g^(2^k - 1) = prod_{j<k}
    g(z^(2^j)), and g^(2^k - 1) = g(z^(2^k)) / g agrees with 1/g in its
    first 2^k coefficients. So for a block of N <= 2^k bits, y = x_eff *
    prod_{j<k} g(z^(2^j)): k rounds of shifted XORs, the shifts d 2^j.
    x_eff is the block behind the `depth` bits of history that the register
    holds, each history bit turned into the input that reproduces it from
    zero history before it, so the product runs from zero state. Bit for
    bit the per-bit loop's output and register."""

    def __init__(self, mask: int = 0x8A, seed: int = 0x7F, length: int = 7,
                 lead_shape: tuple = (), device=None):
        self.ages = _mask_ages(mask, length)
        self.depth = max(self.ages)
        self.seed = int(seed) & ((1 << self.depth) - 1)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.full(self.lead_shape, self.seed, dtype=UINT32,
                          device=self.device)

    def __call__(self, state, bits):
        D = self.depth
        reg = state.to(torch.int64)
        # the history in time order, oldest first: y[i - D] = bit D-1-i
        sh = torch.arange(D - 1, -1, -1, device=bits.device)
        hist = ((reg[..., None] >> sh) & 1).to(torch.uint8)
        u = torch.cat([_xor_shifted(hist, self.ages),
                       bits.to(torch.uint8)], dim=-1)
        N = u.shape[-1]
        step = 1
        while step < N:
            u = _xor_shifted(u, [d * step for d in self.ages])
            step *= 2
        # the new register: the last D outputs, the newest at bit 0
        w = 1 << torch.arange(D - 1, -1, -1, device=bits.device)
        new_reg = (u[..., N - D:].to(torch.int64) * w).sum(-1)
        return new_reg.to(UINT32), u[..., D:]


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
