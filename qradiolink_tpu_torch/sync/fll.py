"""FLL band-edge coarse frequency acquisition (port of
qradiolink_tpu/sync/fll.py; gr::digital::fll_band_edge_cc, reference
src/gr/gr_demod_bpsk.cpp FLL(sps, 0.35, 32, 2pi/100)).

The JAX package's form, "estimate then apply" over sub-blocks: in each
sub-block the current NCO derotates the samples, the two band-edge filters
run as FIRs over them, and the band-edge energy difference drives one
frequency update. The loop runs over the sub-blocks (200 a step at
QPSK250K), in plain PyTorch; its band-edge FIRs, complex taps on the
derotated planes, are launches of the routed FIR kernel (`fir_s1_f32` on
CUDA, ops/cuda_fir.py), the tails read in place from the state.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.fir import fir_planes, flipped_tap_planes, \
    next_tail
from qradiolink_tpu_torch.sync.costas import loop_gains
from qradiolink_tpu_torch.sync.cuda_costas import mod_2pi


def band_edge_taps(sps: float, rolloff: float, ntaps: int):
    """Upper/lower band-edge filters: complex band-passes straddling the
    RRC band edges at +/-(1+rolloff)/(2*sps) cycles/sample."""
    center = (1.0 + rolloff) / (2.0 * sps)
    width = max(rolloff / sps, 1.0 / ntaps)
    upper = firdes.complex_band_pass(
        1.0, 1.0, center - width / 2, center + width / 2, width / 2,
        ntaps=ntaps)
    lower = firdes.complex_band_pass(
        1.0, 1.0, -center - width / 2, -center + width / 2, width / 2,
        ntaps=ntaps)
    return upper, lower


class FllBandEdge(Block):
    """Coarse AFC. Input: an IqPair, complex64 or real f32; output
    complex64, as the JAX block gives. State: (phase, freq) f32 (freq in
    rad/sample), the band-edge FIRs' tail (..., filter_size - 1)
    complex64."""

    def __init__(self, sps: float, rolloff: float, filter_size: int,
                 loop_bw: float, sub_block: int = 512, lead_shape: tuple = (),
                 device=None):
        self.device = resolve_device(device)
        upper, lower = band_edge_taps(sps, rolloff, filter_size)
        self.upper = flipped_tap_planes(upper, self.device)
        self.lower = flipped_tap_planes(lower, self.device)
        self.ntaps = int(filter_size)
        _, self.beta = loop_gains(loop_bw)
        self.max_freq = 2.0 * np.pi / float(sps) * (1.0 + rolloff)
        self.sub_block = int(sub_block)
        self.lead_shape = tuple(lead_shape)

    def sub_block_len(self, T: int) -> int:
        """The sub-block for a block of T: the largest divisor of T not
        above sub_block, as the JAX block picks it."""
        sb = min(self.sub_block, T)
        while T % sb != 0:
            sb -= 1
        return sb

    def init_state(self):
        z = torch.zeros(self.lead_shape, dtype=torch.float32,
                        device=self.device)
        tail = torch.zeros(self.lead_shape + (self.ntaps - 1,),
                           dtype=torch.complex64, device=self.device)
        return (z, z.clone(), tail)

    def __call__(self, state, x):
        if isinstance(x, IqPair):
            xr, xi = x.re, x.im
        elif torch.is_complex(x):
            xr, xi = x.real, x.imag
        else:
            xr, xi = x.float(), torch.zeros_like(x, dtype=torch.float32)
        phase, freq, tail = state
        T = xr.shape[-1]
        sb = self.sub_block_len(T)
        k1 = self.ntaps - 1
        n = torch.arange(sb, dtype=torch.float32, device=xr.device)
        tr, ti = tail.real.contiguous(), tail.imag.contiguous()
        ys_r, ys_i = [], []
        for k in range(T // sb):
            ar = xr[..., k * sb:(k + 1) * sb]
            ai = xi[..., k * sb:(k + 1) * sb]
            ph = phase[..., None] + freq[..., None] * n
            c, s = torch.cos(ph), -torch.sin(ph)  # exp(-1j ph)
            yr = ar * c - ai * s
            yi = ar * s + ai * c
            ur, ui = fir_planes((yr, yi), self.upper, 1, sb, tails=(tr, ti))
            lr, li = fir_planes((yr, yi), self.lower, 1, sb, tails=(tr, ti))
            err = torch.mean((ur * ur + ui * ui) - (lr * lr + li * li),
                             dim=-1)
            err = torch.clamp(err, -1.0, 1.0)
            new_freq = torch.clamp(freq + self.beta * err, -self.max_freq,
                                   self.max_freq)
            phase = mod_2pi(phase + freq * sb)
            freq = new_freq
            tr, ti = next_tail(tr, yr, k1), next_tail(ti, yi, k1)
            ys_r.append(yr)
            ys_i.append(yi)
        y = torch.complex(torch.cat(ys_r, dim=-1), torch.cat(ys_i, dim=-1))
        return (phase, freq, torch.complex(tr, ti)), y
