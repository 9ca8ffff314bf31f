"""FLL band-edge coarse frequency acquisition (port of
qradiolink_tpu/sync/fll.py; gr::digital::fll_band_edge_cc, reference
src/gr/gr_demod_bpsk.cpp FLL(sps, 0.35, 32, 2pi/100)).

The JAX package's form, "estimate then apply" over sub-blocks: in each
sub-block the current NCO derotates the samples, the two band-edge filters
run as FIRs over them, and the band-edge energy difference drives one
frequency update. On the card the whole block, every sub-block of every
row, is one launch of `fll_band_edge_f32` (sync/cuda_fll.py,
csrc/fll_band_edge.cu); on the CPU the loop over the sub-blocks runs in
plain PyTorch (`cuda_fll.fll_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.fir import flipped_tap_planes
from qradiolink_tpu_torch.sync.costas import loop_gains
from qradiolink_tpu_torch.sync.cuda_fll import fll_band_edge


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
        # the flipped upper re, upper im, lower re and lower im taps
        self.taps = torch.stack(flipped_tap_planes(upper, self.device)
                                + flipped_tap_planes(lower, self.device))
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
            xr, xi = x.float(), None
        phase, freq, tail = state
        y, phase, freq, tail = fll_band_edge(
            xr, xi, phase, freq, tail, self.taps, self.beta, self.max_freq,
            self.sub_block_len(xr.shape[-1]))
        return (phase, freq, tail), y
