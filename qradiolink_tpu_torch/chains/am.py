"""AM voice chains (port of qradiolink_tpu/chains/am.py).

RX mirrors reference src/gr/gr_demod_am.cpp:30-83:
  1 Msps -> resample 1/50 -> 20 ksps -> complex band-pass -> power squelch
  -> magnitude -> AGC2 -> DC-block IIR [1,-1]/[1,-0.9999] -> resample 2/5.
TX mirrors src/gr/gr_mod_am.cpp: audio LP -> carrier add (1 + m*x) ->
  interpolate to 1 Msps -> band-pass.

On CUDA the RX head (2,239 default taps, stride 50) runs `resample_dec_f32`
at L 1, the 49-tap complex band-pass two launches of `fir_s1_f32`, the AGC
stage one launch of `agc2_f32`, the 2/5 audio resampler
`resample_poly_f32` and the audio low-pass `fir_s1_f32`. The TX interpolator is `resample_up_f32`; the
963-tap complex post-filter is the FFT form, `torch.fft` (`ops/fir.auto_impl`:
2.77x faster than its two `fir_s1_f32` launches at 2048 x 200,000 on an
H100, PERF.md).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import (Block, Sequencer, init_states,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.agc import Agc2
from qradiolink_tpu_torch.ops.analog import ComplexToMag, DcBlocker
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.ops.squelch import PowerSquelch


class AmDemod(Block):
    """AM demod. Input: an IqPair of f32 planes (..., T) or a complex tensor
    at 1 Msps, T a multiple of 250. Outputs: `audio` (..., T/125) f32 at
    8 ksps and `rssi`."""
    SAMP_RATE = 1_000_000
    TARGET_RATE = 20_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 5000.0,
                 squelch_db: float = -140.0, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = self.TARGET_RATE
        self.resamp = RationalResampler(1, 50, lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(
            firdes.complex_band_pass(1.0, fs, -filter_width, filter_width,
                                     filter_width * 0.2, firdes.WIN_HAMMING),
            lead_shape=ls, device=dev)
        self.squelch = PowerSquelch(squelch_db, alpha=0.01, lead_shape=ls,
                                    device=dev)
        self.mag = ComplexToMag()
        self.agc = Agc2(1e-1, 1e-2, reference=1.0, lead_shape=ls, device=dev)
        self.dc_block = DcBlocker(0.9999, lead_shape=ls, device=dev)
        self.audio_resamp = RationalResampler(2, 5, lead_shape=ls,
                                              device=dev)
        self.audio_filter = FirFilter(
            firdes.low_pass(1.0, self.AUDIO_RATE, 3500.0, 600.0,
                            firdes.WIN_HAMMING), lead_shape=ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.squelch, self.agc,
                       self.dc_block, self.audio_resamp, self.audio_filter]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, iq)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.squelch, x)
        x = self.mag.apply(x)
        x = seq(self.agc, x)
        x = seq(self.dc_block, x)
        x = seq(self.audio_resamp, x).real
        x = seq(self.audio_filter, x)
        return seq.states(), {"audio": x, "rssi": rssi}


class AmMod(Block):
    """AM modulator. Input: f32 audio (..., T) at 8 ksps. Output: `iq`,
    complex64 (..., 125 T) at 1 Msps."""
    SAMP_RATE = 1_000_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 5000.0, mod_index: float = 0.9,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.mod_index = float(mod_index)
        self.audio_filter = FirFilter(
            firdes.low_pass(1.0, self.AUDIO_RATE, 3500.0, 600.0,
                            firdes.WIN_HAMMING), lead_shape=ls, device=dev)
        self.up = RationalResampler(125, 1, lead_shape=ls, device=dev)
        self.post_filter = FirFilter(
            firdes.complex_band_pass(1.0, self.SAMP_RATE, -filter_width,
                                     filter_width, filter_width * 0.5,
                                     firdes.WIN_HAMMING), lead_shape=ls,
            device=dev)
        self.blocks = [self.audio_filter, self.up, self.post_filter]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, audio):
        seq = Sequencer(state)
        x = seq(self.audio_filter, audio)
        x = torch.clamp(x, -1.0, 1.0)
        x = 0.5 * (1.0 + self.mod_index * x)  # carrier + modulation
        x = seq(self.up, x).real.to(torch.complex64)
        x = seq(self.post_filter, x)
        return seq.states(), {"iq": x}
