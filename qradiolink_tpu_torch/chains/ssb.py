"""SSB (USB/LSB) voice chains with controlled-envelope processing (port of
qradiolink_tpu/chains/ssb.py).

RX mirrors reference src/gr/gr_demod_ssb.cpp:31-86:
  1 Msps -> resample 1/125 -> 8 ksps -> x0.9 -> complex band-pass
  (USB [200, fw] / LSB [-fw, -200], switching at :66-77) -> power squelch ->
  AGC2(1e-1, 1e-1, 0.25) -> CESSB clipper(0.95) + stretcher ->
  complex->real -> x1.333 -> audio band-pass.
TX mirrors src/gr/gr_mod_ssb.cpp:30-106:
  audio band filter -> analytic SSB via complex band-pass -> CESSB
  clipper/stretcher -> interpolate 125x -> 1 Msps.

On CUDA the RX head (5,597 default taps, stride 125) runs
`resample_dec_f32` at L 1 (`ops/cuda_fir.route`: `fir_long_f32`'s column
groups, segments and sum order, each sample staged once for every
segment), the 167-tap complex band-pass two launches of `fir_s1_f32` (one
a tap plane, over both IQ planes), the AGC stage one launch of `agc2_f32`,
and the 97-tap audio band-pass `fir_s1_f32`; the squelch, the CESSB
blocks and the scalings are plain PyTorch. The TX's analytic band-pass (167 complex taps
on a complex tensor) is the FFT form, `torch.fft` (`ops/fir.auto_impl`);
the TX interpolator is `resample_up_f32` (L 125, 45 taps a phase).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import (Block, Sequencer, init_states,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.agc import Agc2
from qradiolink_tpu_torch.ops.cessb import CessbClipper, CessbStretcher
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.ops.squelch import PowerSquelch


def _ssb_band(filter_width: float, usb: bool):
    lo, hi = 200.0, float(filter_width)
    if usb:
        return lo, hi
    return -hi, -lo


class SsbDemod(Block):
    """SSB demod. Input: an IqPair of f32 planes (..., T) or a complex
    tensor at 1 Msps, T a multiple of 125. Outputs: `audio` (..., T/125)
    f32 at 8 ksps and `rssi` (dB of the channel-filtered block).

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """
    SAMP_RATE = 1_000_000
    TARGET_RATE = 8_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 2700.0, usb: bool = True,
                 squelch_db: float = -140.0, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = self.TARGET_RATE
        lo, hi = _ssb_band(filter_width, usb)
        self.resamp = RationalResampler(1, 125, lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(
            firdes.complex_band_pass(1.0, fs, lo, hi, 200.0,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.squelch = PowerSquelch(squelch_db, alpha=0.01, lead_shape=ls,
                                    device=dev)
        self.agc = Agc2(1e-1, 1e-1, reference=0.25, lead_shape=ls,
                        device=dev)
        self.clipper = CessbClipper(0.95)
        self.stretcher = CessbStretcher(lead_shape=ls, device=dev)
        self.audio_filter = FirFilter(
            firdes.band_pass(1.0, self.AUDIO_RATE, 200.0, filter_width,
                             200.0, firdes.WIN_HAMMING), lead_shape=ls,
            device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.squelch, self.agc,
                       self.stretcher, self.audio_filter]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, iq)
        x = 0.9 * x
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.squelch, x)
        x = seq(self.agc, x)
        x = self.clipper.apply(x)
        x = seq(self.stretcher, x)
        x = x.real * 1.333
        x = seq(self.audio_filter, x)
        return seq.states(), {"audio": x, "rssi": rssi}


class SsbMod(Block):
    """SSB modulator. Input: f32 audio (..., T) at 8 ksps. Output: `iq`,
    complex64 (..., 125 T) at 1 Msps."""
    SAMP_RATE = 1_000_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 2700.0, usb: bool = True,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        lo, hi = _ssb_band(filter_width, usb)
        self.audio_filter = FirFilter(
            firdes.band_pass(1.0, self.AUDIO_RATE, 200.0, filter_width,
                             200.0, firdes.WIN_HAMMING), lead_shape=ls,
            device=dev)
        self.analytic = FirFilter(
            firdes.complex_band_pass(2.0, self.AUDIO_RATE, lo, hi, 200.0,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.clipper = CessbClipper(0.95)
        self.stretcher = CessbStretcher(lead_shape=ls, device=dev)
        self.up = RationalResampler(125, 1, lead_shape=ls, device=dev)
        self.blocks = [self.audio_filter, self.analytic, self.stretcher,
                       self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, audio):
        seq = Sequencer(state)
        x = seq(self.audio_filter, audio)
        x = seq(self.analytic, x.to(torch.complex64))
        x = self.clipper.apply(x)
        x = seq(self.stretcher, x)
        x = seq(self.up, x)
        return seq.states(), {"iq": x}
