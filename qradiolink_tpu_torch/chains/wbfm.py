"""WBFM broadcast receive chain (port of qradiolink_tpu/chains/wbfm.py;
RX only in the reference, src/gr/gr_demod_wbfm.cpp:30-73):
  1 Msps -> resample 1/5 -> 200 ksps -> channel LP -> power squelch ->
  quadrature demod (gain fs/(2*pi*fw)) -> de-emphasis -> resample 1/25
  -> 8 ksps -> audio LP.

On CUDA the head (225 default taps, stride 5) and the audio resampler
(1,121 taps, stride 25) run `fir_stream_f32`, the channel and audio
low-passes `fir_s1_f32`; the squelch, demod and de-emphasis are plain
PyTorch.
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.core import (Block, Sequencer, init_states,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import Emphasis, QuadratureDemod
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.ops.squelch import PowerSquelch


class WbfmDemod(Block):
    """WBFM demod. Input: an IqPair of f32 planes (..., T) or a complex
    tensor at 1 Msps, T a multiple of 125. Outputs: `audio` (..., T/125)
    f32 at 8 ksps and `rssi`."""
    SAMP_RATE = 1_000_000
    TARGET_RATE = 200_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 75_000.0,
                 squelch_db: float = -140.0, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = self.TARGET_RATE
        self.resamp = RationalResampler(1, 5, lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, filter_width, filter_width * 0.2,
                            firdes.WIN_HAMMING), lead_shape=ls, device=dev)
        self.squelch = PowerSquelch(squelch_db, alpha=0.01, lead_shape=ls,
                                    device=dev)
        self.quad = QuadratureDemod(fs / (2 * np.pi * filter_width),
                                    lead_shape=ls, device=dev)
        self.deemph = Emphasis(fs, tau=50e-6, mode="de", lead_shape=ls,
                               device=dev)
        self.audio_resamp = RationalResampler(1, 25, lead_shape=ls,
                                              device=dev)
        self.audio_filter = FirFilter(
            firdes.low_pass(1.0, self.AUDIO_RATE, 3600.0, 500.0,
                            firdes.WIN_HAMMING), lead_shape=ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.squelch, self.quad,
                       self.deemph, self.audio_resamp, self.audio_filter]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, iq)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.squelch, x)
        x = seq(self.quad, x)
        x = seq(self.deemph, x)
        x = seq(self.audio_resamp, x).real
        x = seq(self.audio_filter, x)
        return seq.states(), {"audio": x, "rssi": rssi}
