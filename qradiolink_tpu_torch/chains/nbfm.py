"""NBFM voice chains (port of qradiolink_tpu/chains/nbfm.py).

RX mirrors reference src/gr/gr_demod_nbfm.cpp:31-79:
  1 Msps IQ -> polyphase resample 1/50 -> 20 ksps -> channel low-pass
  -> power squelch (threshold dB, alpha .01, ramp 320) -> quadrature demod
  (gain fs/(4*pi*fw)) -> audio resample 2/5 -> 8 ksps -> audio LP 3.5 kHz
  -> 50 us de-emphasis -> x2.0; optional CTCSS tone squelch insert
  (reference :97-128).
TX mirrors src/gr/gr_mod_nbfm.cpp:30-135:
  8 ksps audio -> audio band filter -> pre-emphasis -> resample 25/4 ->
  50 ksps -> frequency modulator (sensitivity 4*pi*fw/50k) -> LP ->
  interpolate 20x -> 1 Msps; optional CTCSS adds a 0.15-amplitude tone.

On CUDA the resampler head runs `resample_dec_f32` at L 1, the channel and
audio low-passes `fir_s1_f32` (`ops/cuda_fir.route`), the audio resampler
`resample_poly_f32`, both phases and the new state in one launch
(`ops/cuda_resample.py`); the squelch, demod and de-emphasis are plain
PyTorch. NbfmMod's two interpolators (25/4, 20/1) are `resample_up_f32`,
its low-passes `fir_s1_f32`.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, Sequencer, init_states,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import (Emphasis, FrequencyMod,
                                             QuadratureDemod, wrap_phase)
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.ops.squelch import CtcssSquelch, PowerSquelch


class NbfmDemod(Block):
    """NBFM demod. Input: an IqPair of f32 planes (..., T) or a complex
    tensor at 1 Msps; T must be a multiple of 250 (1/50, then 2/5), and
    of 50,000 with CTCSS (so that the audio is a whole number of
    400-sample windows).
    Outputs: `audio` (..., T/125) at 8 ksps and `rssi` (dB of the
    channel-filtered block).

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """
    SAMP_RATE = 1_000_000
    TARGET_RATE = 20_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 2500.0,
                 squelch_db: float = -140.0, ctcss_hz: float = 0.0,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.filter_width = filter_width
        fs = self.TARGET_RATE
        self.resamp = RationalResampler(1, 50, lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, filter_width, filter_width * 0.25,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.squelch = PowerSquelch(squelch_db, alpha=0.01, ramp=320,
                                    lead_shape=ls, device=dev)
        self.quad = QuadratureDemod(fs / (4 * np.pi * filter_width),
                                    lead_shape=ls, device=dev)
        self.audio_resamp = RationalResampler(2, 5, lead_shape=ls, device=dev)
        self.audio_filter = FirFilter(
            firdes.low_pass(1.0, self.AUDIO_RATE, 3500.0, 600.0,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.deemph = Emphasis(self.AUDIO_RATE, tau=50e-6, mode="de",
                               lead_shape=ls, device=dev)
        self.ctcss = (CtcssSquelch(self.AUDIO_RATE, ctcss_hz, window=400,
                                   lead_shape=ls, device=dev)
                      if ctcss_hz > 0 else None)
        self.blocks = [self.resamp, self.chan_filter, self.squelch, self.quad,
                       self.audio_resamp, self.audio_filter, self.deemph]
        if self.ctcss is not None:
            self.blocks.append(self.ctcss)

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, iq)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.squelch, x)
        x = seq(self.quad, x)
        x = seq(self.audio_resamp, x).real
        x = seq(self.audio_filter, x)
        x = seq(self.deemph, x)
        if self.ctcss is not None:
            x = seq(self.ctcss, x)
        return seq.states(), {"audio": 2.0 * x, "rssi": rssi}


class NbfmMod(Block):
    """NBFM modulator. Input: f32 audio (..., T) at 8 ksps, T a multiple of
    4. Output: `iq` (..., 125 T) at 1 Msps, complex64, or an IqPair of f32
    planes with pair=True. State: the blocks' states and the CTCSS tone's
    phase, lead_shape f32."""
    SAMP_RATE = 1_000_000
    AUDIO_RATE = 8_000

    def __init__(self, filter_width: float = 2500.0, ctcss_hz: float = 0.0,
                 lead_shape: tuple = (), pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.audio_filter = FirFilter(
            firdes.low_pass(1.0, self.AUDIO_RATE, 3150.0, 300.0,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.preemph = Emphasis(self.AUDIO_RATE, tau=50e-6, mode="pre",
                                lead_shape=ls, device=dev)
        self.up1 = RationalResampler(25, 4, lead_shape=ls, device=dev)
        self.fm = FrequencyMod(4 * np.pi * filter_width / 50_000.0,
                               lead_shape=ls, pair_out=pair, device=dev)
        self.post_filter = FirFilter(
            firdes.low_pass(1.0, 50_000.0, filter_width * 2.0,
                            filter_width, firdes.WIN_HAMMING),
            lead_shape=ls, device=dev)
        self.up2 = RationalResampler(20, 1, lead_shape=ls, device=dev)
        self.ctcss_hz = float(ctcss_hz)
        self.lead_shape = ls
        self.blocks = [self.audio_filter, self.preemph, self.up1, self.fm,
                       self.post_filter, self.up2]

    def init_state(self):
        return init_states(self.blocks) + (torch.zeros(
            self.lead_shape, dtype=torch.float32, device=self.device),)

    def __call__(self, state, audio):
        *bs, ctcss_phase = state
        seq = Sequencer(bs)
        x = seq(self.audio_filter, audio)
        x = seq(self.preemph, x)
        x = torch.clamp(x, -1.0, 1.0)
        if self.ctcss_hz > 0:
            t = torch.arange(x.shape[-1], dtype=torch.float32,
                             device=x.device)
            w = 2 * np.pi * self.ctcss_hz / self.AUDIO_RATE
            tone = 0.15 * torch.cos(ctcss_phase[..., None] + w * t)
            x = 0.85 * x + tone
            new_phase = wrap_phase(ctcss_phase + w * x.shape[-1])
        else:
            new_phase = ctcss_phase
        x = seq(self.up1, x).real
        x = seq(self.fm, x)
        x = seq(self.post_filter, x)
        x = seq(self.up2, x)
        return seq.states() + (new_phase,), {"iq": x}
