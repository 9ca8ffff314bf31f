"""FreeDV chains: the SSB-style passband transport of the FreeDV modem
(port of qradiolink_tpu/chains/freedv.py).

Mirrors the reference's src/gr/gr_demod_freedv.cpp:30-82 and
gr_mod_freedv.cpp:28-90. FreeDV's modem (OFDM/FSK inside libcodec2) runs at
an 8 kHz real passband; the radio chain converts that passband up and down:

  RX: 1 Msps IQ -> rational resampler 1/125 -> complex band-pass (USB
      [low_cutoff, fw] or LSB mirrored) -> real part -> AGC2(1e-1, 1e-3,
      0.5) -> band-pass 200..3500 -> x0.1 -> passband floats for freedv_rx
  TX: freedv_tx passband floats -> complex band-pass -> feedforward AGC
      (the block's envelope) -> interpolating resampler x125 -> x0.98 ->
      1 Msps IQ

The vocoder/modem halves (audio/freedv.py's FreeDV bridge) stay on the
host: they are the reference's gr-vocoder blocks, libcodec2 C calls, not
DSP to port. FreeDvTx / FreeDvRx below couple bridge and chain into an
audio <-> IQ interface; the 8 kHz audio crosses to the host as int16
(x32765 on TX, x32768 on RX, clipped and truncated toward zero as in the
JAX classes) and the decoded speech leaves with the reference's x2 gain.

On CUDA the 1/125 head runs the kernel `ops/cuda_fir.route` picks (K1045
D125: `fir_stream_f32`), the complex band-passes the direct kernels or the
FFT form by `ops/fir.auto_impl`, the AGC `agc2_f32`, the audio band-passes
`fir_s1_f32` (FreeDvTx's K95 on one row among them) and the x125
interpolator `resample_up_f32`.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, Sequencer, as_iq_pair, get_iq,
                                       init_states, put_iq_pair,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.agc import Agc2
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.chains.m17 import scaled

TARGET_RATE = 8_000


class FeedforwardAgc(Block):
    """Envelope normalizer (reference gr::analog::feedforward_agc_cc with
    nsamples=512): divides by the block's envelope, held at no less than
    half the last block's, so the modem waveform leaves at about unit
    amplitude. State: the envelope, lead_shape f32."""

    def __init__(self, window: int = 512, reference: float = 1.0,
                 lead_shape: tuple = (), device=None):
        self.window = int(window)
        self.reference = float(reference)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.full(self.lead_shape, 1e-6, dtype=torch.float32,
                          device=self.device)

    def __call__(self, state, x):
        env = torch.amax(torch.abs(x), dim=-1)
        m = torch.maximum(env, 0.5 * state)
        y = scaled(x, (self.reference / torch.clamp(m, min=1e-6))[..., None])
        return m.to(torch.float32), y


def _band(filter_width, low_cutoff, usb):
    return (low_cutoff, filter_width) if usb \
        else (-filter_width, -low_cutoff)


class FreeDvDemod(Block):
    """FreeDV RX front: 1 Msps IQ (an IqPair or complex (..., T), T a
    multiple of 125) -> {"passband": 8 kHz f32 (..., T/125), "rssi",
    "constellation": the band-passed IqPair}."""
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float = 2500.0,
                 low_cutoff: float = 200.0, usb: bool = True,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.resamp = RationalResampler(
            1, 125, taps=firdes.low_pass(1.0, self.SAMP_RATE,
                                         TARGET_RATE / 2, TARGET_RATE / 2,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        lo, hi = _band(filter_width, low_cutoff, usb)
        self.chan_filter = FirFilter(
            firdes.complex_band_pass(1.0, TARGET_RATE, lo, hi, 200.0,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.agc = Agc2(1e-1, 1e-3, reference=0.5, lead_shape=ls,
                        device=dev)
        self.audio_filter = FirFilter(
            firdes.band_pass(1.0, TARGET_RATE, 200.0, 3500.0, 200.0,
                             firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.agc,
                       self.audio_filter]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        a = seq(self.agc, x.real.contiguous())
        a = seq(self.audio_filter, a) * 0.1
        return seq.states(), {"passband": a, "rssi": rssi,
                              "constellation": x}


class FreeDvMod(Block):
    """FreeDV TX back: 8 kHz passband f32 (..., T) -> {"iq": complex64
    (..., 125 T) at 1 Msps}."""
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float = 2500.0,
                 low_cutoff: float = 200.0, usb: bool = True,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        lo, hi = _band(filter_width, low_cutoff, usb)
        self.chan_filter = FirFilter(
            firdes.complex_band_pass(1.0, TARGET_RATE, lo, hi, 250.0,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.agc = FeedforwardAgc(512, 1.0, lead_shape=ls, device=dev)
        self.up = RationalResampler(
            125, 1, taps=firdes.low_pass(125.0, self.SAMP_RATE,
                                         filter_width, 1200.0),
            lead_shape=ls, device=dev)
        self.blocks = [self.chan_filter, self.agc, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, passband):
        seq = Sequencer(state)
        x = seq(self.chan_filter, passband.to(torch.complex64))
        x = seq(self.agc, x)
        x = scaled(seq(self.up, x), 0.98)
        return seq.states(), {"iq": x}


def tx_audio_filter(device=None) -> FirFilter:
    """FreeDvTx's 200-3500 Hz audio band-pass ahead of freedv_tx: 95 real
    taps, one row (so the direct form in both packages)."""
    return FirFilter(firdes.band_pass(1.0, TARGET_RATE, 200.0, 3500.0, 350.0,
                                      firdes.WIN_BLACKMAN_HARRIS),
                     device=device)


class FreeDvTx:
    """Audio (8 kHz float) -> IQ: the reference's whole gr_mod_freedv path.
    The audio band-pass (tx_audio_filter) and FreeDvMod run on `device`,
    the vocoder and modem (freedv_tx) on the host."""

    def __init__(self, mode: str = "1600", usb: bool = True,
                 filter_width: float = 2500.0, device=None):
        from qradiolink_tpu_torch.audio.freedv import FreeDV
        self.device = resolve_device(device)
        self.freedv = FreeDV(mode)
        self.audio_filter = tx_audio_filter(self.device)
        self._af_state = self.audio_filter.init_state()
        self.chain = FreeDvMod(usb=usb, filter_width=filter_width,
                               device=self.device)
        self._state = self.chain.init_state()

    def filter(self, audio: np.ndarray) -> np.ndarray:
        """The audio band-pass over one block: f32 numpy, streaming."""
        self._af_state, y = self.audio_filter(
            self._af_state,
            torch.from_numpy(np.asarray(audio, np.float32)).to(self.device))
        return y.cpu().numpy()

    def modulate(self, modem: np.ndarray) -> np.ndarray:
        """freedv_tx's int16 modem samples -> complex64 IQ (FreeDvMod)."""
        if modem.size == 0:
            return np.zeros(0, np.complex64)
        pb = modem.astype(np.float32) / 32765.0
        self._state, out = self.chain(self._state,
                                      torch.from_numpy(pb).to(self.device))
        return get_iq(out["iq"])

    def process(self, audio: np.ndarray) -> np.ndarray:
        pcm = np.clip(self.filter(audio) * 32765.0, -32765,
                      32765).astype(np.int16)
        return self.modulate(self.freedv.tx(pcm))


class FreeDvRx:
    """IQ -> decoded audio (8 kHz float): FreeDvDemod on `device`, then
    freedv_rx on the host and the x2 gain (gr_demod_freedv.cpp:66). Each
    block is a multiple of 125 samples."""

    def __init__(self, mode: str = "1600", usb: bool = True,
                 filter_width: float = 2500.0, device=None):
        from qradiolink_tpu_torch.audio.freedv import FreeDV
        self.device = resolve_device(device)
        self.freedv = FreeDV(mode)
        self.chain = FreeDvDemod(usb=usb, filter_width=filter_width,
                                 device=self.device)
        self._state = self.chain.init_state()

    def demodulate(self, iq) -> np.ndarray:
        """IQ (complex numpy or an IqPair) -> the 8 kHz passband, f32
        numpy."""
        self._state, out = self.chain(self._state,
                                      put_iq_pair(iq, self.device))
        return out["passband"].cpu().numpy()

    def process(self, iq) -> np.ndarray:
        pcm = np.clip(self.demodulate(iq) * 32768.0, -32767,
                      32767).astype(np.int16)
        speech = self.freedv.rx(pcm)
        return speech.astype(np.float32) / 32768.0 * 2.0

    @property
    def sync(self) -> bool:
        return self.freedv.sync
