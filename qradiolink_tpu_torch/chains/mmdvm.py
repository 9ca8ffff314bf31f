"""MMDVM modem chains: single-carrier and 7-carrier (PFB) (port of
qradiolink_tpu/chains/mmdvm.py).

The reference bridges MMDVMHost (an external DMR/YSF/P25 stack) over ZeroMQ
with plain FM baseband at 24 ksps a carrier:

- single (reference src/gr/gr_demod_mmdvm.cpp:30-70): 250 ksps IQ ->
  rational resampler 12/125 -> channel LP -> quadrature demod (gain
  fs/(2 pi 10k)); TX (gr_mod_mmdvm.cpp): FM mod 2 pi 12.5k/24k at 24k ->
  LP -> interpolate to 250 ksps.
- multi (gr_demod_mmdvm_multi2.cpp:32-147): 250 ksps -> 10-branch PFB
  channelizer at 25 kHz spacing -> per-channel resampler 24/25 -> LP ->
  FM demod; TX is the adjoint into a PFB synthesizer
  (gr_mod_mmdvm_multi2.cpp:91-127) with a final 1/num_channels level.

The per-channel chains are one set of blocks with lead_shape=(C,). The
port map (logical channel i -> PFB bin [0,1,2,3,9,8,7][i]) is a gather on
RX and a scatter into zeroed bins on TX. TDMA burst gating stays with the
caller: a mask a sample, applied by the TX chains.

On CUDA the resamplers and FIRs run the kernels `ops/cuda_fir.route` and
`ops/cuda_resample.route` pick; the channelizer on IqPair input
`pfb_fft_f32` (`ops/cuda_pfb.route` at M 10, kp 56), the synthesizer's
branch FIRs `depthwise_run_f32` (`ops/cuda_depthwise.route` at kp 53); the
gather, the scatter, the demod and the rssi are plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Sequencer, init_states,
                                       iq_take, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import FrequencyMod, QuadratureDemod
from qradiolink_tpu_torch.ops.channelizer import (PfbChannelizer,
                                                  PfbSynthesizer)
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm, rssi_dbm_slots
from qradiolink_tpu_torch.chains.m17 import scaled

DEVICE_RATE = 250_000       # MMDVM modes force 250 ksps (config_mmdvm.h:4)
TARGET_RATE = 24_000
CHANNEL_SPACING = 25_000
NUM_BRANCHES = 10
MAX_CHANNELS = 7
# every reference MMDVM chain defaults filter_width to 5 kHz
# (gr_demod_mmdvm.h:36, gr_mod_mmdvm.h:36, gr_demod_mmdvm_multi2.h:40)
FILTER_WIDTH = 5_000.0
# FM deviation: TX sensitivity 2 pi 12.5k/24k everywhere
# (gr_mod_mmdvm.cpp:40, gr_mod_mmdvm_multi2.cpp:66); the RX quad-demod gain
# uses 10 kHz single-carrier (gr_demod_mmdvm.cpp:41), 12.5 kHz multi
# (gr_demod_mmdvm_multi2.cpp:55)
FM_DEV_TX = 12_500.0
FM_DEMOD_WIDTH_SINGLE = 10_000.0
FM_DEMOD_WIDTH_MULTI = 12_500.0
# logical channel i -> PFB bin (gr_demod_mmdvm_multi2.cpp:111-124: i <= 3
# -> bin i, i > 3 -> bin 10 - i); carriers at (bin <= 4 ? bin : bin - 10)
# x 25 kHz around the center frequency
PFB_PORT_MAP = np.array([0, 1, 2, 3, 9, 8, 7], np.int64)


def _lp(gain, rate, filter_width):
    return firdes.low_pass(gain, rate, filter_width, 2000.0,
                           firdes.WIN_BLACKMAN_HARRIS)


class MmdvmDemod(Block):
    """Single-carrier MMDVM RX: 250 ksps IQ (complex or an IqPair, T a
    multiple of 125) -> {"audio": 24 ksps FM f32, "rssi", "rssi_slots":
    dB a 720-sample slot}."""

    def __init__(self, filter_width: float = FILTER_WIDTH,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.resamp = RationalResampler(
            12, 125, taps=_lp(12.0, 12 * DEVICE_RATE, filter_width),
            lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(_lp(1.0, TARGET_RATE, filter_width),
                                     lead_shape=ls, device=dev)
        self.quad = QuadratureDemod(
            TARGET_RATE / (2 * np.pi * FM_DEMOD_WIDTH_SINGLE), lead_shape=ls,
            device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.quad]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, iq)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        audio = seq(self.quad, x)
        return seq.states(), {"audio": audio, "rssi": rssi,
                              "rssi_slots": rssi_dbm_slots(x)}


class MmdvmMod(Block):
    """Single-carrier MMDVM TX: 24 ksps f32 (..., T), T a multiple of 12
    -> {"iq": 250 ksps, complex64, or an IqPair with pair=True}; mask, if
    given, (..., T) multiplies the 24 ksps signal (TDMA gating)."""

    def __init__(self, filter_width: float = FILTER_WIDTH,
                 lead_shape: tuple = (), pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.fm = FrequencyMod(2 * np.pi * FM_DEV_TX / TARGET_RATE,
                               lead_shape=ls, pair_out=pair, device=dev)
        self.post = FirFilter(_lp(1.0, TARGET_RATE, filter_width),
                              lead_shape=ls, device=dev)
        self.up = RationalResampler(
            125, 12, taps=_lp(125.0, 12 * DEVICE_RATE, filter_width),
            lead_shape=ls, device=dev)
        self.blocks = [self.fm, self.post, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, audio, mask=None):
        seq = Sequencer(state)
        x = seq(self.fm, audio)
        x = scaled(seq(self.post, x), 0.8)
        if mask is not None:
            x = scaled(x, mask)
        x = seq(self.up, x)
        return seq.states(), {"iq": x}


class MmdvmMultiRx(Block):
    """Multi-carrier MMDVM RX: 250 ksps IQ (..., T), T a multiple of 250 ->
    {"audio": (..., C, T 24/250), "rssi": (..., C), "rssi_slots"}: the
    10-branch PFB channelizer, the port map, then the (C,)-batched 24/25
    resampler, LP and FM demod. IqPair input takes the fused channelizer
    kernel."""

    def __init__(self, num_channels: int = MAX_CHANNELS,
                 filter_width: float = FILTER_WIDTH, device=None):
        if not 1 <= num_channels <= MAX_CHANNELS:
            raise ValueError(f"num_channels {num_channels}: 1 to "
                             f"{MAX_CHANNELS}")
        dev = resolve_device(device)
        self.device = dev
        self.C = int(num_channels)
        cls = (self.C,)
        self.channelizer = PfbChannelizer(
            NUM_BRANCHES, taps=_lp(1.0, DEVICE_RATE, filter_width),
            device=dev)
        self.port_map = PFB_PORT_MAP[:self.C]
        self.resamp = RationalResampler(
            24, 25, taps=_lp(1.0, 600_000, filter_width), lead_shape=cls,
            device=dev)
        self.chan_filter = FirFilter(_lp(1.0, TARGET_RATE, filter_width),
                                     lead_shape=cls, device=dev)
        self.quad = QuadratureDemod(
            TARGET_RATE / (2 * np.pi * FM_DEMOD_WIDTH_MULTI),
            lead_shape=cls, device=dev)
        self.blocks = [self.channelizer, self.resamp, self.chan_filter,
                       self.quad]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        chans = seq(self.channelizer, iq)                # (..., 10, T/10)
        chans = iq_take(chans, self.port_map, axis=-2)   # (..., C, T/10)
        if isinstance(chans, IqPair):
            chans = IqPair(chans.re.contiguous(), chans.im.contiguous())
        x = seq(self.resamp, chans)                      # (..., C, T 24/250)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        audio = seq(self.quad, x)
        return seq.states(), {"audio": audio, "rssi": rssi,
                              "rssi_slots": rssi_dbm_slots(x)}


class MmdvmMultiTx(Block):
    """Multi-carrier MMDVM TX: FM audio (..., C, T24) at 24 ksps, T24 a
    multiple of 24 -> {"iq": 250 ksps (..., T24 250/24), complex64 or an
    IqPair with pair=True}: the (C,)-batched FM mod, LP, x0.8 and 25/24
    resampler, the mask (..., C, T24 25/24) if given, the scatter into the
    PFB bins, the synthesizer and the 1/C level."""

    def __init__(self, num_channels: int = MAX_CHANNELS,
                 filter_width: float = FILTER_WIDTH, pair: bool = False,
                 device=None):
        if not 1 <= num_channels <= MAX_CHANNELS:
            raise ValueError(f"num_channels {num_channels}: 1 to "
                             f"{MAX_CHANNELS}")
        dev = resolve_device(device)
        self.device = dev
        self.C = int(num_channels)
        cls = (self.C,)
        self.fm = FrequencyMod(2 * np.pi * FM_DEV_TX / TARGET_RATE,
                               lead_shape=cls, pair_out=pair, device=dev)
        self.chan_filter = FirFilter(_lp(1.0, TARGET_RATE, filter_width),
                                     lead_shape=cls, device=dev)
        self.resamp = RationalResampler(
            25, 24, taps=_lp(25.0, 600_000, filter_width), lead_shape=cls,
            device=dev)
        self.synthesizer = PfbSynthesizer(
            NUM_BRANCHES, taps=_lp(10.0, DEVICE_RATE, filter_width),
            device=dev)
        self.port_map = torch.as_tensor(PFB_PORT_MAP[:self.C], device=dev)
        self.blocks = [self.fm, self.chan_filter, self.resamp,
                       self.synthesizer]

    def init_state(self):
        return init_states(self.blocks)

    def _bins(self, x):
        """(..., C, Tm) -> (..., 10, Tm), channel i in bin port_map[i],
        zeros elsewhere."""
        shape = tuple(x.shape[:-2]) + (NUM_BRANCHES, x.shape[-1])
        z = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return z.index_copy(-2, self.port_map, x)

    def __call__(self, state, audio, mask=None):
        seq = Sequencer(state)
        x = seq(self.fm, audio)                          # (..., C, T24)
        x = scaled(seq(self.chan_filter, x), 0.8)
        x = seq(self.resamp, x)                          # (..., C, Tm)
        if mask is not None:
            x = scaled(x, mask)
        if isinstance(x, IqPair):
            bins = IqPair(self._bins(x.re), self._bins(x.im))
        else:
            bins = self._bins(x)
        y = seq(self.synthesizer, bins)                  # (..., Tm * 10)
        return seq.states(), {"iq": scaled(y, 1.0 / self.C)}
