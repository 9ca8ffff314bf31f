"""DMR 4FSK modem chain, 24 ksps, 4800 symbols/s, sps 5, RRC alpha 0.2
(port of qradiolink_tpu/chains/dmr.py).

RX mirrors the reference's src/gr/gr_demod_dmr.cpp:32-107: 1 Msps ->
rational resampler 3/125 (5 kHz channel) -> quadrature demod (gain
fs/(pi/2 * Rs)) -> RRC(1.0, 24k, 4800, 0.2, 125 taps) -> M&M symbol sync
on 4 levels -> x0.9 -> dibits, sign bit then magnitude bit (|s| > 0.9).
The RRC's output is the `soft` tap (the reference's port 3, which
gr_dmr_dmo_sink correlates against the sync words).

TX mirrors src/gr/gr_mod_dmr.cpp:27-97: dibits -> map{2,3,1,0} -> levels
{-1.5..1.5} -> RRC interpolation x5 (alpha 0.2) -> x2/3 -> frequency mod
(pi Rs 0.85 / 24000) -> TDMA burst gating -> resampler 125/3 -> x0.9 ->
1 Msps. The reference's `gr_zero_idle_bursts` zeroes samples flagged by
stream tags; here the gating is a per-sample mask at 24 ksps that the
host computes (burst scheduling on the host, the gate a product).

Burst framing and decoding (sync hunt, slot type, FEC) live in
protocols/dmr.py (host side); these chains carry raw 9600 bit/s dibits.

On CUDA the 3/125 head is one launch of `resample_dec_f32`, the RRC
`fir_s1_f32`, the M&M loop `symbol_sync_mm_f32` on its 4 levels, and the
TX interpolators (5/1, 125/3) `resample_up_f32`; the rest is plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.chains.m17 import (LEVELS, TX_MAP, constellation,
                                             dibit_bits, levels_of, scaled)
from qradiolink_tpu_torch.core import (Block, Sequencer, as_iq_pair,
                                       init_states, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import FrequencyMod, QuadratureDemod
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.feedforward import FeedforwardSymbolSync
from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync


class _DmrRx(Block):
    """The DMR RX front half: 3/125 head, rssi, FM discriminator, RRC; the
    symbol sync is the subclass's."""
    SAMP_RATE = 1_000_000
    TARGET_RATE = 24_000
    SYMBOL_RATE = 4_800

    def __init__(self, filter_width: float, lead_shape: tuple, device):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = self.TARGET_RATE
        self.sps = fs // self.SYMBOL_RATE  # 5
        self.resamp = RationalResampler(
            3, 125, taps=firdes.low_pass(3.0, 3 * self.SAMP_RATE,
                                         filter_width, 2000.0,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        # quad gain fs/(pi/2 * Rs) (gr_demod_dmr.cpp:73)
        self.quad = QuadratureDemod(fs / (np.pi / 2 * self.SYMBOL_RATE),
                                    lead_shape=ls, device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(1.0, fs, self.SYMBOL_RATE, 0.2,
                                      25 * self.sps), lead_shape=ls,
            device=dev)

    def init_state(self):
        return init_states(self.blocks)

    def front(self, seq, iq):
        """(RRC output, rssi) of a block, the states threaded by seq."""
        x = seq(self.resamp, as_iq_pair(iq))
        rssi = rssi_dbm(x)
        x = seq(self.quad, x)
        return seq(self.shaping, x), rssi


class DmrDemod(_DmrRx):
    """DMR RX: 1 Msps IQ -> hard dibit bits at 9600 bit/s.

    Input: an IqPair or complex (..., T), T a multiple of 625 (decimation
    125, then 5 samples a symbol). Outputs: `bits` (..., 2 T/625) uint8,
    sign bit first; `symbols` f32 (x0.9); `soft` (the RRC's output at 24
    ksps); `constellation` complex64; `rssi`.

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """

    def __init__(self, filter_width: float = 5000.0, lead_shape: tuple = (),
                 device=None):
        super().__init__(filter_width, lead_shape, device)
        # gains tuned for the direct M&M loop (swept on clean + 12 dB
        # loopback); deviation limit 0.06 per gr_demod_dmr.cpp:70
        self.symbol_sync = SymbolSync(self.sps, gain_mu=0.2869,
                                      gain_omega=0.005, decisions=LEVELS,
                                      omega_limit=0.06,
                                      lead_shape=tuple(lead_shape),
                                      device=self.device)
        self.blocks = [self.resamp, self.quad, self.shaping,
                       self.symbol_sync]

    def __call__(self, state, iq):
        seq = Sequencer(state)
        soft, rssi = self.front(seq, iq)
        syms = seq(self.symbol_sync, soft) * 0.9
        return seq.states(), {"bits": dibit_bits(syms, 0.9),
                              "symbols": syms, "soft": soft,
                              "constellation": constellation(syms),
                              "rssi": rssi}


class DmrDemodFF(_DmrRx):
    """DMR demod with feedforward timing instead of the M&M loop (the
    Fsk4DemodFF substitution, so many DMR carriers batch on one card). T
    must be a multiple of 125 * n_sub * sps (2500 by default). Outputs as
    DmrDemod's, `constellation` an IqPair."""

    def __init__(self, filter_width: float = 5000.0, lead_shape: tuple = (),
                 n_sub: int = 4, device=None):
        super().__init__(filter_width, lead_shape, device)
        self.symbol_sync = FeedforwardSymbolSync(
            self.sps, n_sub=n_sub, lead_shape=tuple(lead_shape),
            device=self.device)
        self.blocks = [self.resamp, self.quad, self.shaping,
                       self.symbol_sync]

    def __call__(self, state, iq):
        seq = Sequencer(state)
        soft, rssi = self.front(seq, iq)
        syms = seq(self.symbol_sync, soft) * 0.9
        return seq.states(), {"bits": dibit_bits(syms, 0.9),
                              "symbols": syms, "soft": soft,
                              "constellation": constellation(syms, True),
                              "rssi": rssi}


class DmrMod(Block):
    """DMR TX: bits (..., 2n), 2 a symbol -> {"iq": 1 Msps IQ (..., 125 n 5
    / 3)}, complex64 or, with pair=True, an IqPair; 5 n must be a multiple
    of 3.

    `mask` (optional, broadcast against the 24 ksps stream, 5 n samples a
    block) multiplies the frequency modulator's output, plane by plane:
    zeros gate idle TDMA slots, as the reference's zero_samples-tagged
    gating does."""
    SAMP_RATE = 1_000_000
    SYMBOL_RATE = 4_800

    def __init__(self, filter_width: float = 5000.0, lead_shape: tuple = (),
                 pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        sps = 5
        self.sps = sps
        if_rate = 24_000
        self.shaper = RationalResampler(
            sps, 1, taps=firdes.root_raised_cosine(float(sps), float(if_rate),
                                                   float(self.SYMBOL_RATE),
                                                   0.2, 25 * sps),
            lead_shape=ls, device=dev)
        # sensitivity pi*Rs*0.85/fs (gr_mod_dmr.cpp:70)
        self.fm = FrequencyMod(np.pi * self.SYMBOL_RATE * 0.85 / if_rate,
                               lead_shape=ls, pair_out=pair, device=dev)
        self.up = RationalResampler(
            125, 3, taps=firdes.low_pass(125.0, 3 * self.SAMP_RATE,
                                         filter_width, 2000.0,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.levels = torch.tensor(LEVELS, dtype=torch.float32, device=dev)
        self.map = torch.tensor(TX_MAP, dtype=torch.int64, device=dev)
        self.blocks = [self.shaper, self.fm, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, bits, mask=None):
        seq = Sequencer(state)
        syms = levels_of(bits, self.levels, self.map)
        x = seq(self.shaper, syms) * (2.0 / 3.0)
        x = seq(self.fm, x)
        if mask is not None:
            x = scaled(x, mask)
        x = scaled(seq(self.up, x), 0.9)
        return seq.states(), {"iq": x}
