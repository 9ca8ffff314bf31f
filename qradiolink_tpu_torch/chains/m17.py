"""M17 4FSK modem chain, 24 ksps, 4800 symbols/s, sps 5, RRC alpha 0.5
(port of qradiolink_tpu/chains/m17.py).

RX mirrors the reference's src/gr/gr_demod_m17.cpp:32-105: 1 Msps ->
rational resampler 3/125 -> 24 ksps channel LP (9 kHz) -> quadrature demod
(gain sps/pi) -> RRC(1.5, 24k, 4800, 0.5) -> M&M symbol sync on 4 levels
-> dibit slicing: first bit (symbol < 0), second bit (|symbol| > 1), the
M17 spec's sign/magnitude dibit map.

TX mirrors src/gr/gr_mod_m17.cpp:30-85: dibits -> map{2,3,1,0} -> levels
{-1.5,-0.5,0.5,1.5} -> RRC interpolation x5 (alpha 0.5) -> x2/3 ->
frequency mod (pi/sps) -> 24k LP -> x0.9 -> resampler 125/3 -> 1 Msps.

Frame-level FEC lives in protocols/m17.py (host side); these chains
carry raw 9600 bit/s hard bits, as the reference does.

On CUDA the 3/125 head is one launch of `resample_dec_f32`, the channel
LP and the RRC `fir_s1_f32` (`ops/cuda_fir.route`), the M&M loop
`symbol_sync_mm_f32` on its 4 levels, and the TX interpolators (5/1,
125/3) `resample_up_f32`; the rest is plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Sequencer, as_iq_pair,
                                       init_states, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import FrequencyMod, QuadratureDemod
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.feedforward import FeedforwardSymbolSync
from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync

LEVELS = (-1.5, -0.5, 0.5, 1.5)
# TX dibit -> level index (the reference's gr_mod_m17.cpp map{2,3,1,0})
TX_MAP = (2, 3, 1, 0)
_PI2 = float(np.pi / 2)


def dibit_bits(syms: torch.Tensor, mag: float) -> torch.Tensor:
    """Sign bit then magnitude bit a symbol: (..., n) -> (..., 2n) uint8,
    (s < 0, |s| > mag)."""
    bits = torch.stack([(syms < 0).to(torch.uint8),
                        (torch.abs(syms) > mag).to(torch.uint8)], dim=-1)
    return bits.reshape(tuple(syms.shape[:-1]) + (syms.shape[-1] * 2,))


def constellation(syms: torch.Tensor, pair: bool = False):
    """exp(i pi/2 s) of real symbols: complex64, or an IqPair (the FF
    chains' form)."""
    ph = _PI2 * syms
    c, s = torch.cos(ph), torch.sin(ph)
    return IqPair(c, s) if pair else torch.complex(c, s)


def scaled(x, k):
    """An IqPair or complex tensor times a real factor (a scalar, or a
    tensor shaped as the samples), plane by plane: the bits of XLA's
    complex product with a real factor, in one pass over a complex
    tensor's interleaved floats."""
    if isinstance(x, IqPair):
        return IqPair(x.re * k, x.im * k)
    if isinstance(k, torch.Tensor):
        k = k[..., None]
    return torch.view_as_complex(torch.view_as_real(x) * k)


def levels_of(bits: torch.Tensor, levels: torch.Tensor,
              tx_map: torch.Tensor) -> torch.Tensor:
    """(..., 2n) bits -> (..., n) f32 levels: dibit v = 2 b0 + b1, level
    levels[tx_map[v]]."""
    b = bits.reshape(tuple(bits.shape[:-1]) + (bits.shape[-1] // 2, 2))
    dibits = b[..., 0].long() * 2 + b[..., 1].long()
    return levels[tx_map[dibits]]


class _M17Rx(Block):
    """The M17 RX front half: 3/125 head, channel LP, rssi, FM
    discriminator, RRC; the symbol sync is the subclass's."""
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
                                         fs / 2, fs / 2,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, filter_width, filter_width,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.quad = QuadratureDemod(self.sps / np.pi, lead_shape=ls,
                                    device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(1.5, fs, self.SYMBOL_RATE, 0.5,
                                      50 * self.sps + 1), lead_shape=ls,
            device=dev)

    def init_state(self):
        return init_states(self.blocks)

    def front(self, seq, iq):
        """(RRC output, rssi) of a block, the states threaded by seq."""
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.quad, x)
        return seq(self.shaping, x), rssi


class M17Demod(_M17Rx):
    """M17 RX: 1 Msps IQ -> hard bits at 9600 bit/s.

    Input: an IqPair or complex (..., T), T a multiple of 625 (decimation
    125, then 5 samples a symbol). Outputs: `bits` (..., 2 T/625) uint8,
    sign bit first; `symbols` f32; `constellation` complex64; `rssi`.

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """

    def __init__(self, filter_width: float = 9000.0, lead_shape: tuple = (),
                 device=None):
        super().__init__(filter_width, lead_shape, device)
        self.symbol_sync = SymbolSync(self.sps, gain_mu=0.085,
                                      gain_omega=0.0038, decisions=LEVELS,
                                      omega_limit=0.05,
                                      lead_shape=tuple(lead_shape),
                                      device=self.device)
        self.blocks = [self.resamp, self.chan_filter, self.quad,
                       self.shaping, self.symbol_sync]

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x, rssi = self.front(seq, iq)
        syms = seq(self.symbol_sync, x)
        return seq.states(), {"bits": dibit_bits(syms, 1.0),
                              "symbols": syms,
                              "constellation": constellation(syms),
                              "rssi": rssi}


class M17DemodFF(_M17Rx):
    """M17 demod with feedforward timing instead of the M&M loop (the
    Fsk4DemodFF substitution). T must be a multiple of 125 * n_sub * sps
    (2500 by default). Outputs as M17Demod's, `constellation` an
    IqPair."""

    def __init__(self, filter_width: float = 9000.0, lead_shape: tuple = (),
                 n_sub: int = 4, device=None):
        super().__init__(filter_width, lead_shape, device)
        self.symbol_sync = FeedforwardSymbolSync(
            self.sps, n_sub=n_sub, lead_shape=tuple(lead_shape),
            device=self.device)
        self.blocks = [self.resamp, self.chan_filter, self.quad,
                       self.shaping, self.symbol_sync]

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x, rssi = self.front(seq, iq)
        syms = seq(self.symbol_sync, x)
        return seq.states(), {"bits": dibit_bits(syms, 1.0),
                              "symbols": syms,
                              "constellation": constellation(syms, True),
                              "rssi": rssi}


class M17Mod(Block):
    """M17 TX: bits (..., 2n), 2 a symbol, sign bit first -> {"iq": 1 Msps
    IQ (..., 125 n 5 / 3)}, complex64 or, with pair=True, an IqPair; 5 n
    must be a multiple of 3."""
    SAMP_RATE = 1_000_000
    SYMBOL_RATE = 4_800

    def __init__(self, filter_width: float = 9000.0, lead_shape: tuple = (),
                 pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        sps = 5
        self.sps = sps
        if_rate = 24_000
        self.shaper = RationalResampler(
            sps, 1, taps=firdes.root_raised_cosine(float(sps), float(sps),
                                                   1.0, 0.5, 50 * sps + 1),
            lead_shape=ls, device=dev)
        self.fm = FrequencyMod(np.pi / sps, lead_shape=ls, pair_out=pair,
                               device=dev)
        self.post_filter = FirFilter(
            firdes.low_pass(1.0, if_rate, filter_width, filter_width,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.up = RationalResampler(
            125, 3, taps=firdes.low_pass(125.0, 3 * self.SAMP_RATE,
                                         if_rate / 2, if_rate / 2,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.levels = torch.tensor(LEVELS, dtype=torch.float32, device=dev)
        self.map = torch.tensor(TX_MAP, dtype=torch.int64, device=dev)
        self.blocks = [self.shaper, self.fm, self.post_filter, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, bits):
        seq = Sequencer(state)
        syms = levels_of(bits, self.levels, self.map)
        x = seq(self.shaper, syms) * (2.0 / 3.0)
        x = seq(self.fm, x)
        x = scaled(seq(self.post_filter, x), 0.9)
        x = seq(self.up, x)
        return seq.states(), {"iq": x}
