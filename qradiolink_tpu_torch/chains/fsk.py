"""FSK-family digital chains: 4FSK, 2FSK, GMSK (port of
qradiolink_tpu/chains/fsk.py; reference chains: qradiolink's
src/gr/gr_demod_4fsk.cpp, gr_mod_4fsk.cpp, gr_demod_2fsk.cpp,
gr_mod_2fsk.cpp, gr_demod_gmsk.cpp, gr_mod_gmsk.cpp).

RX: resampler -> channel LP -> quadrature demod (or a filter bank of
complex band-passes) -> RRC or symbol LP -> M&M symbol sync (or the
feedforward sync of Fsk4DemodFF) -> soft bits -> Viterbi -> descrambler.
The 2FSK/GMSK chains decode two bit pairings at once (delay diversity) by
running the streaming Viterbi over a leading axis of 2.
TX: bytes -> bits -> scramble -> conv encode -> (dibits, Gray map) -> pulse
shape -> frequency modulator -> interpolate to 1 Msps.

On CUDA the FIRs and resamplers run the kernels that `ops/cuda_fir.route`
and `ops/cuda_resample.route` pick for their shapes (complex taps, such as
the filter banks' band-passes, as two launches), the M&M loop
`symbol_sync_mm_f32`, the streaming Viterbi `viterbi_stream_k7` and the
tiled one `viterbi_bfly_k7`; everything else is plain PyTorch.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Sequencer, as_iq_pair,
                                       init_states, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import (ComplexToMag, FrequencyMod,
                                             QuadratureDemod)
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.feedforward import FeedforwardSymbolSync
from qradiolink_tpu_torch.sync.slicer import Fsk4Discriminator
from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync
from qradiolink_tpu_torch.chains.digital_common import (
    RxFecTail, RxFecTailFF, TxFecHead, bytes_to_bits, pack_dibits)
from qradiolink_tpu_torch.chains.m17 import scaled

_4FSK_LEVELS = (-1.5, -0.5, 0.5, 1.5)
_4FSK_MAP = (0, 1, 3, 2)  # Gray map, reference gr_mod_4fsk.cpp map
_PI2 = float(np.pi / 2)

# RX variant table (reference gr_demod_4fsk.cpp:46-74 sps dispatch +
# gr_demod_base.cpp:211-225 per-mode filter widths):
#   name    -> (resamp L, M, target rate, symbol rate, default fw)
_4FSK_RX_VARIANTS = {
    "2KFM": (1, 50, 20_000, 2_000, 3000.0),    # sps=5, FM
    "2K": (1, 50, 20_000, 2_000, 4000.0),      # sps=5, filter bank
    "1KFM": (1, 100, 10_000, 1_000, 2000.0),   # sps=10
    "10KFM": (2, 25, 80_000, 10_000, 20000.0),  # sps=1 "INET"
    "96K": (1, 2, 500_000, 100_000, 125000.0),  # sps=2 IP modem
}
# TX variant table (gr_mod_4fsk.cpp:50-62 + gr_mod_base.cpp:163-177):
#   name -> (symbol rate, pulse sps, [interp factors to 1 Msps], fw)
_4FSK_TX_VARIANTS = {
    "2KFM": (2_000, 5, ((20, 1), (5, 1)), 3500.0),
    "2K": (2_000, 5, ((20, 1), (5, 1)), 4000.0),
    "1KFM": (1_000, 10, ((20, 1), (5, 1)), 2000.0),
    "10KFM": (10_000, 8, ((25, 2), (1, 1)), 20000.0),
    "96K": (100_000, 5, ((2, 1), (1, 1)), 125000.0),
}
# |x| with the reference's flush of a denormal |x|^2 to zero (XLA on the CPU
# and the TPU flushes denormals, PyTorch keeps them): the filter banks'
# magnitudes, which the 4FSK discriminator compares for a strict maximum
_mag = ComplexToMag().apply


def _head(L, M, fs, ls, dev):
    """The 4FSK chains' L/M head to the target rate fs, Blackman-Harris."""
    return RationalResampler(
        L, M, taps=firdes.low_pass(float(L), L * 1_000_000, fs / 2, fs / 2,
                                   firdes.WIN_BLACKMAN_HARRIS),
        lead_shape=ls, device=dev)


def _soft_pair(syms):
    """exp(i pi/2 s) of real 4-level symbols as the soft pair (sin, cos) a
    symbol in [0, 255], interleaved as the reference's FM variant does,
    and the IqPair (cos, sin)."""
    ph = _PI2 * syms
    c, s = torch.cos(ph), torch.sin(ph)
    soft = torch.stack([s, c], dim=-1)
    soft = soft.reshape(tuple(syms.shape[:-1]) + (syms.shape[-1] * 2,))
    return torch.clamp(soft * 128.0 + 128.0, 0.0, 255.0), IqPair(c, s)


def _delay_diversity(soft):
    """(soft, soft delayed by one with 128 first) on a new leading axis of
    2: the two coded-bit pairings the binary chains decode."""
    delayed = torch.cat([torch.full(tuple(soft.shape[:-1]) + (1,), 128.0,
                                    dtype=soft.dtype, device=soft.device),
                         soft[..., :-1]], dim=-1)
    return torch.stack([soft, delayed], dim=0)


class Fsk4Demod(Block):
    """4FSK FM-discriminator demod (reference gr_demod_4fsk.cpp fm=true).

    Default variant "2KFM": 1 Msps -> 20 ksps, 2000 sym/s (10 samp/sym), 2
    soft bits a symbol from the phase_mod(pi/2) projection, CCSDS tail.
    Variants: 1KFM (10 ksps), 10KFM (80 ksps), 96K (500 ksps). Input: an
    IqPair or complex (..., T), T a multiple of M and of M sps / L.
    Outputs: `bits` uint8, `constellation` (an IqPair), `rssi`,
    `symbols`.

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float | None = None,
                 lead_shape: tuple = (), variant: str = "2KFM", device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        L, M, fs, sym_rate, default_fw = _4FSK_RX_VARIANTS[variant]
        if filter_width is None:
            filter_width = default_fw
        self.TARGET_RATE = fs
        self.SYMBOL_RATE = sym_rate
        self.sps = fs // sym_rate
        self.resamp = _head(L, M, fs, ls, dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, filter_width, filter_width / 2,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.quad = QuadratureDemod(self.sps / np.pi, lead_shape=ls,
                                    device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(1.5, fs, self.SYMBOL_RATE, 0.2,
                                      25 * self.sps + 1), lead_shape=ls,
            device=dev)
        # gains from the reference's symbol_sync_ff(loop_bw 2*pi/200,
        # damping 1.0, ted_gain 0.2869) (gr_demod_4fsk.cpp:135)
        self.symbol_sync = SymbolSync(self.sps, gain_mu=0.085,
                                      gain_omega=0.0038,
                                      decisions=_4FSK_LEVELS,
                                      omega_limit=0.05, lead_shape=ls,
                                      device=dev)
        self.fec_tail = RxFecTail(lead_shape=ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.quad, self.shaping,
                       self.symbol_sync, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.quad, x)
        x = seq(self.shaping, x)
        syms = seq(self.symbol_sync, x)
        soft, const_tap = _soft_pair(syms)
        bits = seq(self.fec_tail, soft)
        return seq.states(), {"bits": bits, "constellation": const_tap,
                              "rssi": rssi, "symbols": syms}


class Fsk4DemodFF(Block):
    """4FSK demod with feedforward timing and a tiled Viterbi.

    Input: an IqPair of f32 planes (..., T), or a complex tensor, split into
    planes at the head. Block length T must be a multiple of M * n_sub * sps
    (2000 for the default 2KFM variant). Outputs: `bits` (..., T/M/sps)
    uint8, `symbols`, `rssi` (dB of the channel-filtered block) and
    `constellation` (an IqPair).

    device: None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch path.
    """
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float | None = None,
                 lead_shape: tuple = (), n_sub: int = 4,
                 variant: str = "2KFM", sync_window: int | None = None,
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        L, M, fs, sym_rate, default_fw = _4FSK_RX_VARIANTS[variant]
        if filter_width is None:
            filter_width = default_fw
        self.TARGET_RATE = fs
        self.SYMBOL_RATE = sym_rate
        self.sps = fs // sym_rate
        self.resamp = _head(L, M, fs, ls, dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, filter_width, filter_width / 2,
                            firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.quad = QuadratureDemod(self.sps / np.pi, lead_shape=ls,
                                    device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(1.5, fs, self.SYMBOL_RATE, 0.2,
                                      25 * self.sps + 1),
            lead_shape=ls, device=dev)
        self.symbol_sync = FeedforwardSymbolSync(
            self.sps, n_sub=n_sub, window=sync_window, lead_shape=ls,
            device=dev)
        self.fec_tail = RxFecTailFF(lead_shape=ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.quad, self.shaping,
                       self.symbol_sync, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.quad, x)
        x = seq(self.shaping, x)
        syms = seq(self.symbol_sync, x)
        soft, const_tap = _soft_pair(syms)
        bits = seq(self.fec_tail, soft)
        return seq.states(), {"bits": bits, "constellation": const_tap,
                              "rssi": rssi, "symbols": syms}


class Fsk4Mod(Block):
    """4FSK TX (reference gr_mod_4fsk.cpp + gr_mod_base interpolation).

    Default "2KFM": 2 ksym/s -> RRC x5 -> FM -> x20 -> x5 -> 1 Msps (FM
    variants: spacing 1, amplif 0.9, pulse gain 2/3). The non-FM "2K"
    holds each symbol sps samples (zero-order hold) with tone spacing 2 and
    amplif 0.8 (gr_mod_4fsk.cpp:64-70,106-112). Variants: 1KFM, 10KFM, 96K.
    Input: uint8 bytes (..., N). Output: {"iq": complex64, or an IqPair
    with pair=True}.
    """
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float | None = None,
                 lead_shape: tuple = (), variant: str = "2KFM",
                 pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        sym_rate, sps, ups, default_fw = _4FSK_TX_VARIANTS[variant]
        if filter_width is None:
            filter_width = default_fw
        self.SYMBOL_RATE = sym_rate
        self.fm_variant = variant.endswith("FM") or variant == "96K"
        self.fec_head = TxFecHead(lead_shape=ls, device=dev)
        self.sps = sps
        if self.fm_variant:
            self.shaper = RationalResampler(
                sps, 1, taps=firdes.root_raised_cosine(
                    float(sps), float(sps), 1.0, 0.2, 10 * sps + 1),
                lead_shape=ls, device=dev)
            spacing, self.amplif = 1.0, 0.9
        else:
            # zero-order hold: unit taps, each output sees one input
            self.shaper = RationalResampler(
                sps, 1, taps=np.ones(sps, np.float32), lead_shape=ls,
                device=dev)
            spacing, self.amplif = 2.0, 0.8
        self.fm = FrequencyMod(spacing * np.pi / sps, lead_shape=ls,
                               pair_out=pair, device=dev)
        rate1 = sym_rate * sps
        (l1, m1), (l2, m2) = ups
        self.up1 = RationalResampler(
            l1, m1, taps=firdes.low_pass(float(l1), l1 * rate1,
                                         filter_width, filter_width,
                                         firdes.WIN_HAMMING),
            lead_shape=ls, device=dev)
        self.up2 = RationalResampler(l2, m2, lead_shape=ls, device=dev) \
            if (l2, m2) != (1, 1) else None
        self.levels = torch.tensor(_4FSK_LEVELS, dtype=torch.float32,
                                   device=dev)
        self.map = torch.tensor(_4FSK_MAP, dtype=torch.int64, device=dev)
        self.blocks = [self.fec_head, self.shaper, self.fm, self.up1] + \
            ([self.up2] if self.up2 is not None else [])

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, data_bytes):
        seq = Sequencer(state)
        coded = seq(self.fec_head, bytes_to_bits(data_bytes))
        syms = self.levels[self.map[pack_dibits(coded).long()]]
        x = seq(self.shaper, syms)
        if self.fm_variant:
            x = x * (2.0 / 3.0)
        x = scaled(seq(self.fm, x), self.amplif)
        x = seq(self.up1, x)
        if self.up2 is not None:
            x = seq(self.up2, x)
        return seq.states(), {"iq": x}


class Fsk4FbDemod(Block):
    """4FSK filter-bank demod, the reference's non-FM 4FSK2K variant
    (gr_demod_4fsk.cpp:110-198, fm=false branch).

    Four complex band-passes isolate the tones ([-fw,-fw+rs], [-fw+rs,0],
    [0,fw-rs], [fw-rs,fw]); the strict maximum of the tone magnitudes maps
    each sample to a QPSK corner (Fsk4Discriminator); a symbol LP and the
    complex M&M sync (its conj mode) recover symbols, whose I/Q signs are
    the soft pair. Input and outputs as Fsk4Demod's; `constellation` is
    the complex64 symbols.
    """
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float = 4000.0, lead_shape: tuple = (),
                 variant: str = "2K", device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        L, M, fs, sym_rate, _ = _4FSK_RX_VARIANTS[variant]
        self.TARGET_RATE = fs
        self.SYMBOL_RATE = sym_rate
        self.sps = fs // sym_rate
        rs = float(sym_rate)
        fw = float(filter_width)
        bw = 2 * rs  # transition width (reference bw=4000 at rs=2000)
        self.resamp = _head(L, M, fs, ls, dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, fw, fw / 2, firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        bands = [(-fw, -fw + rs), (-fw + rs, 0.0), (0.0, fw - rs),
                 (fw - rs, fw)]
        self.tone_bank = [
            FirFilter(firdes.complex_band_pass(
                1.0, fs, lo, hi, bw, firdes.WIN_BLACKMAN_HARRIS),
                lead_shape=ls, device=dev)
            for lo, hi in bands]
        self.discriminator = Fsk4Discriminator(device=dev)
        self.symbol_filter = FirFilter(
            firdes.low_pass(1.0, fs, rs, rs / 20,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.symbol_sync = SymbolSync(self.sps, gain_mu=0.085,
                                      gain_omega=0.0038, decisions=None,
                                      omega_limit=0.05, lead_shape=ls,
                                      device=dev)
        self.fec_tail = RxFecTail(lead_shape=ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, *self.tone_bank,
                       self.symbol_filter, self.symbol_sync, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        mags = torch.stack([_mag(seq(f, x)) for f in self.tone_bank], dim=-2)
        pts = self.discriminator(mags)                  # (..., T) complex
        pts = seq(self.symbol_filter, pts)
        syms = seq(self.symbol_sync, pts)
        # non-FM tail: I then Q soft pair (gr_demod_4fsk.cpp:188-191),
        # 0.707 to full scale
        soft = torch.stack([syms.real, syms.imag], dim=-1)
        soft = soft.reshape(tuple(syms.shape[:-1]) + (syms.shape[-1] * 2,))
        soft = torch.clamp(soft * 181.0 + 128.0, 0.0, 255.0)
        bits = seq(self.fec_tail, soft)
        return seq.states(), {"bits": bits, "constellation": syms,
                              "rssi": rssi, "symbols": syms}


def _binary_head(target_rate, ls, dev):
    """1 Msps -> target_rate by the default Kaiser design."""
    fr = Fraction(target_rate, 1_000_000)
    return RationalResampler(fr.numerator, fr.denominator, lead_shape=ls,
                             device=dev)


def _binary_sync(sps, ls, dev):
    return SymbolSync(sps, gain_mu=0.085, gain_omega=0.0038,
                      decisions=(-1.0, 1.0), omega_limit=0.05,
                      lead_shape=ls, device=dev)


class _BinaryFskDemodBase(Block):
    """Shared RX of the 2FSK/GMSK FM-discriminator chains: outputs `bits`
    and `bits_alt` (the two pairings), `rssi`, `symbols`."""
    SAMP_RATE = 1_000_000

    def __init__(self, target_rate: int, symbol_rate: int, quad_gain: float,
                 shaping_taps, filter_width: float, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.sps = target_rate // symbol_rate
        self.resamp = _binary_head(target_rate, ls, dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, target_rate, filter_width, filter_width / 2,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.quad = QuadratureDemod(quad_gain, lead_shape=ls, device=dev)
        self.shaping = FirFilter(shaping_taps, lead_shape=ls, device=dev)
        self.symbol_sync = _binary_sync(self.sps, ls, dev)
        # delay diversity: both coded-bit pairings decoded at once
        self.fec_tail = RxFecTail(lead_shape=(2,) + ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.quad, self.shaping,
                       self.symbol_sync, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.quad, x)
        x = seq(self.shaping, x)
        syms = seq(self.symbol_sync, x)
        soft = torch.clamp(syms * 128.0 + 128.0, 0.0, 255.0)
        bits2 = seq(self.fec_tail, _delay_diversity(soft))
        return seq.states(), {"bits": bits2[0], "bits_alt": bits2[1],
                              "rssi": rssi, "symbols": syms}


class Fsk2Demod(_BinaryFskDemodBase):
    """2FSK FM variant (reference gr_demod_2fsk.cpp, sps=5 -> 1 ksym/s at
    20 ksps; RRC(alpha=0.2) shaping). target_rate=80_000 with
    symbol_rate=20_000 is the sps=4 "10K" IP-modem config
    (gr_demod_2fsk.cpp:56-63)."""

    def __init__(self, symbol_rate: int = 1000, filter_width: float = 2500.0,
                 lead_shape: tuple = (), target_rate: int = 20_000,
                 device=None):
        sps = target_rate // symbol_rate
        super().__init__(
            target_rate, symbol_rate,
            quad_gain=target_rate / (2 * np.pi * filter_width),
            shaping_taps=firdes.root_raised_cosine(
                1.0, target_rate, symbol_rate, 0.2, 15 * sps + 1),
            filter_width=filter_width, lead_shape=lead_shape, device=device)


class Fsk2FbDemod(Block):
    """2FSK filter-bank (non-FM) demod, reference gr_demod_2fsk.cpp
    fm=false branch: upper/lower complex band-passes -> magnitude ratio
    upper / lower -> rail [0, 2] -> -1 -> symbol LP -> binary M&M sync ->
    delay-diversity CCSDS tail. Outputs as Fsk2Demod's."""
    SAMP_RATE = 1_000_000

    def __init__(self, symbol_rate: int = 1000, filter_width: float = 2000.0,
                 lead_shape: tuple = (), target_rate: int = 20_000,
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = target_rate
        fw = float(filter_width)
        self.sps = fs // symbol_rate
        self.resamp = _binary_head(target_rate, ls, dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, fs, fw, fw, firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        # mark -> [0, fw] (upper), space -> [-fw, 0] (lower)
        self.lower = FirFilter(
            firdes.complex_band_pass(1.0, fs, -fw, 0.0, fw,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.upper = FirFilter(
            firdes.complex_band_pass(1.0, fs, 0.0, fw, fw,
                                     firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.symbol_filter = FirFilter(
            firdes.low_pass(1.0, fs, symbol_rate, symbol_rate,
                            firdes.WIN_HAMMING), lead_shape=ls, device=dev)
        self.symbol_sync = _binary_sync(self.sps, ls, dev)
        self.fec_tail = RxFecTail(lead_shape=(2,) + ls, device=dev)
        self.blocks = [self.resamp, self.chan_filter, self.lower, self.upper,
                       self.symbol_filter, self.symbol_sync, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        lo = _mag(seq(self.lower, x))
        hi = _mag(seq(self.upper, x))
        r = torch.clamp(hi / (lo + 1e-9), 0.0, 2.0) - 1.0
        r = seq(self.symbol_filter, r)
        syms = seq(self.symbol_sync, r)
        soft = torch.clamp(syms * 128.0 + 128.0, 0.0, 255.0)
        bits2 = seq(self.fec_tail, _delay_diversity(soft))
        return seq.states(), {"bits": bits2[0], "bits_alt": bits2[1],
                              "rssi": rssi, "symbols": syms}


class GmskDemod(_BinaryFskDemodBase):
    """GMSK (reference gr_demod_gmsk.cpp): quad gain sps/(pi/2), symbol
    LP. target_rate=80_000 with symbol_rate=20_000 is the GMSK10K config
    (gr_demod_gmsk.cpp:53-60: 80 ksps, 4 samples/symbol)."""

    def __init__(self, symbol_rate: int = 1000, filter_width: float = 2500.0,
                 lead_shape: tuple = (), target_rate: int = 20_000,
                 device=None):
        sps = target_rate // symbol_rate
        super().__init__(
            target_rate, symbol_rate, quad_gain=sps / (np.pi / 2),
            shaping_taps=firdes.low_pass(1.0, target_rate, symbol_rate,
                                         symbol_rate / 2, firdes.WIN_HAMMING),
            filter_width=filter_width, lead_shape=lead_shape, device=device)


class _BinaryFskModBase(Block):
    """Shared TX of the 2FSK/GMSK chains: bytes -> coded bits -> +-1 ->
    the shaper (x sps) -> FM -> x0.9 -> the default interpolator to 1
    Msps. Output: {"iq": complex64, or an IqPair with pair=True}."""
    SAMP_RATE = 1_000_000

    def __init__(self, symbol_rate: int, sensitivity_num: float,
                 shaper, filter_width: float, lead_shape: tuple = (),
                 pair: bool = False, device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.fec_head = TxFecHead(lead_shape=ls, device=dev)
        self.shaper = shaper
        rate_after = symbol_rate * self.sps_total
        self.fm = FrequencyMod(sensitivity_num / self.sps_total,
                               lead_shape=ls, pair_out=pair, device=dev)
        self.up = RationalResampler(self.SAMP_RATE // rate_after, 1,
                                    lead_shape=ls, device=dev)
        self.blocks = [self.fec_head, self.shaper, self.fm, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, data_bytes):
        seq = Sequencer(state)
        coded = seq(self.fec_head, bytes_to_bits(data_bytes))
        syms = 2.0 * coded.to(torch.float32) - 1.0
        x = seq(self.shaper, syms)
        x = scaled(seq(self.fm, x), 0.9)
        x = seq(self.up, x)
        return seq.states(), {"iq": x}


class Fsk2Mod(_BinaryFskModBase):
    def __init__(self, symbol_rate: int = 1000, filter_width: float = 2500.0,
                 lead_shape: tuple = (), device=None):
        sps = 5
        self.sps_total = sps
        shaper = RationalResampler(
            sps, 1, taps=firdes.root_raised_cosine(float(sps), float(sps),
                                                   1.0, 0.2, 25 * sps + 1),
            lead_shape=tuple(lead_shape), device=resolve_device(device))
        super().__init__(symbol_rate, np.pi / 2, shaper, filter_width,
                         lead_shape, device=device)


class GmskMod(_BinaryFskModBase):
    def __init__(self, symbol_rate: int = 1000, filter_width: float = 2500.0,
                 lead_shape: tuple = (), device=None):
        sps = 5
        self.sps_total = sps
        # Gaussian pulse (BT 0.35) after an x sps zero-order hold
        g = firdes.gaussian(1.0 / sps, sps, 0.35, 4 * sps)
        taps = np.convolve(g, np.ones(sps, np.float32)).astype(np.float32)
        shaper = RationalResampler(sps, 1, taps=taps * sps,
                                   lead_shape=tuple(lead_shape),
                                   device=resolve_device(device))
        super().__init__(symbol_rate, np.pi / 2, shaper, filter_width,
                         lead_shape, device=device)
