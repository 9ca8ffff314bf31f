"""DSSS BPSK chain (Barker-13 spreading) and CW keying (port of
qradiolink_tpu/chains/dsss.py).

DSSS mirrors the reference's src/gr/gr_demod_dsss.cpp:33-115 with
dsss_decoder_cc_impl.cc, and gr_mod_dsss.cpp with dsss_encoder_bb_impl.cc:
each coded bit is spread by the 13-chip Barker code at 25 samples a chip
(208 chips/s at the 5.2 ksps IF, 16 coded bit/s over the air: the "BPSK
DSSS 8" beacon mode). The despreader runs the matched filter once over the
block, folds |correlation| modulo the 325-sample bit period (accumulated
across blocks), samples every bit at the fold's peak and takes the carrier
phase from the squared peaks, kept continuous across blocks.

CW (reference gr_mod_base.cpp:948 set_cw_k and the _usb_cw SSB chain at
gr_mod_base.cpp:180): a keyed 600 Hz tone through the USB modulator, with a
5 ms raised-cosine keying ramp.

On CUDA the resamplers and FIRs run the kernels that `ops/cuda_fir.route`
and `ops/cuda_resample.route` pick, the Costas loop `costas_loop_f32`, the
AGC `agc2_f32` and the streaming Viterbi `viterbi_stream_k7`; the fold,
the peak gather and the phase estimate are plain PyTorch. CwMod is the
port's SsbMod behind a FIR.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Sequencer, init_states,
                                       resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.agc import Agc2
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.costas import CostasLoop
from qradiolink_tpu_torch.chains.digital_common import (RxFecTail, TxFecHead,
                                                       bytes_to_bits)
from qradiolink_tpu_torch.chains.m17 import scaled
from qradiolink_tpu_torch.chains.ssb import SsbMod

BARKER_13 = np.array([1, 1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1], np.int64)
CHIP_SPS = 25          # samples per chip at 5.2 ksps
IF_RATE = 5_200
BIT_SAMPLES = CHIP_SPS * 13   # 325 samples per coded bit
BLOCK_MULTIPLE = 62_500       # input samples (1 Msps) a coded bit


def _matched_taps() -> np.ndarray:
    """RRC-shaped spread waveform (dsss_decoder_cc_impl.cc:60-100):
    time-reversed code, zero-order hold x25, RRC(alpha=0.35) filtered."""
    levels = np.where(BARKER_13[::-1] == 0, -1.0, 1.0)
    zoh = np.repeat(levels, CHIP_SPS)
    rrc = firdes.root_raised_cosine(1.0, float(CHIP_SPS), 1.0, 0.35,
                                    11 * CHIP_SPS)
    return np.convolve(zoh, rrc).astype(np.float32)


class DsssBpskDemod(Block):
    """DSSS BPSK RX: 1 Msps IQ (complex or an IqPair) -> hard bits at 16
    bit/s. T must be a multiple of 62,500 (one coded bit: 1 Msps -> x1/50
    -> x13/50 -> 325 samples at 5.2 ksps). Outputs: `bits`, `bits_alt`,
    `bits_inv`, `bits_alt_inv` (the two pairings, each at both
    polarities), `rssi`, `symbols` (complex64). State: (the blocks'
    states, the carrier phase (...), the fold (..., 325), the last soft
    value (..., 1)), as in the JAX package.
    """
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float = 150.0, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.lead_shape = ls
        self.resamp = RationalResampler(
            1, 50, taps=firdes.low_pass(1.0, self.SAMP_RATE, 10_000.0,
                                        10_000.0, firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.resamp_if = RationalResampler(
            13, 50, taps=firdes.low_pass(1.0, 20_000, IF_RATE / 2,
                                         IF_RATE / 2,
                                         firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.costas_freq = CostasLoop(np.pi / 200, 2, lead_shape=ls,
                                      device=dev)
        self.chan_filter = FirFilter(
            firdes.low_pass(1.0, IF_RATE, filter_width, 1200.0,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.agc = Agc2(attack_rate=1e-1, decay_rate=1e-1, reference=1.0,
                        lead_shape=ls, device=dev)
        self.matched = FirFilter(_matched_taps(), lead_shape=ls, device=dev)
        # 4 decode streams: {pairing, delayed pairing} x {+, -} polarity;
        # the BPSK carrier ambiguity is resolved by whichever stream frames
        self.fec_tail = RxFecTail(lead_shape=(4,) + ls, device=dev)
        self.blocks = [self.resamp, self.resamp_if, self.costas_freq,
                       self.chan_filter, self.agc, self.matched,
                       self.fec_tail]

    def init_state(self):
        ls, dev = self.lead_shape, self.device
        return (init_states(self.blocks),
                torch.zeros(ls, dtype=torch.float32, device=dev),
                torch.zeros(ls + (BIT_SAMPLES,), dtype=torch.float32,
                            device=dev),
                torch.full(ls + (1,), 128.0, dtype=torch.float32,
                           device=dev))

    def __call__(self, state, iq):
        blocks_state, phase_prev, fold_acc, last_soft = state
        seq = Sequencer(blocks_state)
        x = seq(self.resamp_if, seq(self.resamp, iq))
        if isinstance(x, IqPair):
            x = x.to_complex()
        x = seq(self.costas_freq, x)
        x = seq(self.chan_filter, x)
        rssi = rssi_dbm(x)
        x = seq(self.agc, x)
        m = seq(self.matched, x)
        # feedforward despread timing: fold |correlation| modulo the bit
        # period and sample every bit at the fold's peak (the reference's
        # per-window max search, dsss_decoder_cc_impl.cc:135-158), the fold
        # accumulated across blocks
        n_bits = m.shape[-1] // BIT_SAMPLES
        w = m[..., :n_bits * BIT_SAMPLES].reshape(
            tuple(m.shape[:-1]) + (n_bits, BIT_SAMPLES))
        fold = torch.sum(torch.abs(w), dim=-2)               # (..., 325)
        fold_acc = 0.75 * fold_acc + fold
        p = torch.argmax(fold_acc, dim=-1)                   # first on ties
        idx = p[..., None, None].expand(tuple(w.shape[:-1]) + (1,))
        peaks = torch.gather(w, -1, idx)[..., 0] * (2.0 / BIT_SAMPLES)
        # feedforward M2 carrier phase (squaring estimator), continuous
        # with the previous block's estimate
        z = torch.sum(peaks * peaks, dim=-1)
        ang = 0.5 * torch.angle(z)
        d = torch.remainder(ang - phase_prev + np.pi / 2, np.pi) - np.pi / 2
        ang = phase_prev + d
        syms = peaks * torch.exp(-1j * ang)[..., None]
        soft = torch.clamp(syms.real * 64.0 * BIT_SAMPLES / 2 + 128.0,
                           0.0, 255.0)
        delayed = torch.cat([last_soft, soft[..., :-1]], dim=-1)
        last_soft = soft[..., -1:]
        both = torch.stack([soft, delayed, 255.0 - soft, 255.0 - delayed],
                           dim=0)
        bits4 = seq(self.fec_tail, both)
        return (seq.states(), ang, fold_acc, last_soft), {
            "bits": bits4[0], "bits_alt": bits4[1],
            "bits_inv": bits4[2], "bits_alt_inv": bits4[3],
            "rssi": rssi, "symbols": syms}


class DsssBpskMod(Block):
    """DSSS BPSK TX: uint8 bytes (..., N) -> spread chips -> RRC -> 1 Msps
    IQ, {"iq": complex64}."""
    SAMP_RATE = 1_000_000

    def __init__(self, filter_width: float = 1700.0, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.fec_head = TxFecHead(lead_shape=ls, device=dev)
        self.code = torch.from_numpy(BARKER_13.astype(np.uint8)).to(dev)
        self.shaper = RationalResampler(
            CHIP_SPS, 1, taps=firdes.root_raised_cosine(
                float(CHIP_SPS), float(CHIP_SPS), 1.0, 0.35, 11 * CHIP_SPS),
            lead_shape=ls, device=dev)
        self.post = FirFilter(
            firdes.low_pass(1.0, IF_RATE, filter_width, 1200.0,
                            firdes.WIN_BLACKMAN_HARRIS), lead_shape=ls,
            device=dev)
        self.up_if = RationalResampler(
            50, 13, taps=firdes.low_pass(50.0, IF_RATE * 50, filter_width,
                                         filter_width * 5), lead_shape=ls,
            device=dev)
        self.up_rf = RationalResampler(
            50, 1, taps=firdes.low_pass(50.0, self.SAMP_RATE, filter_width,
                                        filter_width * 5), lead_shape=ls,
            device=dev)
        self.blocks = [self.fec_head, self.shaper, self.post,
                       self.up_if, self.up_rf]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, data_bytes):
        seq = Sequencer(state)
        coded = seq(self.fec_head, bytes_to_bits(data_bytes))
        # spread: chip = code XOR bit (dsss_encoder_bb_impl.cc:76-86)
        chips = torch.bitwise_xor(self.code,
                                  coded[..., :, None].to(torch.uint8))
        chips = chips.reshape(tuple(coded.shape[:-1])
                              + (coded.shape[-1] * 13,))
        syms = 2.0 * chips.to(torch.float32) - 1.0
        x = scaled(seq(self.shaper, syms.to(torch.complex64)), 0.65)
        x = seq(self.post, x)
        x = seq(self.up_if, x)
        x = seq(self.up_rf, x)
        return seq.states(), {"iq": x}


class CwMod(Block):
    """CW TX: key envelope (..., T) at 8 kHz, 0/1 -> keyed 600 Hz tone ->
    USB, {"iq": complex64 at 1 Msps}. Mirrors the reference's
    ModemTypeCW600USB path (gr_mod_base.cpp:180,466-468,948). State: (the
    key filter's, the SSB modulator's, the tone phase, a 0-d f32)."""
    SAMP_RATE = 1_000_000
    TONE_HZ = 600.0

    def __init__(self, lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.ssb = SsbMod(usb=True, lead_shape=ls, device=dev)
        # 5 ms keying ramp at 8 kHz (40 taps)
        ramp = np.hanning(80)[:40]
        self.key_filter = FirFilter((ramp / ramp.sum()).astype(np.float32),
                                    lead_shape=ls, device=dev)
        self.blocks = [self.key_filter, self.ssb]

    def init_state(self):
        return (self.key_filter.init_state(), self.ssb.init_state(),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def __call__(self, state, key):
        kf_state, ssb_state, phase = state
        kf_state, env = self.key_filter(kf_state, key.to(torch.float32))
        t = torch.arange(env.shape[-1], dtype=torch.float32,
                         device=env.device)
        w = 2 * np.pi * self.TONE_HZ / 8000.0
        tone = torch.sin(phase + w * t) * env
        phase = torch.remainder(phase + w * env.shape[-1], 2 * np.pi)
        ssb_state, out = self.ssb(ssb_state, tone)
        return (kf_state, ssb_state, phase), out
