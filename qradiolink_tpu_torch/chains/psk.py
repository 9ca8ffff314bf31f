"""PSK digital chains, BPSK and DQPSK (port of qradiolink_tpu/chains/psk.py).

BPSK mirrors the reference's src/gr/gr_demod_bpsk.cpp:33-105 (1 Msps ->
1/50 -> 20 ksps; FLL band-edge -> RRC -> AGC2 -> M&M clock recovery ->
Costas (order 2) -> real -> x64+128 soft -> dual delay-diversity CCSDS
decode) and gr_mod_bpsk.cpp (+/-1 symbols, RRC interpolation, x0.6).
DQPSK mirrors gr_demod_qpsk.cpp:33-159 (resampler -> FLL -> RRC -> AGC2 ->
Costas PLL (order 4) -> M&M symbol sync -> Costas -> diff phasor -> rotate
e^{-i3pi/4} -> interleaved I/Q soft x48+128 -> CCSDS tail) and
gr_mod_qpsk.cpp (Gray map -> differential phase -> QPSK points -> RRC):
dibit v = 2 b0 + b1 -> phase steps [0, 3, 1, 2][v], symbol
exp(i(pi/4 + q pi/2)), q accumulated mod 4.

On CUDA the heads and filters run the routed FIR kernels (the QPSK250K
head K83 D2 on `fir_cols_f32`, the BPSK head K419 D50 on `fir_decim_f32`,
the RRCs and the FLL's band-edge filters on `fir_s1_f32`), the modulators'
interpolators the routed resampler kernels, `Agc2` `agc2_gain_f32`, the
Costas loops `costas_loop_f32`, the symbol sync `symbol_sync_mm_f32` and
the Viterbi `viterbi_stream_k7`; the FLL's sub-block loop and the small
ops between the stages are plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, Sequencer, as_iq_pair,
                                       init_states, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.agc import Agc2
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.costas import CostasLoop
from qradiolink_tpu_torch.sync.fll import FllBandEdge
from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync
from qradiolink_tpu_torch.chains.digital_common import (
    RxFecTail, TxFecHead, bytes_to_bits, pack_dibits)


def _scaled(x: torch.Tensor, k: float) -> torch.Tensor:
    """A complex tensor times a real factor, plane by plane (the bits of
    XLA's complex product with a real factor)."""
    return torch.complex(x.real * k, x.imag * k)


class BpskDemod(Block):
    """BPSK demod. Input: an IqPair or complex (..., T) at 1 Msps, T a
    multiple of 1000 at the default 2,000 symbols/s (so that each block
    gives whole symbol pairs). Outputs: `bits` and `bits_alt` (the two
    delay-diversity pairings), `constellation`, `rssi`."""
    SAMP_RATE = 1_000_000
    TARGET_RATE = 20_000

    def __init__(self, symbol_rate: int = 2000, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        fs = self.TARGET_RATE
        self.sps = fs // symbol_rate
        self.resamp = RationalResampler(
            1, 50, taps=firdes.low_pass(1.0, self.SAMP_RATE, fs / 2, fs / 2,
                                        firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.fll = FllBandEdge(self.sps, 0.35, 32, 8 * np.pi / 100,
                               lead_shape=ls, device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(float(self.sps), float(self.sps), 1.0,
                                      0.35, 15 * self.sps + 1),
            lead_shape=ls, device=dev)
        self.agc = Agc2(1e-1, 1e-1, reference=1.0, lead_shape=ls, device=dev)
        self.symbol_sync = SymbolSync(self.sps, gain_mu=0.05,
                                      gain_omega=2.5e-5, omega_limit=0.001,
                                      lead_shape=ls, device=dev)
        self.costas = CostasLoop(2 * np.pi / 200.0, order=2, lead_shape=ls,
                                 device=dev)
        self.fec_tail = RxFecTail(lead_shape=(2,) + ls, device=dev)
        self.blocks = [self.resamp, self.fll, self.shaping, self.agc,
                       self.symbol_sync, self.costas, self.fec_tail]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, iq):
        seq = Sequencer(state)
        x = seq(self.resamp, as_iq_pair(iq))
        rssi = rssi_dbm(x)
        x = seq(self.fll, x)
        x = seq(self.shaping, x)
        x = seq(self.agc, x)
        syms = seq(self.symbol_sync, x)
        syms = seq(self.costas, syms)
        soft = torch.clamp(syms.real * 64.0 + 128.0, 0.0, 255.0)
        delayed = torch.cat([torch.full(tuple(soft.shape[:-1]) + (1,), 128.0,
                                        device=soft.device),
                             soft[..., :-1]], dim=-1)
        bits2 = seq(self.fec_tail, torch.stack([soft, delayed], dim=0))
        return seq.states(), {"bits": bits2[0], "bits_alt": bits2[1],
                              "constellation": syms, "rssi": rssi}


class BpskMod(Block):
    """BPSK mod: bytes (..., N) -> {"iq": complex64 (..., 4000 N)} at the
    default 2,000 symbols/s (RRC at 10 samples a symbol, then x50)."""
    SAMP_RATE = 1_000_000

    def __init__(self, symbol_rate: int = 2000, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.fec_head = TxFecHead(lead_shape=ls, device=dev)
        sps = 10  # shape at 10 samples a symbol, then up to the device rate
        self.sps = sps
        self.shaper = RationalResampler(
            sps, 1, taps=firdes.root_raised_cosine(float(sps), float(sps),
                                                   1.0, 0.35, 11 * sps + 1),
            lead_shape=ls, device=dev)
        self.up = RationalResampler(self.SAMP_RATE // (symbol_rate * sps), 1,
                                    lead_shape=ls, device=dev)
        self.blocks = [self.fec_head, self.shaper, self.up]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, data_bytes):
        seq = Sequencer(state)
        coded = seq(self.fec_head, bytes_to_bits(data_bytes))
        s = 2.0 * coded.float() - 1.0
        syms = torch.complex(s, torch.zeros_like(s))
        x = seq(self.up, _scaled(seq(self.shaper, syms), 0.6))
        return seq.states(), {"iq": x}


_DQPSK_INC = np.array([0, 3, 1, 2], np.int32)  # dibit value -> phase steps
# the rotation e^{-i 3 pi / 4} as the complex64 constant JAX makes of it
_ROT = np.complex64(np.exp(-3j * np.pi / 4))
_PI4 = float(np.float32(np.pi / 4))
_PI2 = float(np.float32(np.pi / 2))


class QpskDemod(Block):
    """DQPSK demod (QPSK2K/20K: 40 ksps target, sps 4; QPSK250K:
    QpskDemod(125_000, 500_000)). Input: an IqPair or complex (..., T) at
    1 Msps, T a multiple of the decimation. Outputs: `bits`,
    `constellation` (complex64), `rssi`."""
    SAMP_RATE = 1_000_000

    def __init__(self, symbol_rate: int = 10_000, target_rate: int = 40_000,
                 lead_shape: tuple = (), device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.sps = target_rate // symbol_rate
        decim = self.SAMP_RATE // target_rate
        self.resamp = RationalResampler(
            1, decim, taps=firdes.low_pass(1.0, self.SAMP_RATE,
                                           target_rate / 2, target_rate / 10,
                                           firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
        self.fll = FllBandEdge(self.sps, 0.35, 32, 2 * np.pi / 100,
                               lead_shape=ls, device=dev)
        self.shaping = FirFilter(
            firdes.root_raised_cosine(float(self.sps), float(self.sps), 1.0,
                                      0.35, 11 * self.sps + 1),
            lead_shape=ls, device=dev)
        self.agc = Agc2(1.0, 1e-1, reference=1.0, lead_shape=ls, device=dev)
        self.costas_pll = CostasLoop(np.pi / 200.0 / self.sps, order=4,
                                     lead_shape=ls, device=dev)
        self.symbol_sync = SymbolSync(self.sps,
                                      omega_limit=200.0 / symbol_rate,
                                      lead_shape=ls, device=dev)
        self.costas = CostasLoop(np.pi / 200.0, order=4, lead_shape=ls,
                                 device=dev)
        self.fec_tail = RxFecTail(lead_shape=ls, device=dev)
        self.lead_shape = ls
        self.blocks = [self.resamp, self.fll, self.shaping, self.agc,
                       self.costas_pll, self.symbol_sync, self.costas,
                       self.fec_tail]

    def init_state(self):
        prev = torch.ones(self.lead_shape + (1,), dtype=torch.complex64,
                          device=self.device)
        return init_states(self.blocks) + (prev,)

    def __call__(self, state, iq):
        *bs, prev_sym = state
        seq = Sequencer(bs)
        x = seq(self.resamp, as_iq_pair(iq))
        rssi = rssi_dbm(x)
        x = seq(self.fll, x)
        x = seq(self.shaping, x)
        x = seq(self.agc, x)
        x = seq(self.costas_pll, x)
        syms = seq(self.symbol_sync, x)
        syms = seq(self.costas, syms)
        soft, w, last = self.diff_soft(prev_sym, syms)
        bits = seq(self.fec_tail, soft)
        return seq.states() + (last,), {"bits": bits, "constellation": w,
                                        "rssi": rssi}

    @staticmethod
    def diff_soft(prev_sym, syms):
        """The differential decode: z = s[n] conj(s[n-1]), rotated by
        e^{-i3pi/4}, plane by plane as XLA's complex products; returns
        (interleaved soft x48+128 in [0, 255], the rotated points, the last
        symbol)."""
        sc = torch.cat([prev_sym, syms], dim=-1)
        ar, ai = sc.real[..., 1:], sc.imag[..., 1:]
        br, bi = sc.real[..., :-1], -sc.imag[..., :-1]
        zr = ar * br - ai * bi
        zi = ar * bi + ai * br
        cr, ci = float(_ROT.real), float(_ROT.imag)
        wr = zr * cr - zi * ci
        wi = zr * ci + zi * cr
        soft = torch.stack([wr, wi], dim=-1).reshape(
            tuple(wr.shape[:-1]) + (wr.shape[-1] * 2,))
        soft = torch.clamp(soft * 48.0 + 128.0, 0.0, 255.0)
        return soft, torch.complex(wr, wi), sc[..., -1:]


class QpskMod(Block):
    """DQPSK mod: bytes (..., N) -> {"iq": complex64 (..., 4 N sps up)}:
    Gray-mapped differential QPSK at 4 samples a symbol through an RRC,
    then up to 1 Msps (x2 at 125,000 symbols/s)."""
    SAMP_RATE = 1_000_000

    def __init__(self, symbol_rate: int = 10_000, lead_shape: tuple = (),
                 device=None):
        ls = tuple(lead_shape)
        dev = resolve_device(device)
        self.device = dev
        self.fec_head = TxFecHead(lead_shape=ls, device=dev)
        sps = 4
        self.sps = sps
        self.shaper = RationalResampler(
            sps, 1, taps=firdes.root_raised_cosine(float(sps), float(sps),
                                                   1.0, 0.35, 11 * sps + 1),
            lead_shape=ls, device=dev)
        self.up = RationalResampler(self.SAMP_RATE // (symbol_rate * sps), 1,
                                    lead_shape=ls, device=dev)
        self.lead_shape = ls
        self.inc = torch.from_numpy(_DQPSK_INC).to(dev)
        self.blocks = [self.fec_head, self.shaper, self.up]

    def init_state(self):
        return init_states(self.blocks) + (
            torch.zeros(self.lead_shape, dtype=torch.int32,
                        device=self.device),)

    def __call__(self, state, data_bytes):
        *bs, q0 = state
        seq = Sequencer(bs)
        coded = seq(self.fec_head, bytes_to_bits(data_bytes))
        inc = self.inc[pack_dibits(coded).long()]
        q = torch.remainder(q0[..., None] + torch.cumsum(inc, dim=-1,
                                                         dtype=torch.int32),
                            4)
        ph = _PI4 + q.float() * _PI2
        syms = torch.complex(torch.cos(ph), torch.sin(ph))
        x = seq(self.up, _scaled(seq(self.shaper, syms), 0.6))
        return seq.states() + (q[..., -1],), {"iq": x}
