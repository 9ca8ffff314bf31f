"""4FSK feedforward RX chain (port of Fsk4DemodFF in
qradiolink_tpu/chains/fsk.py; reference chain: qradiolink's
src/gr/gr_demod_4fsk.cpp, sps=5 config).

resampler (1 Msps -> 20 ksps for 2KFM) -> channel low-pass -> quadrature
demod -> RRC -> feedforward symbol sync -> soft pairs -> tiled Viterbi +
descrambler. On CUDA the resampler head runs the `fir_decim_f32` kernel,
the channel low-pass and the RRC the `fir_s1_f32` kernel
(`ops/cuda_fir.route`), and the Viterbi the `viterbi_bfly_k7` kernel;
everything else is plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Sequencer, as_iq_pair,
                                       init_states, resolve_device)
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.analog import QuadratureDemod
from qradiolink_tpu_torch.ops.fir import FirFilter
from qradiolink_tpu_torch.ops.resample import RationalResampler
from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
from qradiolink_tpu_torch.sync.feedforward import FeedforwardSymbolSync
from qradiolink_tpu_torch.chains.digital_common import RxFecTailFF

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
        self.resamp = RationalResampler(
            L, M, taps=firdes.low_pass(float(L), L * self.SAMP_RATE,
                                       fs / 2, fs / 2,
                                       firdes.WIN_BLACKMAN_HARRIS),
            lead_shape=ls, device=dev)
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
        ph = float(np.pi / 2) * syms
        soft = torch.stack([torch.sin(ph), torch.cos(ph)], dim=-1)
        soft = soft.reshape(tuple(syms.shape[:-1]) + (syms.shape[-1] * 2,))
        soft = torch.clamp(soft * 128.0 + 128.0, 0.0, 255.0)
        const_tap = IqPair(torch.cos(ph), torch.sin(ph))
        bits = seq(self.fec_tail, soft)
        return seq.states(), {"bits": bits, "constellation": const_tap,
                              "rssi": rssi, "symbols": syms}
