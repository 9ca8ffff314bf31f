"""Costas loop carrier recovery, orders 2 (BPSK) and 4 (QPSK) (port of
qradiolink_tpu/sync/costas.py; gr::digital::costas_loop_cc, as the
reference's PSK chains use it: src/gr/gr_demod_bpsk.cpp Costas(2pi/200,
2), gr_demod_qpsk.cpp Costas(pi/200 .. pi/400, 4)).

A second-order loop with critically damped gains from the loop bandwidth;
phase and frequency carried across blocks. The loop is sequential: on
CUDA it is one launch of `costas_loop_f32` (sync/cuda_costas.py), one
thread a row; on the CPU its plain per-sample loop.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.sync.cuda_costas import costas_loop


def loop_gains(loop_bw: float, damping: float = np.sqrt(2.0) / 2.0):
    """Standard 2nd-order PLL gain mapping (alpha: phase, beta: freq)."""
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4.0 * damping * loop_bw) / denom
    beta = (4.0 * loop_bw * loop_bw) / denom
    return float(alpha), float(beta)


class CostasLoop(Block):
    """De-rotates complex x by the tracked carrier; output complex64.
    State: (phase, freq), lead_shape f32 each."""

    def __init__(self, loop_bw: float, order: int, max_freq: float = 1.0,
                 lead_shape: tuple = (), device=None):
        if order not in (2, 4):
            raise ValueError("order must be 2 (BPSK) or 4 (QPSK)")
        self.order = order
        self.alpha, self.beta = loop_gains(loop_bw)
        self.max_freq = float(max_freq)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        z = torch.zeros(self.lead_shape, dtype=torch.float32,
                        device=self.device)
        return (z, z.clone())  # phase, freq

    def __call__(self, state, x):
        phase, freq = state
        y, phase, freq = costas_loop(x.to(torch.complex64), phase, freq,
                                     self.order, self.alpha, self.beta,
                                     self.max_freq)
        return (phase, freq), y
