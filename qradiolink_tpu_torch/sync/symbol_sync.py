"""Symbol timing recovery: Mueller & Mueller with 4-point cubic Lagrange
interpolation (port of qradiolink_tpu/sync/symbol_sync.py; the
gr::digital::symbol_sync_cc/ff and clock_recovery_mm_cc equivalent of the
reference's PSK, 4FSK and DMR chains).

The loop runs over OUTPUT symbols, T/sps iterations a block, carrying a
fractional read position, the clock estimate omega and the previous output
and decision for the TED. Each block of T input samples (T % sps == 0)
gives round(T / sps) symbols; a tail of the last samples gives the
interpolator its history and slack, and the clock is clamped to omega_limit
around nominal so the position's drift a block stays bounded.

On CUDA the loop is one launch of `symbol_sync_mm_f32`
(sync/cuda_symbol_sync.py), one thread a row, for every decision variant;
on the CPU its plain per-symbol loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.sync.cuda_symbol_sync import (MODE_LEVELS,
                                                        mode_of, symbol_sync)


class SymbolSync(Block):
    """M&M timing recovery emitting T/sps symbols per T-sample block.

    decisions:
      None     -> sign decisions, per rail for complex input (BPSK/QPSK)
      levels   -> the nearest of real levels (e.g. [-1.5, -0.5, 0.5, 1.5]
                  for 4FSK, [-1, 1] for the 2FSK/GMSK chains)

    gain_mu / gain_omega follow gr::digital::clock_recovery_mm (reference
    src/gr/gr_demod_bpsk.cpp:54-58); the defaults scale the reference's
    sps=10 values to sps. Output: complex64, except real f32 for real input
    with levels, as in the JAX block. State: (pos, omega) f32, (y_prev,
    d_prev) complex64, the tail (..., tail_len) complex64.
    """

    def __init__(self, sps: float, gain_mu: float | None = None,
                 gain_omega: float | None = None, decisions=None,
                 omega_limit: float = 0.005, lead_shape: tuple = (),
                 device=None):
        self.device = resolve_device(device)
        self.sps = float(sps)
        self.alpha = float(gain_mu) if gain_mu is not None \
            else 0.005 * self.sps
        self.beta = float(gain_omega) if gain_omega is not None \
            else 2.5e-6 * self.sps
        self.levels = None if decisions is None else torch.from_numpy(
            np.asarray(decisions, dtype=np.float32)).to(self.device)
        # TED slope normalization (the reference's ted_gain role)
        if decisions is None:
            self.ted_norm = 1.0
        else:
            lv = np.asarray(decisions, np.float64)
            self.ted_norm = float(np.mean(lv ** 2))
        self.omega_limit = float(omega_limit) * self.sps
        self.lead_shape = tuple(lead_shape)
        self.tail_len = 4 * int(np.ceil(self.sps)) + 16

    def init_state(self):
        ls, dev = self.lead_shape, self.device
        pos = torch.full(ls, float(self.tail_len) // 2, dtype=torch.float32,
                         device=dev)
        omega = torch.full(ls, self.sps, dtype=torch.float32, device=dev)
        zc = torch.zeros(ls, dtype=torch.complex64, device=dev)
        tail = torch.zeros(ls + (self.tail_len,), dtype=torch.complex64,
                           device=dev)
        return (pos, omega, zc, zc.clone(), tail)

    def __call__(self, state, x):
        pos0, omega0, y_prev0, d_prev0, tail = state
        complex_in = torch.is_complex(x)
        x = x.to(torch.complex64) if complex_in else x.float()
        lead = self.lead_shape
        T = x.shape[-1]
        n_out = int(round(T / self.sps))
        L = self.tail_len
        rows = math.prod(lead)
        mode = mode_of(complex_in, self.levels)
        y, pos, omega, y_prev, d_prev = symbol_sync(
            tail.reshape(rows, L), x.reshape(rows, T), pos0.reshape(rows),
            omega0.reshape(rows), y_prev0.reshape(rows),
            d_prev0.reshape(rows), n_out, mode, self.levels, self.sps,
            self.alpha, self.beta, self.omega_limit, self.ted_norm)
        # carry the last tail_len samples of [tail | x] and shift the
        # position by what was dropped: T samples
        pos_new = torch.clamp(pos - T, 0.0, float(L - 2))
        xt = x.reshape(rows, T)
        if T >= L:
            new_tail = xt[:, T - L:].to(torch.complex64)
        else:
            new_tail = torch.cat([tail.reshape(rows, L),
                                  xt.to(torch.complex64)], dim=-1)[:, T:]
        y = y.reshape(lead + (n_out,))
        if not complex_in and mode == MODE_LEVELS:
            y = y.real.contiguous()
        return (pos_new.reshape(lead), omega.reshape(lead),
                y_prev.reshape(lead), d_prev.reshape(lead),
                new_tail.contiguous().reshape(lead + (L,))), y
