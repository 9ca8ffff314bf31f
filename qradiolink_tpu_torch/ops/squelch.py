"""Squelch gates: power squelch and CTCSS tone squelch (port of
qradiolink_tpu/ops/squelch.py).

Power squelch mirrors gr::analog::pwr_squelch_cc (reference
src/gr/gr_demod_nbfm.cpp uses pwr_squelch(-140 dB, alpha 0.01, ramp 320)):
a single-pole IIR average of |x|^2 compared against a dB threshold, with an
envelope that follows the gate over about `ramp` samples. The average and
the envelope are linear recurrences (ops/iir.py); the gate is elementwise.

CTCSS squelch mirrors gr::analog::ctcss_squelch_ff: Goertzel energy at the
tone frequency vs. its +/- neighbors over a detection window.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.iir import linear_recurrence


class PowerSquelch(Block):
    """Gate x to zero while smoothed power is below threshold_db.

    State: (avg_power, env), the smoothed power and the envelope after the
    last sample. Input: an IqPair, a complex tensor or a real tensor.
    """

    def __init__(self, threshold_db: float, alpha: float = 0.0001,
                 ramp: int = 0, lead_shape: tuple = (), device=None):
        self.threshold = 10.0 ** (float(threshold_db) / 10.0)
        self.alpha = float(alpha)
        self.ramp = int(ramp)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        z = torch.zeros(self.lead_shape, dtype=torch.float32,
                        device=self.device)
        return (z, z.clone())  # avg power, previous envelope value

    def __call__(self, state, x):
        avg0, env_prev = state
        pair = isinstance(x, IqPair)
        if pair:
            p = x.re * x.re + x.im * x.im
        elif torch.is_complex(x):
            p = (x.real * x.real + x.imag * x.imag).float()
        else:
            p = (x * x).float()
        avg = linear_recurrence(1.0 - self.alpha, self.alpha * p, avg0)
        gate = (avg >= self.threshold).float()
        if self.ramp > 0:
            # envelope follows gate with a first-order lag ~ ramp samples,
            # approximating the reference's cosine ramp length
            beta = 1.0 / float(self.ramp)
            env = linear_recurrence(1.0 - beta, beta * gate, env_prev)
        else:
            env = gate
        if pair:
            y = IqPair(x.re * env, x.im * env)
        else:
            y = x * env
        return (avg[..., -1], env[..., -1]), y


def _goertzel_energy(x, freq, samp_rate):
    """Goertzel tone energy per window (x: (..., W))."""
    w = x.shape[-1]
    n = torch.arange(w, dtype=torch.float32, device=x.device)
    ph = 2.0 * np.pi * freq / samp_rate * n
    re = torch.sum(x * torch.cos(ph), dim=-1)
    im = torch.sum(x * torch.sin(ph), dim=-1)
    return re * re + im * im


class CtcssSquelch(Block):
    """Tone squelch: pass audio only when the CTCSS sub-audible tone is present.

    Processes in fixed windows of `window` samples (block length must be a
    multiple). Detection: tone bin energy must dominate both +/-10% off-tone
    bins and exceed `level` * window energy share. State: the last window's
    gate (the gate is held one window, so each window is gated by the
    detection of the one before it).
    """

    def __init__(self, samp_rate: float, freq_hz: float, level: float = 0.01,
                 window: int = 400, lead_shape: tuple = (), device=None):
        self.samp_rate = float(samp_rate)
        self.freq = float(freq_hz)
        self.level = float(level)
        self.window = int(window)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        T = x.shape[-1]
        if T % self.window != 0:
            raise ValueError(
                f"block length {T} not a multiple of window {self.window}")
        nwin = T // self.window
        xw = x.reshape(x.shape[:-1] + (nwin, self.window))
        e_tone = _goertzel_energy(xw, self.freq, self.samp_rate)
        e_lo = _goertzel_energy(xw, self.freq * 0.9, self.samp_rate)
        e_hi = _goertzel_energy(xw, self.freq * 1.1, self.samp_rate)
        e_tot = torch.sum(xw * xw, dim=-1) + 1e-12
        detected = ((e_tone > e_lo) & (e_tone > e_hi)
                    & (e_tone > self.level * e_tot * self.window / 2.0))
        gate = detected.float()
        # hold gate from previous window across the first window (latency 1 win)
        gate_held = torch.cat([state.unsqueeze(-1), gate[..., :-1]], dim=-1)
        y = (xw * gate_held.unsqueeze(-1)).reshape(x.shape)
        return gate[..., -1], y
