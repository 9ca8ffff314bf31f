"""Quadrature (FM) demodulator (port of QuadratureDemod in
qradiolink_tpu/ops/analog.py)."""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device


class QuadratureDemod(Block):
    """y[n] = gain * arg(x[n] * conj(x[n-1])). State: the previous sample as
    f32 (re, im) planes, (..., 2, 1). Accepts complex or IqPair input; the
    IqPair path is real arithmetic only."""

    def __init__(self, gain: float, lead_shape: tuple = (), device=None):
        self.gain = float(gain)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        re = torch.ones(self.lead_shape + (1,), dtype=torch.float32,
                        device=self.device)
        return torch.stack([re, torch.zeros_like(re)], dim=-2)

    @staticmethod
    def _angle(p, q, gain):
        # guard exact-zero (squelched) samples: atan2(0, -0.0) == pi. The
        # reference computes p*p + q*q > 0 with denormals flushed to zero
        # (XLA on the CPU, and the TPU), so a square below the smallest
        # normal f32 counts as zero there; PyTorch keeps denormals on the
        # CPU and on the card, hence the explicit threshold.
        tiny = torch.finfo(torch.float32).tiny
        nz = (p * p >= tiny) | (q * q >= tiny)
        ang = torch.atan2(torch.where(nz, q, 0.0), torch.where(nz, p, 1.0))
        return gain * torch.where(nz, ang, 0.0)

    def __call__(self, state, x):
        if isinstance(x, IqPair):
            re = torch.cat([state[..., 0, :], x.re], dim=-1)
            im = torch.cat([state[..., 1, :], x.im], dim=-1)
            # d = x[n] * conj(x[n-1])
            p = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
            q = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
            y = self._angle(p, q, self.gain)
            new_state = torch.stack([re[..., -1:], im[..., -1:]], dim=-2)
            return new_state, y
        prev = torch.complex(state[..., 0, :], state[..., 1, :])
        xc = torch.cat([prev, x], dim=-1)
        d = xc[..., 1:] * torch.conj(xc[..., :-1])
        y = self._angle(d.real, d.imag, self.gain)
        last = xc[..., -1:]
        return torch.stack([last.real, last.imag], dim=-2), y
