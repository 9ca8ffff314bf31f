"""Complex rotator / frequency translator (port of
qradiolink_tpu/ops/rotator.py).

Equivalent of gr::blocks::rotator_cc used for carrier-offset correction at
the head of a chain (reference src/gr/gr_demod_base.cpp:1220-1224 sets the
phase increment 2*pi*(-offset)/samp_rate). State: the carried phase, f32.
The in-block ramp is computed in f32 from a coarse step pre-wrapped in
double on the host, and the block's advance is wrapped in double on the
host too, so the phase stays accurate over long streams.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.analog import wrap_phase

_COARSE = 4096  # samples a coarse ramp step


class Rotator(Block):
    """y[n] = x[n] * exp(j*(phase0 + n*phase_inc)); carries phase mod 2 pi.
    Input: an IqPair (output an IqPair) or a complex tensor."""

    def __init__(self, phase_inc: float, lead_shape: tuple = (),
                 device=None):
        self.phase_inc = float(phase_inc)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    @classmethod
    def from_offset(cls, offset_hz: float, samp_rate: float, **kw):
        return cls(2.0 * np.pi * (-offset_hz) / samp_rate, **kw)

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        t = x.shape[-1]
        inc = self.phase_inc
        # n*inc as q*(4096*inc mod 2 pi) + r*inc, the coarse step wrapped in
        # double on the host, so f32 stays accurate for long blocks
        n = torch.arange(t, dtype=torch.int32, device=state.device)
        q = torch.div(n, _COARSE, rounding_mode="floor").float()
        r = (n % _COARSE).float()
        coarse = (_COARSE * inc) % (2.0 * np.pi)
        ramp = wrap_phase(q * coarse + r * inc)
        ph = state[..., None] + ramp
        block_adv = np.float32((t * inc) % (2.0 * np.pi))
        new_phase = wrap_phase(state + float(block_adv))
        c, s = torch.cos(ph), torch.sin(ph)
        pair = x if isinstance(x, IqPair) else IqPair(x.real, x.imag)
        y = IqPair(pair.re * c - pair.im * s, pair.re * s + pair.im * c)
        return new_phase, y if isinstance(x, IqPair) else y.to_complex()
