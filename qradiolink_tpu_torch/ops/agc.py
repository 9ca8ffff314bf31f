"""AGC with attack/decay rates (port of qradiolink_tpu/ops/agc.py, the
gr::analog::agc2_cc/ff equivalent).

The reference inserts agc2 in the SSB and AM chains (reference
src/gr/gr_demod_ssb.cpp AGC2(1e-1, 1e-1, 0.25)). The gain recurrence
    g[n+1] = clamp(g[n] + rate * (reference - |x[n]| * g[n]), 1e-6, max)
is data-dependent (the attack rate while the envelope is above the
reference, the decay rate below). On CUDA the stage (|x|, the recurrence
and y = x g) is one launch of `agc2_f32` (ops/cuda_agc.py); on the CPU its
plain version, torch.abs, the per-sample loop and the products.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.cuda_agc import agc2


class Agc2(Block):
    """y[n] = x[n] * g[n]; g updated a sample at a time with attack/decay
    rates. Input: real f32, complex64 or an IqPair, which becomes complex64
    as in the JAX package (the stages after the SSB chain's AGC take
    complex). State: the gain after the last sample, lead_shape f32."""

    def __init__(self, attack_rate: float = 1e-1, decay_rate: float = 1e-2,
                 reference: float = 1.0, gain: float = 1.0,
                 max_gain: float = 65536.0, lead_shape: tuple = (),
                 device=None):
        self.attack = float(attack_rate)
        self.decay = float(decay_rate)
        self.reference = float(reference)
        self.gain0 = float(gain)
        self.max_gain = float(max_gain)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.full(self.lead_shape, self.gain0, dtype=torch.float32,
                          device=self.device)

    def __call__(self, state, x):
        if isinstance(x, IqPair):
            x = x.to_complex()
        y, g_last = agc2(x, state, self.attack, self.decay, self.reference,
                         self.max_gain)
        return g_last, y
