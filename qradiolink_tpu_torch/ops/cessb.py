"""Controlled-envelope SSB (CESSB) clipper and overshoot stretcher (port of
qradiolink_tpu/ops/cessb.py).

Equivalents of the reference's vendored cessb blocks (reference
src/gr/cessb/clipper_cc_impl.cc:43-95, a magnitude clip at 0.95 that keeps
the phase; stretcher_cc_impl.cc:43-110, the envelope's max over a 5-sample
window driving a gain normalisation). Both take complex64 input and scale
its planes by a real factor, plane by plane, which is how the reference's
complex-by-real product rounds.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, Stateless, resolve_device


def _scale_planes(x, k):
    return torch.complex(x.real * k, x.imag * k)


class CessbClipper(Stateless):
    """Clip |x| to `limit`, preserving phase."""

    def __init__(self, limit: float = 0.95):
        self.limit = float(limit)

    def apply(self, x):
        mag = torch.abs(x)
        scale = torch.where(mag > self.limit, self.limit / (mag + 1e-20),
                            1.0)
        return _scale_planes(x, scale)


class CessbStretcher(Block):
    """Divide by the reference's overshoot-stretch gain, computed from the
    max envelope over a centred 5-sample window.

    Reference law (stretcher_cc_impl.cc:79-96, kept op for op):
        env  = max(|x[j-2..j+2]|)
        e    = max(env * emax, 1),   emax = 1 / (sqrt(0.5) / 2)
        out  = x[j] / ((e - 1) * 2 + 1)
    The reference reads 2 samples of lookahead; this streaming block emits
    the same values delayed 2 samples. State: the last window-1 input
    samples, complex64 (..., window-1), as in the JAX package.
    """

    EMAX = 1.0 / (0.5 ** 0.5 / 2.0)

    def __init__(self, window: int = 5, lead_shape: tuple = (),
                 device=None):
        self.window = int(window)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.zeros(self.lead_shape + (self.window - 1,),
                           dtype=torch.complex64, device=self.device)

    def __call__(self, state, x):
        xc = torch.cat([state, x], dim=-1)
        mag = torch.abs(xc)
        T = x.shape[-1]
        env = mag[..., :T]
        for i in range(1, self.window):
            env = torch.maximum(env, mag[..., i:i + T])
        e = torch.clamp_min(env * self.EMAX, 1.0)
        divisor = (e - 1.0) * 2.0 + 1.0
        # delay x by (window-1)//2 to centre the window
        d = (self.window - 1) // 2
        xd = xc[..., self.window - 1 - d: self.window - 1 - d + T]
        y = torch.complex(xd.real / divisor, xd.imag / divisor)
        return xc[..., xc.shape[-1] - (self.window - 1):], y
