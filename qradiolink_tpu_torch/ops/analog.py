"""Analog blocks (port of qradiolink_tpu/ops/analog.py): the quadrature
(FM) demodulator, the frequency and phase modulators, FM pre-/de-emphasis,
the DC blocker, and magnitude, real-part and scale extraction. All plain
PyTorch: elementwise ops, a cumulative sum, and the first-order IIR scan
of ops/iir.py."""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import (Block, IqPair, Stateless,
                                       resolve_device)
from qradiolink_tpu_torch.ops.iir import FirstOrderIir


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


def wrap_phase(ph):
    """ph mod 2 pi in [0, 2 pi), in f32, as jnp.mod computes it."""
    return torch.remainder(ph, 2.0 * np.pi)


class FrequencyMod(Block):
    """y[n] = exp(j * phase[n]), phase = carried phase + sensitivity *
    cumsum(x). State: the carried phase mod 2 pi, lead_shape f32.
    pair_out=True emits IqPair(cos, sin) instead of complex64."""

    def __init__(self, sensitivity: float, lead_shape: tuple = (),
                 pair_out: bool = False, device=None):
        self.sensitivity = float(sensitivity)
        self.lead_shape = tuple(lead_shape)
        self.pair_out = bool(pair_out)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        ph = state[..., None] + torch.cumsum(
            x.float() * self.sensitivity, dim=-1)
        new_phase = wrap_phase(ph[..., -1])
        y = IqPair(torch.cos(ph), torch.sin(ph))
        return new_phase, y if self.pair_out else y.to_complex()


class PhaseMod(Stateless):
    """y[n] = exp(j * sensitivity * x[n]) (gr::analog::phase_modulator)."""

    def __init__(self, sensitivity: float):
        self.sensitivity = float(sensitivity)

    def apply(self, x):
        ph = (x * self.sensitivity).float()
        return torch.complex(torch.cos(ph), torch.sin(ph))


class ComplexToMag(Stateless):
    """|x| (or |x|^2 with squared=True) of a complex tensor or IqPair, as
    re*re + im*im. The reference flushes a denormal sum to zero (XLA on the
    CPU and the TPU); PyTorch keeps it, hence the explicit threshold, as
    in QuadratureDemod."""

    def __init__(self, squared: bool = False):
        self.squared = squared

    def apply(self, x):
        p = x.real * x.real + x.imag * x.imag
        p = torch.where(p < torch.finfo(torch.float32).tiny, 0.0, p)
        return p if self.squared else torch.sqrt(p)


class ComplexToReal(Stateless):
    def apply(self, x):
        return x.real


class Scale(Stateless):
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return x * self.k


# fm_deemph_taps and fm_preemph_taps: copied verbatim (pure numpy) from
# qradiolink_tpu/ops/analog.py:124-155.
def fm_deemph_taps(samp_rate: float, tau: float = 50e-6):
    """Single-pole de-emphasis via bilinear transform: returns (b, a1).

    H(s) = 1/(1 + s*tau)  ->  y[n] = a1*y[n-1] + b0*x[n] + b1*x[n-1].
    """
    w_c = 1.0 / tau
    w_ca = 2.0 * samp_rate * np.tan(w_c / (2.0 * samp_rate))
    k = -w_ca / (2.0 * samp_rate)
    z1 = -1.0
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    return np.array([b0, b0 * -z1]), p1


def fm_preemph_taps(samp_rate: float, tau: float = 50e-6, fh: float = -1.0):
    """Pre-emphasis: high-shelf inverse of the de-emphasis pole, corner-limited.

    Returns (b, a1) for y[n] = a1*y[n-1] + b0*x[n] + b1*x[n-1].
    """
    if fh <= 0.0 or fh >= samp_rate / 2.0:
        fh = 0.925 * samp_rate / 2.0
    ca = 2.0 * samp_rate * np.tan(np.pi * fh / samp_rate)  # upper corner (rad/s)
    cz = 1.0 / tau  # zero at the emphasis corner
    # bilinear transform of H(s) = (1 + s/cz) / (1 + s/ca)
    k_z = 2.0 * samp_rate / cz
    k_p = 2.0 * samp_rate / ca
    b = np.array([1.0 + k_z, 1.0 - k_z]) / (1.0 + k_p)
    a1 = -(1.0 - k_p) / (1.0 + k_p)
    return b, a1


class Emphasis(Block):
    """FM pre-/de-emphasis as a 1-pole 1-zero IIR (parallel first-order
    scan). State: that of FirstOrderIir, (x[-1], y[-1])."""

    def __init__(self, samp_rate: float, tau: float = 50e-6, mode: str = "de",
                 lead_shape: tuple = (), device=None):
        if mode == "de":
            b, a1 = fm_deemph_taps(samp_rate, tau)
        else:
            b, a1 = fm_preemph_taps(samp_rate, tau)
        self.iir = FirstOrderIir(b0=b[0], b1=b[1], a1=a1,
                                 lead_shape=lead_shape, device=device)

    def init_state(self):
        return self.iir.init_state()

    def __call__(self, state, x):
        return self.iir(state, x)


class DcBlocker(Block):
    """y[n] = x[n] - x[n-1] + p*y[n-1], the AM chain's IIR [1,-1]/[1,-p]."""

    def __init__(self, pole: float = 0.9999, lead_shape: tuple = (),
                 device=None):
        self.iir = FirstOrderIir(b0=1.0, b1=-1.0, a1=pole,
                                 lead_shape=lead_shape, device=device)

    def init_state(self):
        return self.iir.init_state()

    def __call__(self, state, x):
        return self.iir(state, x)
