"""Channel simulator for loopback tests (port of
qradiolink_tpu/chains/channel.py).

Applies gain, an integer sample delay, a carrier frequency and phase offset
and AWGN at a given SNR to complex IQ (a complex tensor or an IqPair). The
noise comes from a torch.Generator seeded from `seed`, on the signal's
device: it is not the JAX package's jax.random stream, so the two agree in
distribution (the SNR), not in bits.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import IqPair


class ChannelModel:
    def __init__(self, samp_rate: float, snr_db: float | None = None,
                 freq_offset_hz: float = 0.0, phase_offset: float = 0.0,
                 gain: float = 1.0, delay_samples: int = 0, seed: int = 1234):
        self.samp_rate = float(samp_rate)
        self.snr_db = snr_db
        self.freq_offset = float(freq_offset_hz)
        self.phase_offset = float(phase_offset)
        self.gain = float(gain)
        self.delay = int(delay_samples)
        self.seed = int(seed)
        self._gens = {}

    def _generator(self, device) -> torch.Generator:
        """One generator a device, seeded from `seed` at first use; later
        calls continue its stream."""
        key = str(device)
        if key not in self._gens:
            g = torch.Generator(device=device)
            g.manual_seed(self.seed)
            self._gens[key] = g
        return self._gens[key]

    def __call__(self, x):
        pair = isinstance(x, IqPair)
        y = x.to_complex() if pair else x
        y = y * self.gain
        if self.delay:
            y = torch.cat([torch.zeros(y.shape[:-1] + (self.delay,),
                                       dtype=y.dtype, device=y.device),
                           y[..., :-self.delay]], dim=-1)
        if self.freq_offset or self.phase_offset:
            t = torch.arange(y.shape[-1], dtype=torch.float32,
                             device=y.device)
            ph = (2 * np.pi * self.freq_offset / self.samp_rate) * t \
                + self.phase_offset
            c, s = torch.cos(ph), torch.sin(ph)
            if not torch.is_complex(y):
                y = torch.complex(y, torch.zeros_like(y))
            y = torch.complex(y.real * c - y.imag * s,
                              y.real * s + y.imag * c)
        if self.snr_db is not None:
            sig_pow = torch.mean(torch.abs(y) ** 2)
            noise_pow = sig_pow / (10.0 ** (self.snr_db / 10.0))
            gen = self._generator(y.device)
            n = torch.randn(y.shape, generator=gen, device=y.device,
                            dtype=torch.complex64 if torch.is_complex(y)
                            else torch.float32)
            # a complex normal has unit total variance, half a plane
            y = y + n * torch.sqrt(noise_pow)
        return IqPair(y.real.contiguous(), y.imag.contiguous()) if pair \
            else y
