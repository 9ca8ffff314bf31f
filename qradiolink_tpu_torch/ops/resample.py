"""Polyphase rational resampler, streaming (port of
qradiolink_tpu/ops/resample.py).

Math: y[m] = sum_k h[p_m + L*k] * x[floor(m*M/L) - k],  p_m = (m*M) mod L.
Grouping outputs by residue r = m mod L gives per-phase strided FIRs:
  y[r::L][t] = sum_k h_r[k] * x[t*M + q_r - k],  q_r = floor(r*M/L),
with h_r = h[p_r::L]. Streaming requires block length T % M == 0; then each
block yields T*L/M outputs and the phase pattern repeats exactly.

At L > 1 every call (real, complex or IqPair input) is one launch a tap
plane (two for complex taps) of the kernel `ops/cuda_resample.route()`
picks, which computes all L phases, interleaves them and writes the new
state, reading the tail in place from the state: `resample_up_f32` at
L >= 3 and M <= 5 (the TX side's 125/1, 20/1, 25/4, 5/1 and 125/3),
`resample_rat_f32` at L >= 24 and the (M, K) it has an instance for
(MMDVM's TX 125/12, MMDVMmulti's 25/24 and 24/25, DSSS's TX 50/13),
`resample_dec_f32` at the decimating L >= 2, M >= 25 shapes it has an
instance for (DMR's and M17's 3/125 heads, MMDVM's RX 12/125, the 2/25
heads), `resample_poly_f32` elsewhere (the NBFM audio resampler, 2/5, and
the interpolators' calls of one row at L <= 6). At L = 1 the decimator is one launch a tap plane of the
strided FIR kernel that `ops/cuda_fir.route()` picks, over the planes of
an IqPair, a complex tensor or a real one (the WBFM audio resampler,
1/25), with the tails read in place from the state: the
concatenation [tail | x] is never built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.cuda_resample import (phase_offsets,
                                                    resample_poly)
from qradiolink_tpu_torch.ops.fir import (combine_tap_planes, fir_planes,
                                          flipped_taps, next_tail)


# design_resampler_taps and kaiser_low_pass: copied verbatim (pure numpy)
# from qradiolink_tpu/ops/resample.py:29-63, so the default taps are the
# same floats in both packages.
def design_resampler_taps(interpolation: int, decimation: int,
                          fractional_bw: float = 0.4) -> np.ndarray:
    """Default anti-alias/anti-image filter for L/M resampling.

    Kaiser(beta=7) low-pass at the tighter of the input/output Nyquist,
    mirroring the rational_resampler default design semantics.
    """
    if not 0 < fractional_bw < 0.5:
        raise ValueError("fractional_bw must be in (0, 0.5)")
    beta = 7.0
    halfband = 0.5
    rate = interpolation / decimation
    if rate >= 1.0:
        trans_width = halfband - fractional_bw
        mid = halfband - trans_width / 2.0
    else:
        trans_width = rate * (halfband - fractional_bw)
        mid = rate * halfband - trans_width / 2.0
    return kaiser_low_pass(interpolation, interpolation, mid, trans_width, beta)


def kaiser_low_pass(gain: float, samp_rate: float, cutoff: float,
                    transition_width: float, beta: float = 7.0) -> np.ndarray:
    """Windowed-sinc low-pass with a Kaiser window."""
    att = beta / 0.1102 + 8.7  # invert beta = 0.1102 (att - 8.7)
    df = transition_width / samp_rate
    ntaps = int((att - 7.95) / (2.285 * 2 * np.pi * df)) + 1
    ntaps |= 1
    m = (ntaps - 1) / 2.0
    n = np.arange(ntaps, dtype=np.float64)
    w = np.i0(beta * np.sqrt(np.clip(1.0 - ((n - m) / m) ** 2, 0.0, 1.0))) / np.i0(beta)
    fc = cutoff / samp_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * (n - m)) * w
    h *= gain / np.sum(h)
    return h.astype(np.float32)


class RationalResampler(Block):
    """Streaming polyphase L/M resampler.

    State: (..., 2, Kp-1) f32, the last Kp-1 input samples as (re, im)
    planes (Kp = per-phase tap count). Each block length T must satisfy
    T % M == 0. taps=None designs the default Kaiser low-pass
    (design_resampler_taps). Complex taps run the same kernels once a tap
    plane (the real part, the imaginary part), each over every input
    plane, and combine the runs as a complex product (combine_tap_planes);
    their output is complex for real input.
    """

    def __init__(self, interpolation: int, decimation: int, taps=None,
                 fractional_bw: float = 0.4, lead_shape: tuple = (),
                 device=None):
        g = math.gcd(int(interpolation), int(decimation))
        self.L = int(interpolation) // g
        self.M = int(decimation) // g
        self.device = resolve_device(device)
        if taps is None:
            taps = design_resampler_taps(self.L, self.M, fractional_bw)
        taps = np.asarray(taps)
        # pad taps to a multiple of L and split into L phases
        kp = -(-taps.shape[0] // self.L)
        padded = np.zeros(kp * self.L, dtype=taps.dtype)
        padded[: taps.shape[0]] = taps
        self.kp = kp
        self.lead_shape = tuple(lead_shape)
        # phase-r taps h[p_r::L] with p_r = (r*M) mod L, flipped, as the
        # rows of one (L, kp) tensor a tap plane (the real part, and the
        # imaginary part of complex taps); offsets q_r = floor(r*M/L)
        parts = (padded.real, padded.imag) if np.iscomplexobj(taps) \
            else (padded,)
        self.poly_tap_planes = tuple(torch.stack([
            flipped_taps(part[(r * self.M) % self.L::self.L], self.device)
            for r in range(self.L)]) for part in parts)
        self.poly_taps = self.poly_tap_planes[0]
        self.phase_taps = list(self.poly_taps.unbind(0))
        self.offsets = phase_offsets(self.L, self.M)

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.kp - 1),
                           dtype=torch.float32, device=self.device)

    def _decimate(self, planes, tails):
        """L = 1: one launch over the planes a tap plane, the tails read in
        place from the state; the new state's im plane is zero for one
        plane."""
        T = planes[0].shape[-1]
        k1 = self.kp - 1
        ys = fir_planes(planes, [p[0] for p in self.poly_tap_planes],
                        self.M, T // self.M, tails=tails)
        new = [next_tail(t, p, k1) for t, p in zip(tails, planes)]
        if len(new) == 1:
            new.append(torch.zeros_like(new[0]))
        return torch.stack(new, dim=-2), ys

    def __call__(self, state, x):
        """One block of an IqPair, a complex tensor or a real one; the
        output is of the input's kind (complex for real input and complex
        taps)."""
        T = x.shape[-1]
        if T % self.M != 0:
            raise ValueError(
                f"block length {T} not a multiple of decimation {self.M}")
        tails = (state[..., 0, :], state[..., 1, :])
        if isinstance(x, IqPair):
            planes = (x.re, x.im)
        elif torch.is_complex(x):
            planes = (x.real.contiguous(), x.imag.contiguous())
        else:
            planes = (x.contiguous(),)
            tails = tails[:1]
        if self.L > 1:
            # every phase and the new state in one launch of the routed
            # kernel a tap plane
            runs = [resample_poly(planes, taps, self.L, self.M, tails)
                    for taps in self.poly_tap_planes]
            new_state = runs[0][0]
            ys = combine_tap_planes([ys for _, ys in runs])
        else:
            new_state, ys = self._decimate(planes, tails)
        if isinstance(x, IqPair):
            return new_state, IqPair(*ys)
        return new_state, torch.complex(*ys) if len(ys) == 2 else ys[0]
