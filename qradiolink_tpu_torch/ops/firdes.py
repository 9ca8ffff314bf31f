# Verbatim copy of qradiolink_tpu/ops/firdes.py (numpy only), kept here so
# that qradiolink_tpu_torch imports nothing of the JAX package. The taps it
# designs are pinned identical to the original by tests/test_torch_fir.py.
"""FIR tap design — the framework's equivalent of gr::filter::firdes.

The reference designs every channel/audio filter with firdes windowed-sinc
methods (e.g. reference src/gr/gr_demod_nbfm.cpp:47-55 uses
firdes::low_pass with Blackman-Harris windows; RRC shaping in all digital
chains uses firdes::root_raised_cosine). This module re-derives the same
textbook designs from first principles with numpy at trace/design time; taps
are compile-time constants for the XLA programs.

Semantics mirrored from the firdes API surface:
  * number of taps derived from transition width and the window's stopband
    attenuation: ntaps = att / (22 * normalized_transition_width), forced odd
  * windowed ideal-response (sinc) prototypes, DC- (or center-) normalized
  * band_pass via cosine-modulated low-pass (gain-normalized at band center)
  * complex_band_pass via complex-rotated low-pass
  * root_raised_cosine closed form with singularity handling
"""

from __future__ import annotations

import numpy as np

# Window kinds and their design stopband attenuation in dB (standard values
# used for the ntaps heuristic).
WIN_HAMMING = "hamming"
WIN_HANN = "hann"
WIN_BLACKMAN = "blackman"
WIN_RECTANGULAR = "rectangular"
WIN_BLACKMAN_HARRIS = "blackman_harris"
WIN_BARTLETT = "bartlett"

_ATTENUATION_DB = {
    WIN_HAMMING: 53.0,
    WIN_HANN: 44.0,
    WIN_BLACKMAN: 74.0,
    WIN_RECTANGULAR: 21.0,
    WIN_BLACKMAN_HARRIS: 92.0,
    WIN_BARTLETT: 27.0,
}


def window(kind: str, ntaps: int) -> np.ndarray:
    """Symmetric window of length ntaps (float64)."""
    n = np.arange(ntaps, dtype=np.float64)
    m = ntaps - 1
    if kind == WIN_RECTANGULAR:
        return np.ones(ntaps)
    if kind == WIN_HAMMING:
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / m)
    if kind == WIN_HANN:
        return 0.5 - 0.5 * np.cos(2 * np.pi * n / m)
    if kind == WIN_BLACKMAN:
        return 0.42 - 0.5 * np.cos(2 * np.pi * n / m) + 0.08 * np.cos(4 * np.pi * n / m)
    if kind == WIN_BLACKMAN_HARRIS:
        # 4-term Blackman-Harris, -92 dB sidelobes.
        return (
            0.35875
            - 0.48829 * np.cos(2 * np.pi * n / m)
            + 0.14128 * np.cos(4 * np.pi * n / m)
            - 0.01168 * np.cos(6 * np.pi * n / m)
        )
    if kind == WIN_BARTLETT:
        return 1.0 - np.abs(2.0 * n / m - 1.0)
    raise ValueError(f"unknown window kind: {kind}")


def compute_ntaps(samp_rate: float, transition_width: float, win: str) -> int:
    """Tap count heuristic: attenuation / (22 * normalized transition width)."""
    att = _ATTENUATION_DB[win]
    ntaps = int(att / (22.0 * (transition_width / samp_rate)))
    if ntaps % 2 == 0:
        ntaps += 1
    return max(ntaps, 3)


def _sinc_lp(ntaps: int, fc_norm: float) -> np.ndarray:
    """Ideal low-pass impulse response, cutoff fc_norm in cycles/sample."""
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    return 2.0 * fc_norm * np.sinc(2.0 * fc_norm * n)


def low_pass(
    gain: float,
    samp_rate: float,
    cutoff: float,
    transition_width: float,
    win: str = WIN_HAMMING,
    ntaps: int | None = None,
) -> np.ndarray:
    """Windowed-sinc low-pass; DC gain normalized to `gain`."""
    if ntaps is None:
        ntaps = compute_ntaps(samp_rate, transition_width, win)
    w = window(win, ntaps)
    h = _sinc_lp(ntaps, cutoff / samp_rate) * w
    h *= gain / np.sum(h)
    return h.astype(np.float32)


def high_pass(
    gain: float,
    samp_rate: float,
    cutoff: float,
    transition_width: float,
    win: str = WIN_HAMMING,
    ntaps: int | None = None,
) -> np.ndarray:
    """Spectral inversion of a low-pass; Nyquist gain normalized."""
    if ntaps is None:
        ntaps = compute_ntaps(samp_rate, transition_width, win)
    w = window(win, ntaps)
    h = -_sinc_lp(ntaps, cutoff / samp_rate) * w
    m = (ntaps - 1) // 2
    h[m] += w[m]  # delta minus low-pass
    # normalize gain at Nyquist
    n = np.arange(ntaps) - m
    nyq = np.sum(h * np.cos(np.pi * n))
    h *= gain / nyq
    return h.astype(np.float32)


def band_pass(
    gain: float,
    samp_rate: float,
    low_cutoff: float,
    high_cutoff: float,
    transition_width: float,
    win: str = WIN_HAMMING,
    ntaps: int | None = None,
) -> np.ndarray:
    """Real band-pass: cosine-modulated low-pass, center-frequency normalized."""
    if ntaps is None:
        ntaps = compute_ntaps(samp_rate, transition_width, win)
    w = window(win, ntaps)
    bw2 = (high_cutoff - low_cutoff) / 2.0
    center = (high_cutoff + low_cutoff) / 2.0
    proto = _sinc_lp(ntaps, bw2 / samp_rate) * w
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    h = 2.0 * proto * np.cos(2.0 * np.pi * center / samp_rate * n)
    # normalize gain at band center
    g = np.sum(h * np.cos(2.0 * np.pi * center / samp_rate * n))
    h *= gain / g
    return h.astype(np.float32)


def complex_band_pass(
    gain: float,
    samp_rate: float,
    low_cutoff: float,
    high_cutoff: float,
    transition_width: float,
    win: str = WIN_HAMMING,
    ntaps: int | None = None,
) -> np.ndarray:
    """Complex (one-sided) band-pass: rotated low-pass prototype.

    Used by the SSB chains (reference src/gr/gr_demod_ssb.cpp:66-77 switches
    USB [200, fw] vs LSB [-fw, -200] filters).
    """
    if ntaps is None:
        ntaps = compute_ntaps(samp_rate, transition_width, win)
    lp = low_pass(gain, samp_rate, (high_cutoff - low_cutoff) / 2.0,
                  transition_width, win, ntaps).astype(np.float64)
    center = (high_cutoff + low_cutoff) / 2.0
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    h = lp * np.exp(2j * np.pi * center / samp_rate * n)
    return h.astype(np.complex64)


def root_raised_cosine(
    gain: float,
    samp_rate: float,
    symbol_rate: float,
    alpha: float,
    ntaps: int,
) -> np.ndarray:
    """Root-raised-cosine taps (closed form, singularities via limits).

    Every digital chain in the reference shapes with RRC (alpha 0.2-0.5,
    e.g. reference src/gr/gr_demod_qpsk.cpp RRC(0.35), gr_mod_m17.cpp
    RRC(0.5)). Normalized to DC gain sum(h) == gain, so using gain == sps
    as an interpolating pulse shaper yields ~unit-amplitude waveforms for
    unit symbols (the convention the chain scalings here assume).
    """
    ntaps |= 1  # force odd
    Ts = samp_rate / symbol_rate  # samples per symbol
    m = (ntaps - 1) // 2
    t = (np.arange(ntaps, dtype=np.float64) - m) / Ts
    h = np.zeros(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif alpha > 0 and abs(abs(4.0 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
            )
        else:
            num = np.sin(np.pi * ti * (1 - alpha)) + 4 * alpha * ti * np.cos(
                np.pi * ti * (1 + alpha)
            )
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            h[i] = num / den
    h *= gain / np.sum(h)
    return h.astype(np.float32)


def gaussian(gain: float, spb: float, bt: float, ntaps: int) -> np.ndarray:
    """Gaussian pulse taps for GMSK shaping (spb samples/symbol, BT product)."""
    ntaps |= 1
    m = (ntaps - 1) // 2
    t = (np.arange(ntaps, dtype=np.float64) - m) / spb
    # Standard Gaussian filter for GMSK: h(t) ~ exp(-2 pi^2 BT^2 t^2 / ln 2)
    a = np.sqrt(2.0 * np.pi / np.log(2.0)) * bt
    h = a * np.exp(-2.0 * (np.pi**2) * (bt**2) * (t**2) / np.log(2.0))
    h *= gain / np.sum(h)
    return h.astype(np.float32)
