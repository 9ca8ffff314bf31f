"""Spectral probes: windowed FFT display tap and RSSI estimation (port of
qradiolink_tpu/ops/spectrum.py).

Equivalents of the reference's rx_fft_c/rx_fft_f (reference
src/gr/rx_fft.cpp:42-185: windowed FFT, center-shifted power spectrum) and
the rssi_block probe chain (reference src/gr/rssi_block.cpp:25-50:
mag^2 -> moving_average(2000) -> single-pole IIR(0.04) -> 10log10 + cal).
All plain PyTorch: reductions, torch.fft (cuFFT on the card) and the
first-order scan of ops/iir.py.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops import firdes
from qradiolink_tpu_torch.ops.iir import linear_recurrence


def _power(x) -> torch.Tensor:
    """|x|^2 of an IqPair, a complex tensor or a real one, f32."""
    if isinstance(x, IqPair):
        return x.re * x.re + x.im * x.im
    if torch.is_complex(x):
        return (x.real ** 2 + x.imag ** 2).float()
    return (x * x).float()


class SpectrumProbe:
    """Windowed, center-shifted power spectrum in dBFS over the last
    fft_size samples of a block (the GUI waterfall feed)."""

    def __init__(self, fft_size: int = 1024, win: str = firdes.WIN_HAMMING,
                 device=None):
        self.fft_size = int(fft_size)
        self.window = torch.from_numpy(firdes.window(
            win, self.fft_size).astype(np.float32)).to(
                resolve_device(device))

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, IqPair):
            x = x.to_complex()
        seg = x[..., -self.fft_size:] * self.window
        spec = torch.fft.fftshift(torch.fft.fft(seg, dim=-1), dim=-1)
        p = (spec.real ** 2 + spec.imag ** 2) / (self.fft_size ** 2)
        return 10.0 * torch.log10(p + 1e-20)


def rssi_dbm(x, cal_offset_db: float = 0.0) -> torch.Tensor:
    """Mean power of the block in dB(m), over the last axis. Accepts complex
    tensors or IqPair."""
    if isinstance(x, IqPair):
        p = torch.mean(x.re * x.re + x.im * x.im, dim=-1)
    else:
        p = torch.mean(x.real ** 2 + x.imag ** 2, dim=-1)
    return 10.0 * torch.log10(p + 1e-20) + cal_offset_db


def rssi_dbm_slots(x, slot_len: int = 720,
                   cal_offset_db: float = 0.0) -> torch.Tensor:
    """Per-burst RSSI: one dB value per slot_len-sample window (the
    reference's rssi_tag_block tags every 720-sample MMDVM burst,
    src/gr/rssi_tag_block.cpp). Trailing samples short of a full slot are
    dropped. Accepts complex tensors or IqPair. Returns
    (..., T // slot_len)."""
    if isinstance(x, IqPair):
        pw = x.re * x.re + x.im * x.im
    else:
        pw = x.real ** 2 + x.imag ** 2
    n = (pw.shape[-1] // slot_len) * slot_len
    w = pw[..., :n].reshape(tuple(pw.shape[:-1]) + (n // slot_len, slot_len))
    p = torch.mean(w, dim=-1)
    return 10.0 * torch.log10(p + 1e-20) + cal_offset_db


class RssiProbe(Block):
    """Streaming RSSI with the reference's per-sample semantics (reference
    src/gr/rssi_block.cpp:25-50): mag^2 -> moving SUM over 2000 samples
    (moving_average_ff(2000, scale=1), whose +33 dB gain the calibration
    offset absorbs) -> per-sample single-pole IIR(alpha=0.04) -> 10*log10
    -> + cal.

    The windowed sum is a cumsum difference over [carried 1999-sample
    history | block]; the IIR one first-order linear recurrence. Returns the
    per-sample dB stream. State: (power history (..., avg_len-1), IIR
    value (...)), f32."""

    def __init__(self, avg_len: int = 2000, alpha: float = 0.04,
                 cal_offset_db: float = 0.0, lead_shape: tuple = (),
                 device=None):
        self.avg_len = int(avg_len)
        self.alpha = float(alpha)
        self.cal = float(cal_offset_db)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return (torch.zeros(self.lead_shape + (self.avg_len - 1,),
                            dtype=torch.float32, device=self.device),
                torch.zeros(self.lead_shape, dtype=torch.float32,
                            device=self.device))

    def __call__(self, state, x):
        hist, y0 = state
        p = _power(x)
        T = p.shape[-1]
        L = self.avg_len
        pc = torch.cat([hist, p], dim=-1)  # (..., L-1+T)
        cs = torch.cumsum(pc, dim=-1)
        # ma[t] = sum of pc[t .. t+L-1] for t in [0, T)
        hi = cs[..., L - 1:]
        lo = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :T - 1]],
                       dim=-1)
        ma = hi - lo
        y = linear_recurrence(1.0 - self.alpha, self.alpha * ma, y0)
        db = 10.0 * torch.log10(y + 1e-20) + self.cal
        new_hist = pc[..., pc.shape[-1] - (L - 1):]
        return (new_hist, y[..., -1]), db
