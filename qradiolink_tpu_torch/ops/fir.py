"""Streaming FIR filters (port of qradiolink_tpu/ops/fir.py).

A FIR is a function on (tail_state, x): the carried state is the last
ntaps-1 input samples, so output is the same however the stream is split
into blocks.

Convention: y[n] = sum_k h[k] * x[n-k] with x[<0] from the carried tail
(zeros at stream start). Output length == input length / decim; output y[m]
aligns with input x[m*D].

Every FIR here is the direct form, on every device: on CUDA tensors the
kernel that `ops/cuda_fir.route()` picks for the shape, on CPU tensors its
plain version. The JAX package's FFT implementation (`FftFirFilter`, which its
`impl="auto"` picks on the CPU for long filters) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.cuda_fir import fir_stream


def flipped_taps(taps, device) -> torch.Tensor:
    """Real taps reversed, as the contiguous f32 tensor the kernel reads."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        raise ValueError("complex taps are not supported by the port yet")
    return torch.from_numpy(
        np.ascontiguousarray(taps[::-1], dtype=np.float32)).to(device)


def conv1d_valid(x: torch.Tensor, taps, stride: int = 1,
                 out_len: int | None = None) -> torch.Tensor:
    """VALID FIR: y[m] = sum_k taps[k] * x[m*stride + K-1 - k].

    x real f32 or complex64, taps real. out_len, if given, keeps only the
    first out_len outputs."""
    return conv1d_valid_flipped(x, flipped_taps(taps, x.device), stride,
                                out_len)


def conv1d_valid_flipped(x, taps_flipped, stride, out_len=None):
    """conv1d_valid with the taps already flipped on x's device (the form
    the blocks keep), through the kernel's K2 form: no tail."""
    n_full = (x.shape[-1] - taps_flipped.shape[0]) // stride + 1
    n_out = n_full if out_len is None else int(out_len)
    if n_out > n_full:
        raise ValueError(f"out_len {n_out} exceeds available {n_full}")
    if torch.is_complex(x):
        yr, yi = fir_stream((x.real.contiguous(), x.imag.contiguous()),
                            taps_flipped, stride, n_out)
        return torch.complex(yr, yi)
    return fir_stream((x.contiguous(),), taps_flipped, stride, n_out)[0]


def next_tail(tail: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """The last n samples of [tail | x], without the concatenation when x
    alone is long enough."""
    if n == 0:
        return x[..., :0]
    if x.shape[-1] >= n:
        return x[..., x.shape[-1] - n:]
    return torch.cat([tail, x], dim=-1)[..., -n:]


class FirFilter(Block):
    """Streaming FIR with carried input tail; optional decimation.

    State: (..., 2, K-1) f32, the (re, im) planes of the last K-1 inputs
    (im is zero for real input), as in the JAX package."""

    def __init__(self, taps, decim: int = 1, lead_shape: tuple = (),
                 device=None):
        taps = np.asarray(taps)
        self.device = resolve_device(device)
        self.taps_flipped = flipped_taps(taps, self.device)
        self.ntaps = int(taps.shape[0])
        self.decim = int(decim)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.ntaps - 1),
                           dtype=torch.float32, device=self.device)

    def _call_pair(self, state, x: IqPair):
        """IqPair path: both planes in one launch of the streaming kernel,
        reading the tails straight from the state (no concatenation)."""
        T = x.shape[-1]
        if T % self.decim != 0:
            raise ValueError(
                f"block length {T} not a multiple of decimation {self.decim}")
        k1 = self.ntaps - 1
        tails = (state[..., 0, :], state[..., 1, :])
        yr, yi = fir_stream((x.re, x.im), self.taps_flipped, self.decim,
                            T // self.decim, tails=tails)
        new_state = torch.stack([next_tail(tails[0], x.re, k1),
                                 next_tail(tails[1], x.im, k1)], dim=-2)
        return new_state, IqPair(yr, yi)

    def _call_real(self, state, x):
        """Real f32 input at stride 1: one launch that reads the tail
        straight from the state, as the IqPair path does; the new state
        has a zero im plane."""
        k1 = self.ntaps - 1
        tail = state[..., 0, :]
        x = x.contiguous()
        (y,) = fir_stream((x,), self.taps_flipped, 1, x.shape[-1],
                          tails=(tail,))
        new_tail = next_tail(tail, x, k1)
        return torch.stack([new_tail, torch.zeros_like(new_tail)],
                           dim=-2), y

    def __call__(self, state, x):
        if isinstance(x, IqPair):
            return self._call_pair(state, x)
        if x.dtype == torch.float32 and self.decim == 1:
            return self._call_real(state, x)
        k1 = self.ntaps - 1
        if torch.is_complex(x):
            tail_x = torch.complex(state[..., 0, :], state[..., 1, :])
        else:
            tail_x = state[..., 0, :].to(x.dtype)
        xc = torch.cat([tail_x, x], dim=-1)
        n_out = (xc.shape[-1] - self.ntaps) // self.decim + 1
        y = conv1d_valid_flipped(xc, self.taps_flipped, self.decim,
                                 out_len=n_out)
        new_tail = xc[..., xc.shape[-1] - k1:]
        if torch.is_complex(new_tail):
            new_state = torch.stack([new_tail.real, new_tail.imag], dim=-2)
        else:
            new_tail = new_tail.float()
            new_state = torch.stack([new_tail, torch.zeros_like(new_tail)],
                                    dim=-2)
        return new_state, y
