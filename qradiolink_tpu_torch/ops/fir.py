"""Streaming FIR filters (port of qradiolink_tpu/ops/fir.py).

A FIR is a function on (tail_state, x): the carried state is the last
ntaps-1 input samples, so output is the same however the stream is split
into blocks.

Convention: y[n] = sum_k h[k] * x[n-k] with x[<0] from the carried tail
(zeros at stream start). Output length == input length / decim; output y[m]
aligns with input x[m*D].

Every FIR here is the direct form, on every device: on CUDA tensors the
kernel that `ops/cuda_fir.route()` picks for the shape, on CPU tensors its
plain version; complex taps are two launches, one a tap plane, as the JAX
package's IqPair path computes them. The JAX package's FFT implementation
(`FftFirFilter`, which its `impl="auto"` picks on the CPU for long filters)
is not ported yet.
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
        raise ValueError("complex taps: use flipped_tap_planes")
    return torch.from_numpy(
        np.ascontiguousarray(taps[::-1], dtype=np.float32)).to(device)


def flipped_tap_planes(taps, device) -> tuple:
    """Taps reversed as f32 tensors: (real,) for real taps, (real part,
    imaginary part) for complex ones."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        return (flipped_taps(taps.real, device),
                flipped_taps(taps.imag, device))
    return (flipped_taps(taps, device),)


def fir_planes(planes, tap_planes, stride: int, n_out: int, tails=None):
    """The FIR of one real plane or the (re, im) planes of a complex signal
    with real or complex taps (`flipped_tap_planes`): one launch of the
    routed kernel (`fir_stream`) a tap plane, each over every input plane,
    and for complex taps on complex input the JAX package's combine
    (qradiolink_tpu/ops/fir.py:304-311), (rr - ii, ri + ir). Returns one
    output plane for real input and real taps, two (re, im) otherwise."""
    ys = [fir_stream(planes, t, stride, n_out, tails=tails)
          for t in tap_planes]
    if len(ys) == 1:
        return ys[0]
    if len(planes) == 1:  # real input, complex taps
        return ys[0][0], ys[1][0]
    (rr, ir), (ri, ii) = ys
    return rr - ii, ri + ir


def _planes_of(x) -> tuple:
    if isinstance(x, IqPair):
        return x.re, x.im
    if torch.is_complex(x):
        return x.real.contiguous(), x.imag.contiguous()
    return (x.contiguous(),)


def _like(x, ys):
    """Output planes as the input's kind: an IqPair for an IqPair, a
    complex tensor for two planes, a real one for one."""
    if isinstance(x, IqPair):
        return IqPair(*ys)
    return torch.complex(*ys) if len(ys) == 2 else ys[0]


def conv1d_valid(x: torch.Tensor, taps, stride: int = 1,
                 out_len: int | None = None) -> torch.Tensor:
    """VALID FIR: y[m] = sum_k taps[k] * x[m*stride + K-1 - k].

    x real f32 or complex64, taps real or complex. out_len, if given,
    keeps only the first out_len outputs."""
    return conv1d_valid_flipped(x, flipped_tap_planes(taps, x.device),
                                stride, out_len)


def conv1d_valid_flipped(x, tap_planes, stride, out_len=None):
    """conv1d_valid with the taps already flipped on x's device, as the
    blocks keep them (`flipped_tap_planes`), through the kernel's K2 form:
    no tail."""
    n_full = (x.shape[-1] - tap_planes[0].shape[0]) // stride + 1
    n_out = n_full if out_len is None else int(out_len)
    if n_out > n_full:
        raise ValueError(f"out_len {n_out} exceeds available {n_full}")
    return _like(x, fir_planes(_planes_of(x), tap_planes, stride, n_out))


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

    Taps real or complex. Input: an IqPair, a complex64 or a real f32
    tensor; the output is of the input's kind, complex for real input and
    complex taps. Every call reads the tails in place from the state (the
    concatenation [tail | x] is never built); complex taps take two
    launches (`fir_planes`). State: (..., 2, K-1) f32, the (re, im) planes
    of the last K-1 inputs (im is zero for real input), as in the JAX
    package."""

    def __init__(self, taps, decim: int = 1, lead_shape: tuple = (),
                 device=None):
        taps = np.asarray(taps)
        self.device = resolve_device(device)
        self.tap_planes = flipped_tap_planes(taps, self.device)
        # the real taps (the real part for complex taps)
        self.taps_flipped = self.tap_planes[0]
        self.ntaps = int(taps.shape[0])
        self.decim = int(decim)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.ntaps - 1),
                           dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        planes = _planes_of(x)
        T = planes[0].shape[-1]
        if isinstance(x, IqPair) and T % self.decim != 0:
            raise ValueError(
                f"block length {T} not a multiple of decimation {self.decim}")
        k1 = self.ntaps - 1
        tails = (state[..., 0, :], state[..., 1, :])[:len(planes)]
        ys = fir_planes(planes, self.tap_planes, self.decim,
                        (T - 1) // self.decim + 1, tails=tails)
        new = [next_tail(t, p, k1) for t, p in zip(tails, planes)]
        if len(new) == 1:
            new.append(torch.zeros_like(new[0]))
        return torch.stack(new, dim=-2), _like(x, ys)
