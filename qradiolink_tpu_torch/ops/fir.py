"""Streaming FIR filters (port of qradiolink_tpu/ops/fir.py).

A FIR is a function on (tail_state, x): the carried state is the last
ntaps-1 input samples, so output is the same however the stream is split
into blocks.

Convention: y[n] = sum_k h[k] * x[n-k] with x[<0] from the carried tail
(zeros at stream start). Output length == input length / decim; output y[m]
aligns with input x[m*D].

Two forms, chosen per filter by `impl`, the same rule on every device:
  * "conv", the direct form: on CUDA tensors the kernel that
    `ops/cuda_fir.route()` picks for the shape, on CPU tensors its plain
    version; complex taps are two launches, one a tap plane, as the JAX
    package's IqPair path computes them;
  * "fft", overlap-save over the whole block (`fft_fir_block`, the JAX
    package's `jnp.fft` form): `torch.fft`, which is cuFFT on the card.
"auto" resolves a call by one rule, the same on every device
(`auto_impl`): the FFT for complex taps of more than 96 at decimation 1 on
a complex tensor, the direct form otherwise. Real taps stay direct: they
feed the M&M and Costas decision loops, whose card-against-CPU bit gates
rest on the direct form. IqPair planes stay direct too, as in the JAX
package's FirFilter: the FFT form would join them into complex and split
its output back, and on an H100 that made it slower than the direct
kernels at SSB's 2048 x 1,600 (chip_smoke.py, PERF.md). (The JAX
package's "auto" takes the FFT on its CPU backend for every filter of more
than 96 taps at decimation <= 2 on a tensor, real or complex taps, and
never on the TPU.)
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.cuda_fir import fir_stream
from qradiolink_tpu_torch.utils.profiling import kernel_paths

# "auto"'s rule: the FFT form for complex taps of at least this many (the
# JAX package's "more than 96") at decimation 1 on a complex tensor. Timed
# in turns against the direct kernels at every such filter's path shape on
# an H100 (chip_smoke.py fft_route_phase, PERF.md), the FFT ran faster on
# complex input at each: AmMod's K963, FreeDvMod's K133, SsbMod's K167
FFT_MIN_TAPS = 97
# the FFT form's record in utils/profiling.kernel_paths: cuFFT, not a
# kernel of this package
FFT_OP = "torch_fft_fir"


def auto_impl(taps, decim: int, complex_input: bool) -> str:
    """The form "auto" resolves to for a call: "fft" for complex taps of at
    least FFT_MIN_TAPS at decimation 1 on a complex tensor, "conv"
    otherwise (real taps, decimation, IqPair planes or real input); the
    same on every device."""
    taps = np.asarray(taps)
    if (complex_input and np.iscomplexobj(taps) and int(decim) == 1
            and taps.shape[0] >= FFT_MIN_TAPS):
        return "fft"
    return "conv"


def flipped_taps(taps, device) -> torch.Tensor:
    """Real taps reversed, as the contiguous f32 tensor the kernel reads."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        raise ValueError("complex taps: use flipped_tap_planes")
    # a copy: a one-tap view reversed keeps its negative stride
    return torch.from_numpy(
        np.array(taps[::-1], dtype=np.float32)).to(device)


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
    return combine_tap_planes([fir_stream(planes, t, stride, n_out,
                                          tails=tails)
                               for t in tap_planes])


def combine_tap_planes(ys):
    """The output planes of a filter from its runs a tap plane: ys[j] the
    output planes of tap plane j over every input plane. One tap plane:
    its run as it is; complex taps on real input: (real-tap run,
    imaginary-tap run); complex taps on complex input: the JAX package's
    combine (rr - ii, ri + ir)."""
    if len(ys) == 1:
        return ys[0]
    if len(ys[0]) == 1:  # real input, complex taps
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


def fir_filter(x: torch.Tensor, taps, decim: int = 1) -> torch.Tensor:
    """One-shot FIR with zero history: y[m] = sum_k h[k] x[m*decim - k]."""
    k = np.asarray(taps).shape[0]
    return conv1d_valid(torch.nn.functional.pad(x, (k - 1, 0)), taps, decim)


def fft_len(n: int) -> int:
    """The FFT length of a block of n samples: the next power of two."""
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def fft_fir_block(xc: torch.Tensor, taps, decim: int = 1,
                  taps_fft=None) -> torch.Tensor:
    """Overlap-save core (qradiolink_tpu/ops/fir.py:197-212): xc already
    holds the K-1 history prefix; returns the T/decim valid outputs (T =
    xc.shape[-1] - K + 1), real for real input with real taps, complex64
    otherwise. The FFT length is the next power of two of T + K - 1.
    taps_fft, if given, is the taps' FFT at that length (complex64)."""
    taps_np = np.asarray(taps)
    k = taps_np.shape[-1]
    t = xc.shape[-1] - (k - 1)
    n = fft_len(xc.shape[-1])
    complex_out = torch.is_complex(xc) or np.iscomplexobj(taps_np)
    if taps_fft is None:
        taps_fft = torch.fft.fft(torch.from_numpy(
            taps_np.astype(np.complex64)).to(xc.device), n=n)
    X = torch.fft.fft(xc, n=n)
    X.mul_(taps_fft)
    y = torch.fft.ifft(X)[..., k - 1: k - 1 + t]
    if not complex_out:
        y = y.real
    if decim > 1:
        y = y[..., ::decim]
    return y


class FirFilter(Block):
    """Streaming FIR with carried input tail; optional decimation.

    Taps real or complex. Input: an IqPair, a complex64 or a real f32
    tensor; the output is of the input's kind, complex for real input and
    complex taps. impl: "conv" (the direct form: every call reads the tails
    in place from the state, the concatenation [tail | x] is never built,
    and complex taps take two launches, `fir_planes`), "fft" (overlap-save
    over [tail | x], `fft_fir_block`) or "auto" (`auto_impl`, a call at a
    time: `form`). State: (..., 2, K-1) f32, the (re, im) planes of the
    last K-1 inputs (im is zero for real input), as in the JAX package."""

    def __init__(self, taps, decim: int = 1, impl: str = "auto",
                 lead_shape: tuple = (), device=None):
        taps = np.asarray(taps)
        self.device = resolve_device(device)
        self.taps = taps
        self.tap_planes = flipped_tap_planes(taps, self.device)
        # the real taps (the real part for complex taps)
        self.taps_flipped = self.tap_planes[0]
        self.ntaps = int(taps.shape[0])
        self.decim = int(decim)
        self.lead_shape = tuple(lead_shape)
        if impl not in ("conv", "fft", "auto"):
            raise ValueError(f"impl {impl!r}: 'conv', 'fft' or 'auto'")
        self.impl = impl
        self._taps_fft = {}

    def form(self, complex_input: bool) -> str:
        """The form a call on a complex tensor (complex_input) or on IqPair
        planes or real input takes: "conv" or "fft"."""
        if self.impl != "auto":
            return self.impl
        return auto_impl(self.taps, self.decim, complex_input)

    def taps_fft(self, n: int) -> torch.Tensor:
        """The taps' FFT at length n, complex64 on the block's device
        (computed once a length)."""
        if n not in self._taps_fft:
            self._taps_fft[n] = torch.fft.fft(torch.from_numpy(
                self.taps.astype(np.complex64)).to(self.device), n=n)
        return self._taps_fft[n]

    def _call_fft(self, state, x, planes):
        k1 = self.ntaps - 1
        tails = (state[..., 0, :], state[..., 1, :])[:len(planes)]
        xcs = [torch.cat([t, p], dim=-1) for t, p in zip(tails, planes)]
        xc = xcs[0] if len(xcs) == 1 else torch.complex(*xcs)
        kernel_paths.record(FFT_OP, xc.is_cuda,
                            f"K{self.ntaps} D{self.decim} "
                            f"{len(planes)}x{xc.numel() // xc.shape[-1]}")
        y = fft_fir_block(xc, self.taps, self.decim,
                          self.taps_fft(fft_len(xc.shape[-1])))
        new = [xcp[..., xcp.shape[-1] - k1:] for xcp in xcs]
        if len(new) == 1:
            new.append(torch.zeros_like(new[0]))
        new_state = torch.stack(new, dim=-2)
        if isinstance(x, IqPair):
            return new_state, IqPair(y.real.contiguous(),
                                     y.imag.contiguous())
        return new_state, y

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.ntaps - 1),
                           dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        planes = _planes_of(x)
        T = planes[0].shape[-1]
        if isinstance(x, IqPair) and T % self.decim != 0:
            raise ValueError(
                f"block length {T} not a multiple of decimation {self.decim}")
        if self.form(not isinstance(x, IqPair)
                     and torch.is_complex(x)) == "fft":
            return self._call_fft(state, x, planes)
        k1 = self.ntaps - 1
        tails = (state[..., 0, :], state[..., 1, :])[:len(planes)]
        ys = fir_planes(planes, self.tap_planes, self.decim,
                        (T - 1) // self.decim + 1, tails=tails)
        new = [next_tail(t, p, k1) for t, p in zip(tails, planes)]
        if len(new) == 1:
            new.append(torch.zeros_like(new[0]))
        return torch.stack(new, dim=-2), _like(x, ys)


class FftFirFilter(FirFilter):
    """FFT-implemented streaming FIR (the fft_filter_ccf/ccc/fff
    equivalent)."""

    def __init__(self, taps, decim: int = 1, lead_shape: tuple = (),
                 device=None):
        super().__init__(taps, decim=decim, impl="fft",
                         lead_shape=lead_shape, device=device)
