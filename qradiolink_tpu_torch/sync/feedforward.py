"""Feedforward (block-parallel) synchronization (port of
qradiolink_tpu/sync/feedforward.py: block_agc, the Viterbi & Viterbi
carrier recovery, the Oerder & Meyr timing estimator, the Farrow
interpolator, symbol_pick and FeedforwardSymbolSync).

Carrier phase is estimated per sub-block from x^order (Viterbi & Viterbi
1983) and interpolated linearly over time. Timing is estimated per
sub-block from the symbol-rate spectral line of |x|^2 (Oerder & Meyr 1988)
and applied with a cubic-Lagrange Farrow fractional delay plus an integer
symbol pick, so a whole block is a handful of reshapes, reductions and
elementwise ops with no sequential loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, resolve_device


def block_agc(x: torch.Tensor, reference: float = 1.0, n_sub: int = 16,
              eps: float = 1e-12) -> torch.Tensor:
    """Feedforward AGC: normalize each of n_sub sub-blocks to `reference`
    RMS. T must be a multiple of n_sub."""
    t = x.shape[-1]
    lead = tuple(x.shape[:-1])
    sub = x.reshape(lead + (n_sub, t // n_sub))
    rms = torch.sqrt(torch.mean(torch.abs(sub) ** 2, dim=-1, keepdim=True)
                     + eps)
    return (sub * (reference / rms)).reshape(x.shape)


def _subblock_phases(x: torch.Tensor, order: int, n_sub: int):
    """V&V: phase of sum(x^order) per sub-block, divided by order."""
    t = x.shape[-1]
    lead = tuple(x.shape[:-1])
    xm = x
    for _ in range(int(np.log2(order))):
        xm = xm * xm  # order is 2 or 4
    s = torch.sum(xm.reshape(lead + (n_sub, t // n_sub)), dim=-1)
    return torch.atan2(s.imag, s.real) / order  # (..., n_sub)


def _unwrap(ph: torch.Tensor, period: float) -> torch.Tensor:
    """Unwrap sub-block phase estimates: the jump corrections summed by a
    prefix-sum tree of adds over the small sub-block axis, as the JAX
    package does (the same additions in the same order)."""
    corr = -torch.round((ph[..., 1:] - ph[..., :-1]) / period) * period
    n = corr.shape[-1]
    acc = corr
    shift = 1
    while shift < n:
        pad = torch.zeros(tuple(corr.shape[:-1]) + (shift,),
                          dtype=corr.dtype, device=corr.device)
        acc = acc + torch.cat([pad, acc[..., :-shift]], dim=-1)
        shift *= 2
    return torch.cat([ph[..., :1], ph[..., 1:] + acc], dim=-1)


@functools.lru_cache(maxsize=8)
def _vv_tables(t: int, n_sub: int, device: torch.device):
    """Each sample's interpolation weight between its two knots and the
    one-hot (t, n_sub) selectors of those knots (f32, made once a
    shape)."""
    ls = t // n_sub
    centers = (torch.arange(n_sub, dtype=torch.float32) + 0.5) * ls
    tt = torch.arange(t, dtype=torch.float32)
    seg = torch.clamp((tt - centers[0]) / ls, 0, n_sub - 1 - 1e-6)
    i0 = torch.floor(seg)
    ar = torch.arange(n_sub, dtype=torch.float32)
    oh0 = (i0[:, None] == ar[None, :]).float()
    oh1 = ((i0 + 1)[:, None] == ar[None, :]).float()
    return tuple(v.to(device) for v in (seg - i0, oh0.T.contiguous(),
                                         oh1.T.contiguous()))


def vv_carrier_correct(x: torch.Tensor, order: int = 2, n_sub: int = 16):
    """Viterbi & Viterbi carrier recovery: estimate the residual carrier
    phase per sub-block from x^order, interpolate it linearly between the
    sub-block centres, and derotate. x: complex (..., T), T a multiple of
    n_sub. Returns (corrected, phases (..., n_sub)).

    The knots are selected with one-hot products (torch.matmul, in full
    f32: TF32 stays off), as the JAX package does."""
    ph = _unwrap(_subblock_phases(x, order, n_sub), 2 * np.pi / order)
    frac, oh0, oh1 = _vv_tables(x.shape[-1], int(n_sub), x.device)
    p0 = torch.matmul(ph, oh0)
    p1 = torch.matmul(ph, oh1)
    phase_t = p0 + frac * (p1 - p0)
    rot = torch.complex(torch.cos(phase_t), -torch.sin(phase_t))
    return x * rot, ph


@functools.lru_cache(maxsize=32)
def _om_tables(ls: int, sps: int, n_sub: int, device: torch.device):
    """cos/sin of the bin's exponential over one sub-block, and of the
    sub-block start offsets (f32 constants, made once per shape)."""
    n = np.arange(ls, dtype=np.float64)
    ang = -2 * np.pi * n / sps
    a0 = -2 * np.pi * np.arange(n_sub, dtype=np.float64) * ls / sps
    return tuple(torch.from_numpy(v.astype(np.float32)).to(device)
                 for v in (np.cos(ang), np.sin(ang), np.cos(a0), np.sin(a0)))


def om_timing_bins(x: torch.Tensor, sps: int, n_sub: int = 4):
    """Oerder&Meyr spectral bin per sub-block, as real (re, im) planes.

    bin_k = sum_n |x[n]|^2 exp(-j 2 pi n / sps) over sub-block k, with the
    phase referenced to the BLOCK start, so bins of consecutive blocks whose
    lengths are multiples of sps share one phase reference and may be
    summed (FeedforwardSymbolSync's streaming accumulator)."""
    t = x.shape[-1]
    lead = tuple(x.shape[:-1])
    ls = t // n_sub
    if torch.is_complex(x):
        p = (x.real * x.real + x.imag * x.imag).float()
    else:
        p = (x * x).float()
    p = p.reshape(lead + (n_sub, ls))
    wc, ws, w0c, w0s = _om_tables(ls, int(sps), int(n_sub), p.device)
    sr = p @ wc
    si = p @ ws
    re = sr * w0c - si * w0s
    im = sr * w0s + si * w0c
    return re, im  # each (..., n_sub)


def _bins_to_tau(re: torch.Tensor, im: torch.Tensor, sps: int):
    return torch.remainder((-float(sps) / (2 * np.pi)) * torch.atan2(im, re),
                           float(sps))


def om_timing_estimate(x: torch.Tensor, sps: int, n_sub: int = 4):
    """Oerder&Meyr: per-sub-block symbol-timing offset in samples [0, sps)."""
    re, im = om_timing_bins(x, sps, n_sub)
    return _bins_to_tau(re, im, sps)


# cubic Lagrange Farrow branch filters over points [-1, 0, 1, 2]:
# y(n+mu) = sum_p mu^p * (c_p . x[n-1 : n+3])
_FARROW_C = np.array([
    [0.0, 1.0, 0.0, 0.0],                      # mu^0
    [-1 / 3, -1 / 2, 1.0, -1 / 6],             # mu^1
    [1 / 2, -1.0, 1 / 2, 0.0],                 # mu^2
    [-1 / 6, 1 / 2, -1 / 2, 1 / 6],            # mu^3
], dtype=np.float32)


def farrow_delay(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Fractional-delay resample: y[n] = x(n + mu[n]), mu in [0, 1).

    Output length T-3; y[n] uses x[n-1..n+2] evaluated at position n+mu."""
    n_out = x.shape[-1] - 3
    win = [x[..., i: i + n_out] for i in range(4)]
    branches = []
    for p in range(4):
        c = [float(v) for v in _FARROW_C[p]]
        branches.append(win[0] * c[0] + win[1] * c[1] + win[2] * c[2]
                        + win[3] * c[3])
    mu = mu[..., :n_out]
    acc = branches[3]
    for p in (2, 1, 0):
        acc = acc * mu + branches[p]
    return acc


def _one_hot_pick(frames: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """frames (..., S, N, W), idx (..., S) integer-valued in [0, W) ->
    frames[..., s, n, idx[..., s]] as a one-hot contraction (which keeps the
    reference's NaN semantics: a NaN index picks nothing)."""
    w = frames.shape[-1]
    oh = (idx[..., None] == torch.arange(w, dtype=idx.dtype,
                                         device=idx.device)).to(frames.dtype)
    return torch.sum(frames * oh[..., None, :], dim=-1)


def symbol_pick(y: torch.Tensor, tau_int: torch.Tensor, sps: int):
    """One sample per symbol period at integer offset tau_int (per
    sub-block). y: (..., S, Ns*sps); tau_int: (..., S) in [0, sps).
    Returns (..., S, Ns)."""
    lead = tuple(y.shape[:-1])
    ns = y.shape[-1] // sps
    return _one_hot_pick(y.reshape(lead + (ns, sps)), tau_int)


class FeedforwardSymbolSync(Block):
    """Block-parallel symbol timing recovery (O&M + Farrow).

    Consumes T samples at `sps` samples/symbol, emits T//sps symbols. State:
    ((..., 2, 4+sps) f32 tail planes, (..., 4) f32 [bin_re, bin_im, center,
    have]): the last 4+sps input samples, the decayed sum of earlier blocks'
    O&M bins, and the pick center, fixed once from the first block. As in
    the reference, the center is never updated after the first block.

    `window` mode (a fixed estimator window, stateless estimates) reads
    neither accumulator nor center, so it is block-partition invariant.
    """

    #: accumulator decay per block: effective memory ~1/(1-decay) blocks
    ACC_DECAY = 0.75

    def __init__(self, sps: int, n_sub: int = 4, lead_shape: tuple = (),
                 window: int | None = None, device=None):
        self.sps = int(sps)
        self.n_sub = int(n_sub)
        self.window = None if window is None else int(window)
        if self.window is not None and self.window % self.sps != 0:
            raise ValueError("window must be a multiple of sps")
        self.lead_shape = tuple(lead_shape)
        self.tail_len = 4
        self.device = resolve_device(device)

    def init_state(self):
        return (torch.zeros(self.lead_shape + (2, self.tail_len + self.sps),
                            dtype=torch.float32, device=self.device),
                torch.zeros(self.lead_shape + (4,), dtype=torch.float32,
                            device=self.device))

    def _window(self, x, xc, acc):
        sps = self.sps
        t = x.shape[-1]
        lead = tuple(x.shape[:-1])
        if t % self.window != 0:
            raise ValueError(f"block {t} not a multiple of window "
                             f"{self.window}")
        s = t // self.window
        if t % (s * sps) != 0:
            raise ValueError("block must divide into n_sub*sps")
        tau = om_timing_estimate(x, sps, n_sub=s)
        # farrow_delay output is y[n] = x(n - 3 + mu) (4-sample history),
        # so the pick offset compensates with +3
        tau = torch.remainder(tau + 3.0, float(sps))
        tau_i = torch.floor(tau)
        mu = tau - tau_i
        ls = t // s
        mu_t = torch.repeat_interleave(mu, ls, dim=-1)
        y = farrow_delay(xc[..., sps:],
                         torch.cat([mu_t, mu_t[..., -3:]], dim=-1))
        ysub = y[..., :t].reshape(lead + (s, ls))
        syms = symbol_pick(ysub, tau_i, sps)
        return syms.reshape(lead + (t // sps,)), acc

    def _stream(self, x, xc, acc):
        sps = self.sps
        t = x.shape[-1]
        lead = tuple(x.shape[:-1])
        s = self.n_sub
        if t % (s * sps) != 0:
            raise ValueError("block must divide into n_sub*sps")
        bre, bim = om_timing_bins(x, sps, n_sub=s)
        sre = bre + acc[..., 0:1]
        sim = bim + acc[..., 1:2]
        tau = _bins_to_tau(sre, sim, sps)
        tau = torch.remainder(tau + 3.0, float(sps))   # applied offset
        # one-time per-channel pick center in [sps/2, 3*sps/2): the circular
        # offset is mapped to its representative nearest the center
        pool = _bins_to_tau(torch.sum(sre, dim=-1), torch.sum(sim, dim=-1),
                            sps)
        pool = torch.remainder(pool + 3.0, float(sps))
        c_new = pool + torch.where(pool < sps / 2.0, float(sps), 0.0)
        center = torch.where(acc[..., 3] > 0.5, acc[..., 2], c_new)
        k = torch.round((center[..., None] - tau) / sps)
        o = torch.clamp(tau + k * float(sps), 0.0, 2.0 * sps - 1e-3)
        o_i = torch.floor(o)                           # [0, 2*sps)
        mu = o - o_i
        ls = t // s
        mu_t = torch.repeat_interleave(mu, ls, dim=-1)
        # y[j] = x(j - sps - 3 + mu_j), j in [0, t + sps): one symbol of
        # reach into the previous block
        mu_ext = torch.cat([mu[..., :1].expand(lead + (sps,)), mu_t,
                            mu_t[..., -1:]], dim=-1)   # (..., t+sps+1)
        y = farrow_delay(xc, mu_ext)[..., : t + sps]
        # extended frames, 2*sps wide at sps stride: the pick window
        # straddles the frame boundary
        ns = t // sps
        yf = y.reshape(lead + (ns + 1, sps))
        ext = torch.cat([yf[..., :-1, :], yf[..., 1:, :]], dim=-1)
        ext = ext.reshape(lead + (s, ns // s, 2 * sps))
        syms = _one_hot_pick(ext, o_i).reshape(lead + (ns,))
        new_acc = torch.cat([
            self.ACC_DECAY * (acc[..., :2] + torch.stack(
                [torch.sum(bre, dim=-1), torch.sum(bim, dim=-1)], dim=-1)),
            center[..., None], torch.ones_like(center)[..., None]], dim=-1)
        return syms, new_acc

    def __call__(self, state, x):
        tail, acc = state
        if torch.is_complex(x):
            tail_x = torch.complex(tail[..., 0, :], tail[..., 1, :])
        else:
            tail_x = tail[..., 0, :].to(x.dtype)
        xc = torch.cat([tail_x, x], dim=-1)  # (..., t + sps + 4)
        if self.window is not None:
            syms, new_acc = self._window(x, xc, acc)
        else:
            syms, new_acc = self._stream(x, xc, acc)
        new_tail = xc[..., xc.shape[-1] - (self.tail_len + self.sps):]
        if torch.is_complex(new_tail):
            new_tail = torch.stack([new_tail.real, new_tail.imag], dim=-2)
        else:
            new_tail = new_tail.float()
            new_tail = torch.stack([new_tail, torch.zeros_like(new_tail)],
                                   dim=-2)
        return (new_tail, new_acc), syms
