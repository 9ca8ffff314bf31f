"""Polyphase filter-bank channelizer and synthesizer (port of
qradiolink_tpu/ops/channelizer.py).

The reference's multi-carrier MMDVM path splits a 250 ksps stream into 10
channels at 25 kHz spacing with gr::filter::pfb_channelizer_ccf and
recombines TX with pfb_synthesizer_ccf (reference
src/gr/gr_demod_mmdvm_multi2.cpp:98-135, gr_mod_mmdvm_multi2.cpp:91-127).

Channelizer math (critically sampled, M channels):
  y_k[m] = sum_p exp(+2pi i k p / M) * v_p[m],
  v_p[m] = sum_l h[p + M l] * x[(m-l) M - p]
so channel k (centered at +k*fs/M, k mod M) is an IDFT across the M branch
filter outputs. Synthesizer is the exact adjoint: IDFT across channels ->
branch filters g[p::M] -> commutate branches into the output stream.

Routes: the channelizer runs IqPair input through the fused kernel (K5)
that ops/cuda_pfb.route(M, kp) picks: `pfb_fft_f32` at M = 8, 16, 32, 64
(kp 8-32) and at M 10 with kp 56 (MMDVMmulti's channelizer),
`pfb_channelize_f32` at every other shape. The JAX package's
default route (commutator, depthwise branch FIRs, four einsums) is slower
on an H100 (PERF.md) and is not ported as a second IqPair route. Complex
input runs the commutator in PyTorch, the branch FIRs in the K4 kernel
that ops/cuda_depthwise.route(kp) picks (`depthwise_run_f32` at the
default kp 24, its VALID form) and the IDFT through torch.fft.ifft. The
synthesizer's branch FIRs run K4 in its tail form (`depthwise_run_f32` at
the default kp 23 and at MMDVMmulti's kp 53; `depthwise_fir_f32` after a
concatenation at any other kp), reading the carried tails in place from
the state. On
CPU tensors each kernel wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import Block, IqPair, resolve_device
from qradiolink_tpu_torch.ops.cuda_depthwise import depthwise_fir
from qradiolink_tpu_torch.ops.cuda_pfb import channelize, pfb_tables
from qradiolink_tpu_torch.ops.fir import next_tail
from qradiolink_tpu_torch.ops.resample import kaiser_low_pass


def default_channelizer_taps(num_channels: int, taps_per_branch: int = 32,
                             excess_bw: float = 0.2) -> np.ndarray:
    """Prototype low-pass: cutoff at the channel half-width."""
    fs = float(num_channels)
    return kaiser_low_pass(1.0, fs, 0.5, excess_bw, beta=7.0)[
        : num_channels * taps_per_branch]


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


class PfbChannelizer(Block):
    """x (..., T) at fs -> (..., M, T/M) channels at fs/M.

    Channel k is centered at +k*fs/M (k >= M/2 alias to negative freqs).
    Block length T must be a multiple of M. State: the raw input history,
    the last kp*M samples as f32 (re, im) planes (..., 2, kp*M), with kp
    (taps per branch) rounded up to a multiple of 8 as in the JAX package,
    so that states cross between the two packages.
    """

    def __init__(self, num_channels: int, taps=None, lead_shape: tuple = (),
                 device=None):
        self.M = int(num_channels)
        self.device = resolve_device(device)
        if taps is None:
            taps = default_channelizer_taps(self.M)
        taps = np.asarray(taps, dtype=np.float32)
        kp = -(-taps.shape[0] // self.M)
        kp = -(-kp // 8) * 8  # the JAX package's sublane rounding
        padded = np.zeros(kp * self.M, dtype=np.float32)
        padded[: taps.shape[0]] = taps
        # branch p filter: h[p::M]
        bt = np.stack([padded[p::self.M] for p in range(self.M)])  # (M, kp)
        # commutator-ordered rows: row q filters with branch p = M-1-q
        self.branch_taps_q = bt[::-1].copy()
        self.kp = kp
        self.lead_shape = tuple(lead_shape)
        dev = self.device
        self._btq_flipped = _f32(self.branch_taps_q[:, ::-1], dev)
        ct, dft = pfb_tables(self.branch_taps_q)
        self._ct, self._dft = _f32(ct, dev), _f32(dft, dev)

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.kp * self.M),
                           dtype=torch.float32, device=self.device)

    def _split_state(self, raw_p):
        """One raw-history plane (..., kp*M) -> (hist (..., M-1),
        tails_q (..., M, kp-1)) for the commutator route.

        tails_q[q, j] = u[Tm_prev - (kp-1) + j, q] = raw[j*M + q + 1]."""
        hist = raw_p[..., raw_p.shape[-1] - (self.M - 1):]
        t = raw_p[..., 1: 1 + (self.kp - 1) * self.M]
        t = t.reshape(t.shape[:-1] + (self.kp - 1, self.M))
        return hist, t.transpose(-1, -2)

    def _commutate(self, raw_p, xp):
        """One plane through the input commutator: (..., M, Tm + kp-1),
        rows in COMMUTATOR order q (row q carries x[t*M + q - (M-1)], i.e.
        polyphase branch p = M-1-q), the branch FIR tails prepended. The
        flip of the textbook formulation is folded into the branch-tap row
        order and the IDFT matrix instead."""
        hist, tails = self._split_state(raw_p)
        T = xp.shape[-1]
        z = torch.cat([hist, xp], dim=-1)  # z[i] = x[i-(M-1)]
        u = z[..., :T].reshape(xp.shape[:-1] + (T // self.M, self.M))
        return torch.cat([tails, u.transpose(-1, -2)], dim=-1)

    def _new_raw(self, state, xr, xi):
        km = self.kp * self.M
        return torch.stack([next_tail(state[..., 0, :], xr, km),
                            next_tail(state[..., 1, :], xi, km)], dim=-2)

    def _branches(self, state, xr, xi):
        """Commutator and K4 branch FIRs: (vr, vi), each (..., M, Tm),
        row q holding branch p = M-1-q."""
        ucr = self._commutate(state[..., 0, :], xr)
        uci = self._commutate(state[..., 1, :], xi)
        return depthwise_fir((ucr, uci), self._btq_flipped,
                             xr.shape[-1] // self.M)

    def __call__(self, state, x):
        T = x.shape[-1]
        if T % self.M != 0:
            raise ValueError(f"block length {T} not a multiple of M={self.M}")
        if isinstance(x, IqPair):
            yr, yi = channelize((x.re.contiguous(), x.im.contiguous()),
                                state.contiguous(), self._ct, self._dft)
            return self._new_raw(state, x.re, x.im), IqPair(yr, yi)
        # complex input: branch FIRs, then torch.fft.ifft across branches
        xr, xi = x.real.float(), x.imag.float()
        vr, vi = self._branches(state, xr, xi)
        v = torch.flip(torch.complex(vr, vi), dims=(-2,))  # polyphase order
        y = torch.fft.ifft(v, dim=-2) * self.M
        return self._new_raw(state, xr, xi), y.to(torch.complex64)


class PfbSynthesizer(Block):
    """Channels (..., M, Tm) at fs/M -> (..., M*Tm) stream at fs.

    State: the per-branch FIR tails, (..., 2, M, kp-1) f32 (re, im)
    planes. kp is NOT rounded here (the JAX package rounds only the
    channelizer's): at M = 64, kp = 23."""

    def __init__(self, num_channels: int, taps=None, lead_shape: tuple = (),
                 device=None):
        self.M = int(num_channels)
        self.device = resolve_device(device)
        if taps is None:
            taps = default_channelizer_taps(self.M)
            taps = taps * self.M  # interpolation gain
        taps = np.asarray(taps, dtype=np.float32)
        kp = -(-taps.shape[0] // self.M)
        padded = np.zeros(kp * self.M, dtype=np.float32)
        padded[: taps.shape[0]] = taps
        self.branch_taps = np.stack([padded[p::self.M]
                                     for p in range(self.M)])
        self.kp = kp
        self.lead_shape = tuple(lead_shape)
        self._bt_flipped = _f32(self.branch_taps[:, ::-1], self.device)
        # w_p = sum_k s_k e^{+2pi i p k / M}  (ifft * M across channels)
        k = np.arange(self.M)
        w = np.exp(2j * np.pi * np.outer(k, k) / self.M)
        self._w_re = _f32(w.real, self.device)
        self._w_im = _f32(w.imag, self.device)

    def init_state(self):
        return torch.zeros(self.lead_shape + (2, self.M, self.kp - 1),
                           dtype=torch.float32, device=self.device)

    @staticmethod
    def _commutate_out(out_p, M):
        # y[t*M + p] = out_p[p, t]
        y = out_p.transpose(-1, -2)  # (..., Tm, M)
        return y.reshape(out_p.shape[:-2] + (out_p.shape[-1] * M,))

    def _branches(self, state, wre, wim):
        """The IDFT outputs (..., M branches, Tm), as f32 planes, through
        the K4 branch FIRs after the carried tails, which K4's tail form
        reads in place from the state: (new_state, vr, vi)."""
        k1 = self.kp - 1
        tails = (state[..., 0, :, :], state[..., 1, :, :])
        wre, wim = wre.contiguous(), wim.contiguous()
        vr, vi = depthwise_fir((wre, wim), self._bt_flipped, wre.shape[-1],
                               tails=tails)
        new_state = torch.stack([next_tail(tails[0], wre, k1),
                                 next_tail(tails[1], wim, k1)], dim=-3)
        return new_state, vr, vi

    def __call__(self, state, s):
        if isinstance(s, IqPair):
            wre = torch.matmul(self._w_re, s.re) - torch.matmul(self._w_im,
                                                                s.im)
            wim = torch.matmul(self._w_re, s.im) + torch.matmul(self._w_im,
                                                                s.re)
            new_state, vr, vi = self._branches(state, wre, wim)
            return new_state, IqPair(self._commutate_out(vr, self.M),
                                     self._commutate_out(vi, self.M))
        # s: (..., M, Tm) complex channel streams
        w = (torch.fft.ifft(s, dim=-2) * self.M).to(torch.complex64)
        new_state, vr, vi = self._branches(state, w.real, w.imag)
        y = self._commutate_out(torch.complex(vr, vi), self.M)
        return new_state, y
