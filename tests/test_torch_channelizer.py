"""The port's PFB channelizer and synthesizer against the JAX package on the
CPU, and the plain versions of the two kernels behind them against the JAX
Pallas kernels they replace (`depthwise_fir`, K4; fused `channelize`, K5),
run in interpret mode.

Tolerance: outputs within 1e-5 relative to their peak, the bound the JAX
package holds its fused channelizer to (tests/test_pallas_kernels.py);
the fused formulation sums the branch FIR in another order than the JAX
jnp route, and the port's plain DFT is an FFT, not a product. The
channelizer's state (a copy of raw input) must be exact; the
synthesizer's state holds IDFT outputs, also held within 1e-5 of their
peak.
"""

import functools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import qradiolink_tpu.ops.pallas_fir as pf  # noqa: E402
import qradiolink_tpu.ops.pallas_pfb as pp  # noqa: E402
from qradiolink_tpu.ops import channelizer as jch  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import channelizer as tch  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_depthwise import (  # noqa: E402
    depthwise_fir, depthwise_fir_plain)
from qradiolink_tpu_torch.ops import cuda_depthwise, cuda_pfb  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_pfb import (  # noqa: E402
    channelize, channelize_plain, dft_factors, fft_table, pfb_tables)
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import assert_same, stream_both  # noqa: E402

TOL = 1e-5


@pytest.fixture
def pallas_interp(monkeypatch):
    """Run the JAX package's depthwise and fused channelizer kernels in
    interpret mode on the CPU (the pattern of tests/test_pallas_kernels.py)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(pf, "available", lambda: True)
    monkeypatch.setattr(pp, "available", lambda: True)
    monkeypatch.setattr(pf, "_MIN_ELEMS", 1)
    monkeypatch.setattr(pp, "_MIN_ELEMS", 1)
    pf.depthwise_plan.cache_clear()
    pp.plan.cache_clear()
    yield
    pf.depthwise_plan.cache_clear()
    pp.plan.cache_clear()


def _iq(rng, shape):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64)


@pytest.mark.parametrize("M", [8, 10, 64])
def test_taps_identical(M):
    a = jch.default_channelizer_taps(M)
    b = tch.default_channelizer_taps(M)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    jc, tc = jch.PfbChannelizer(M), tch.PfbChannelizer(M, device="cpu")
    assert jc.kp == tc.kp and jc.kp % 8 == 0
    assert np.array_equal(np.asarray(jc.branch_taps_q), tc.branch_taps_q)
    js, ts = jch.PfbSynthesizer(M), tch.PfbSynthesizer(M, device="cpu")
    assert js.kp == ts.kp
    assert np.array_equal(np.asarray(js.branch_taps), ts.branch_taps)


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("route", ["pair", "complex"])
def test_channelizer_streamed(rng, M, route):
    """Two blocks of 300 channel samples, lead shape (2,). IqPair input
    (the fused route, K5) against the JAX jnp route (its CPU path);
    complex input (K4, then an FFT) against the JAX complex (FFT) path."""
    x = _iq(rng, (2, 2 * 300 * M))
    blocks = np.split(x, 2, axis=-1)
    if route == "pair":
        blocks = [(b.real.copy(), b.imag.copy()) for b in blocks]
    kernel_paths.reset()
    tc = tch.PfbChannelizer(M, lead_shape=(2,), device="cpu")
    stream_both(jch.PfbChannelizer(M, lead_shape=(2,)), tc, blocks,
                rtol=TOL, atol=0, state_rtol=0, state_atol=0, peak=True)
    op = (cuda_pfb.route(M, tc.kp) if route == "pair"
          else cuda_depthwise.route(tc.kp))
    assert kernel_paths.report()[op]["plain"] == 2


@pytest.mark.parametrize("M", [8, 10, 13, 64])
def test_pfb_dft_tables_factor_the_dft(rng, M):
    """The kernel's two DFT stages, done in numpy from pfb_tables' flat
    table exactly as csrc/pfb.cu indexes it, give the dense inverse DFT
    of the columns in polyphase order (M = 13: M1 = 1, one dense stage;
    M = 10: 2 x 5, padded k axes)."""
    M1, M2 = dft_factors(M)
    assert M1 * M2 == M and M1 * M1 <= M
    MP1, MP2 = -(-M1 // 8) * 8, -(-M2 // 8) * 8
    _, dft = pfb_tables(np.ones((M, 3), np.float32))
    na, nb = M1 * M2 * MP2, M1 * MP1
    assert dft.dtype == np.float32 and dft.shape == (2 * (na + nb),)
    a = (dft[:na] + 1j * dft[na:2 * na]).reshape(M1, M2, MP2)
    bt = (dft[2 * na:2 * na + nb] + 1j * dft[2 * na + nb:]).reshape(M1, MP1)
    v = _iq(rng, (5, M)).astype(np.complex128)      # columns c
    vp = v[:, (-np.arange(M)) % M]                  # polyphase order p
    z = np.einsum("qrk,tqr->tkq", a[..., :M2], vp.reshape(5, M2, M1)
                  .transpose(0, 2, 1))              # z[t, k2, p1]
    y = np.einsum("qj,tkq->tjk", bt[:, :M1], z).reshape(5, M)  # k2 + M2 k1
    want = np.fft.ifft(vp, axis=-1) * M
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * M)


def test_channelizer_state_from_jax(rng):
    """A raw-history state written by the JAX channelizer continues the
    stream in the port (the state layout, kp rounded to 8, is shared)."""
    M = 64
    x = _iq(rng, 2 * 200 * M)
    jc = jch.PfbChannelizer(M)
    js, _ = jc(jc.init_state(), jnp.asarray(x[: 200 * M]))
    js2, jy = jc(js, jnp.asarray(x[200 * M:]))
    tc = tch.PfbChannelizer(M, device="cpu")
    ts2, ty = tc(torch.from_numpy(np.asarray(js).copy()),
                 torch.from_numpy(x[200 * M:].copy()))
    assert_same(jy, ty, TOL, 0, peak=True)
    assert_same(js2, ts2, 0, 0)


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("pair", [True, False])
def test_synthesizer_streamed(rng, M, pair):
    """Two blocks of 300 samples a channel; at M = 64 the synthesizer's
    kp is 23 (not rounded) and its state (2, 64, 22)."""
    s = _iq(rng, (M, 600))
    blocks = np.split(s, 2, axis=-1)
    if pair:
        blocks = [(b.real.copy(), b.imag.copy()) for b in blocks]
    syn = tch.PfbSynthesizer(M, device="cpu")
    if M == 64:
        assert syn.kp == 23 and tuple(syn.init_state().shape) == (2, 64, 22)
    stream_both(jch.PfbSynthesizer(M), syn, blocks, rtol=TOL, atol=0,
                peak=True)


def test_round_trip_recovers_channels(rng):
    """Synthesize three tones into channels 0, 3, 6 of 8, channelize back
    from IqPair planes: the same three channels carry power."""
    M, Tm = 8, 4096
    t = np.arange(Tm) / 24_000.0
    s = np.zeros((M, Tm), np.complex64)
    for i, k in enumerate((0, 3, 6)):
        s[k] = np.exp(2j * np.pi * (300.0 + 200.0 * i) * t)
    syn = tch.PfbSynthesizer(M, device="cpu")
    _, y = syn(syn.init_state(), torch.from_numpy(s))
    ch = tch.PfbChannelizer(M, device="cpu")
    _, r = ch(ch.init_state(), IqPair(y.real.contiguous(),
                                      y.imag.contiguous()))
    p = (r.re[:, 1024:] ** 2 + r.im[:, 1024:] ** 2).mean(-1).numpy()
    assert (p[[0, 3, 6]] > 0.3).all() and (np.delete(p, [0, 3, 6])
                                           < 0.02).all()


@pytest.mark.parametrize("kp", [24, 23])
def test_plain_depthwise_matches_pallas(pallas_interp, rng, kp):
    """The port's plain K4 against the JAX Pallas depthwise kernel on the
    channelizer's (kp 24) and the synthesizer's (kp 23) taps at M = 64."""
    M = 64
    taps = (tch.PfbChannelizer(M, device="cpu").branch_taps_q if kp == 24
            else tch.PfbSynthesizer(M, device="cpu").branch_taps)
    assert taps.shape == (M, kp)
    Tc = 4400
    xs = [rng.standard_normal((M, Tc)).astype(np.float32) for _ in range(2)]
    res = pf.depthwise_fir(tuple(jnp.asarray(x) for x in xs), taps,
                           Tc - kp + 1)
    assert res is not None, "the Pallas depthwise kernel did not run"
    want, n_main = res
    tf = torch.from_numpy(np.ascontiguousarray(taps[:, ::-1]))
    kernel_paths.reset()
    got = depthwise_fir(tuple(torch.from_numpy(x) for x in xs), tf, n_main)
    assert kernel_paths.report()[cuda_depthwise.route(kp)]["plain"] == 1
    for w, g in zip(want, got):
        assert_same(w, g, TOL, 0, peak=True)
    # and a direct per-row convolution
    ref = np.stack([np.convolve(xs[0][c], taps[c], "valid")[:n_main]
                    for c in range(M)])
    assert_same(ref.astype(np.float32), got[0], TOL, 0, peak=True)


def test_plain_depthwise_lead_axes(rng):
    """Leading axes reuse the (C, kp) taps on every (C, Tc) slab."""
    taps = rng.standard_normal((4, 5)).astype(np.float32)
    x = rng.standard_normal((3, 4, 50)).astype(np.float32)
    (y,) = depthwise_fir_plain((torch.from_numpy(x),),
                               torch.from_numpy(taps[:, ::-1].copy()), 46)
    ref = np.stack([[np.convolve(x[b, c], taps[c], "valid")
                     for c in range(4)] for b in range(3)])
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_channelize_matches_pallas(pallas_interp, rng):
    """The port's plain K5 against the JAX fused Pallas kernel at
    (M, B, Tm) = (64, 1, 600), over two chained blocks so that the carried
    raw history feeds the second block's first rows."""
    M, B, Tm = 64, 1, 600
    jc = jch.PfbChannelizer(M, lead_shape=(B,))
    kp = jc.kp
    ct, dft = (torch.from_numpy(a) for a in pfb_tables(
        np.asarray(jc.branch_taps_q)))
    hist = np.zeros((B, 2, kp * M), np.float32)
    for blk in range(2):
        x = _iq(rng, (B, Tm * M))
        xs = (x.real.copy(), x.imag.copy())
        assert pp.plan(B, Tm, M, kp) is not None
        (wr, wi), n_main = pp.channelize(
            tuple(jnp.asarray(a) for a in xs), jnp.asarray(hist),
            jc.branch_taps_q, M, kp)
        kernel_paths.reset()
        yr, yi = channelize(tuple(torch.from_numpy(a) for a in xs),
                            torch.from_numpy(hist), ct, dft)
        assert kernel_paths.report()[cuda_pfb.route(M, kp)]["plain"] == 1
        want = np.asarray(wr) + 1j * np.asarray(wi)
        got = (yr.numpy() + 1j * yi.numpy())[..., :n_main]
        assert_same(want, got, TOL, 0, peak=True)
        hist = np.concatenate([hist, np.stack(xs, axis=1)],
                              axis=-1)[..., -kp * M:]


# pfb_fft_f32's tiling (csrc/pfb_fft.cu: kTT, kStages, Shape<M, KP>), which
# run_model and fir_jobs follow; test_models_follow_the_kernel_source reads
# them from the source. FFT_TILING: (M, kp) -> (TT rows a tile, FR rows a
# FIR job, NT threads); every other instance takes FFT_TILING[None]
FFT_TT, FFT_STAGES = 32, 2
FFT_TILING = {None: (FFT_TT, 16, 256), (10, 56): (128, 8, 320)}
FFT_SRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
           / "csrc" / "pfb_fft.cu")
# Bfly<5>'s constants: cos and sin of 2 pi/5 and 4 pi/5, rounded once to f32
C5 = {"c1": np.cos(2 * np.pi / 5), "s1": np.sin(2 * np.pi / 5),
      "c2": np.cos(4 * np.pi / 5), "s2": np.sin(4 * np.pi / 5)}


def fft_tiling(M, kp):
    """(TT, FR, NT) of pfb_fft_f32's instance at (M, kp)."""
    return FFT_TILING.get((M, kp), FFT_TILING[None])


def fir_jobs(M, kp):
    """pfb_fft_f32's column-FIR jobs, as the kernel maps them: an (NJOB, 3)
    array of (plane, column, chunk) by thread, column fastest, then chunk,
    then plane."""
    TT, FR, _ = fft_tiling(M, kp)
    nch = TT // FR
    return np.array([(t // (M * nch), t % M, t // M % nch)
                     for t in range(2 * M * nch)])


def _bfly(r, i):
    """csrc/pfb_fft.cu's Bfly<R> on lists of R f32 arrays (re, im): the
    inverse DFT X[k] = sum_n x[n] exp(+2 pi i k n / R), R in 2, 4, 5, 8."""
    if len(r) == 5:
        c1, s1, c2, s2 = (np.float32(C5[k]) for k in ("c1", "s1", "c2", "s2"))
        a1r, a1i, b1r, b1i = r[1] + r[4], i[1] + i[4], r[1] - r[4], i[1] - i[4]
        a2r, a2i, b2r, b2i = r[2] + r[3], i[2] + i[3], r[2] - r[3], i[2] - i[3]
        u1r, u1i = r[0] + c1 * a1r + c2 * a2r, i[0] + c1 * a1i + c2 * a2i
        u2r, u2i = r[0] + c2 * a1r + c1 * a2r, i[0] + c2 * a1i + c1 * a2i
        t1r, t1i = s1 * b1r + s2 * b2r, s1 * b1i + s2 * b2i
        t2r, t2i = s2 * b1r - s1 * b2r, s2 * b1i - s1 * b2i
        return ([r[0] + a1r + a2r, u1r - t1i, u2r - t2i, u2r + t2i,
                 u1r + t1i],
                [i[0] + a1i + a2i, u1i + t1r, u2i + t2r, u2i - t2r,
                 u1i - t1r])
    if len(r) == 2:
        return [r[0] + r[1], r[0] - r[1]], [i[0] + i[1], i[0] - i[1]]
    if len(r) == 4:
        s0r, s0i, d0r, d0i = r[0] + r[2], i[0] + i[2], r[0] - r[2], i[0] - i[2]
        s1r, s1i, d1r, d1i = r[1] + r[3], i[1] + i[3], r[1] - r[3], i[1] - i[3]
        return ([s0r + s1r, d0r - d1i, s0r - s1r, d0r + d1i],
                [s0i + s1i, d0i + d1r, s0i - s1i, d0i - d1r])
    h = np.float32(0.70710678118654752440)
    er, ei = _bfly(r[0::2], i[0::2])
    o_r, oi = _bfly(r[1::2], i[1::2])
    a, b = o_r[1], oi[1]
    o_r[1], oi[1] = (a - b) * h, (a + b) * h
    o_r[2], oi[2] = -oi[2], o_r[2]
    a, b = o_r[3], oi[3]
    o_r[3], oi[3] = -(a + b) * h, (a - b) * h
    return ([er[k] + o_r[k] for k in range(4)] + [er[k] - o_r[k]
                                                 for k in range(4)],
            [ei[k] + oi[k] for k in range(4)] + [ei[k] - oi[k]
                                                 for k in range(4)])


def fft_model(vr, vi, tw):
    """pfb_fft_f32's two butterfly stages in f32 over rows of M columns in
    polyphase order, (..., M) each plane: stage 1 takes slots p1 + R1 p2
    into the radix-R2 butterfly, multiplies by tw[p1][k2] (the flat
    [Re | Im] table, laid out [p1][k2]) and writes z[k2][p1] to slot
    p1 + R1 k2; stage 2 takes slots p1 + R1 k2 into the radix-R1
    butterfly and gives channel k2 + R2 k1."""
    M = vr.shape[-1]
    R1, R2 = cuda_pfb.FFT_RADICES[M]
    zr, zi = vr.copy(), vi.copy()
    for p1 in range(R1):
        ar, ai = _bfly([zr[..., p1 + R1 * q] for q in range(R2)],
                       [zi[..., p1 + R1 * q] for q in range(R2)])
        for k2 in range(R2):
            wr, wi = tw[p1 * R2 + k2], tw[M + p1 * R2 + k2]
            zr[..., p1 + R1 * k2] = ar[k2] * wr - ai[k2] * wi
            zi[..., p1 + R1 * k2] = ar[k2] * wi + ai[k2] * wr
    yr, yi = np.empty_like(vr), np.empty_like(vi)
    for k2 in range(R2):
        br, bi = _bfly([zr[..., p1 + R1 * k2] for p1 in range(R1)],
                       [zi[..., p1 + R1 * k2] for p1 in range(R1)])
        for k1 in range(R1):
            yr[..., k2 + R2 * k1], yi[..., k2 + R2 * k1] = br[k1], bi[k1]
    return yr, yi


@pytest.mark.parametrize("M", [8, 16, 32, 64, 10])
def test_fft_model_is_the_inverse_dft(rng, M):
    """The kernel's butterflies and twiddle table give the unscaled inverse
    DFT of the columns in polyphase order."""
    tw = fft_table(M)
    assert tw.dtype == np.float32 and tw.shape == (2 * M,)
    vp = _iq(rng, (7, M))
    yr, yi = fft_model(vp.real.copy(), vp.imag.copy(), tw)
    want = np.fft.ifft(vp.astype(np.complex128), axis=-1) * M
    np.testing.assert_allclose(yr + 1j * yi, want, rtol=0, atol=1e-5 * M)


def run_model(xr, xi, hist, ct, tw, runs):
    """pfb_fft_f32's schedule in numpy: stream b's tiles of TT rows (the
    instance's, fft_tiling) cut into `runs` contiguous runs; each run walks
    a ring of FFT_STAGES stages of [kp halo rows | TT rows], its first
    tile's halo staged from the input (the history for t < 0), every later
    halo copied from stage rows [TT, TT + kp) of the tile before; rows past
    Tm are never staged (the stages start as NaN, so a row read before it
    is written shows). The column FIR runs job by job as fir_jobs maps
    them, each summing taps kp .. 0 over its FR rows as the kernel does
    (asserting every (plane, column, row) is written once), then
    fft_model. xr, xi: (B, Tm*M); hist (B, 2, kp*M). Returns (y_re, y_im),
    (B, M, Tm), and asserts that every output was written once."""
    kp1, M = ct.shape
    kp = kp1 - 1
    TT, FR = fft_tiling(M, kp)[:2]
    jobs = fir_jobs(M, kp)
    B, Tm = xr.shape[0], xr.shape[1] // M
    tiles = -(-Tm // TT)
    runs = min(runs, tiles)
    y = np.full((2, B, M, Tm), np.nan, np.float32)
    order = (-np.arange(M)) % M
    for b in range(B):
        x = np.stack([xr[b], xi[b]]).reshape(2, Tm, M)
        h = hist[b].reshape(2, kp, M)
        for r in range(runs):
            g0, g1 = r * tiles // runs, (r + 1) * tiles // runs
            ring = np.full((FFT_STAGES, 2, kp + TT, M), np.nan, np.float32)
            for j in range(g1 - g0):
                t0 = (g0 + j) * TT
                st = ring[j % FFT_STAGES]
                if j == 0:
                    for t in range(t0 - kp, t0):
                        st[:, kp + t - t0] = h[:, kp + t] if t < 0 else x[:, t]
                hi = min(t0 + TT, Tm)
                st[:, kp:kp + hi - t0] = x[:, t0:hi]
                if j + 1 < g1 - g0:
                    ring[(j + 1) % FFT_STAGES][:, :kp] = st[:, TT:TT + kp]
                v = np.full((2, TT, M), np.nan, np.float32)
                for p, c, ch in jobs:
                    rows = slice(ch * FR, ch * FR + FR)
                    assert np.isnan(v[p, rows, c]).all()
                    acc = np.zeros(FR, np.float32)
                    for l in range(kp, -1, -1):
                        acc = acc + ct[l, c] * st[p, kp - l + ch * FR:
                                                  kp - l + ch * FR + FR, c]
                    v[p, rows, c] = acc
                yr, yi = fft_model(v[0][:, order], v[1][:, order], tw)
                assert np.isnan(y[:, b, :, t0:hi]).all()
                y[0, b, :, t0:hi] = yr[:hi - t0].T
                y[1, b, :, t0:hi] = yi[:hi - t0].T
    assert not np.isnan(y).any()
    return y[0], y[1]


@pytest.mark.parametrize("M,B", [(8, 1), (8, 3), (64, 1), (64, 3)])
def test_run_model_matches_plain(rng, M, B):
    """Two chained blocks of Tm = 229 rows (7 full tiles and a ragged one of
    5) cut into 1, 3 (2 + 3 + 3 tiles) and 8 runs (a halo from global memory
    at every tile), within 1e-5 of the plain version's peak."""
    _run_model_case(rng, tch.PfbChannelizer(M, lead_shape=(B,),
                                            device="cpu"), M, B)


def _mmdvm_taps():
    from qradiolink_tpu_torch.chains import mmdvm
    return mmdvm._lp(1.0, mmdvm.DEVICE_RATE, mmdvm.FILTER_WIDTH)


@pytest.mark.parametrize("B", [1, 3])
def test_run_model_at_mmdvm_multi_shape(rng, B):
    """MMDVMmulti's channelizer (M 10, kp 56): its instance's tiles of 128
    rows, FIR jobs of 8 rows laid out as fir_jobs maps them, the halo of 56
    rows copied stage to stage; two chained blocks of Tm = 421 rows (3 full
    tiles and a ragged one of 37) in 1, 3 and 8 runs, within 1e-5 of the
    plain version's peak."""
    ch = tch.PfbChannelizer(10, taps=_mmdvm_taps(), lead_shape=(B,),
                            device="cpu")
    assert (ch.kp, fft_tiling(10, ch.kp)[0]) == (56, 128)
    _run_model_case(rng, ch, 10, B, Tm=421)


def _run_model_case(rng, ch, M, B, Tm=229):
    ct, tw = ch._ct.numpy(), fft_table(M)
    assert cuda_pfb.route(M, ch.kp) == cuda_pfb.FFT_OP
    hist = rng.standard_normal((B, 2, ch.kp * M)).astype(np.float32)
    for _ in range(2):
        x = _iq(rng, (B, Tm * M))
        xr, xi = x.real.copy(), x.imag.copy()
        want = channelize_plain((torch.from_numpy(xr), torch.from_numpy(xi)),
                                torch.from_numpy(hist), ch._ct)
        for runs in (1, 3, 8):
            got = run_model(xr, xi, hist, ct, tw, runs)
            for g, w in zip(got, want):
                assert_same(w.numpy(), g, TOL, 0, peak=True)
        hist = np.concatenate([hist, np.stack([xr, xi], 1)], -1)[
            ..., -ch.kp * M:]


def test_models_follow_the_kernel_source():
    """run_model's tiling, fir_jobs' layout, fft_model's radices and
    radix-5 constants, and the route's instances are the kernel's."""
    src = FFT_SRC.read_text()
    assert f"constexpr int kTT = {FFT_TT};" in src
    assert f"constexpr int kStages = {FFT_STAGES};" in src
    for M, (R1, R2) in cuda_pfb.FFT_RADICES.items():
        assert re.search(rf"struct Radix<{M}> +\{{ static constexpr int "
                         rf"R1 = {R1}, R2 = {R2}; \}};", src), M
    for kp in cuda_pfb.FFT_KP:
        assert f"case {kp}: return launch<M, {kp}>;" in src
        assert kp <= FFT_TT
    shapes = re.findall(r"struct Shape(<\d+, \d+>)? \{\s*static constexpr int "
                        r"TT = (\w+), FR = (\w+), NT = (\d+);", src)
    got = {}
    for inst, tt, fr, nt in shapes:
        key = tuple(map(int, re.findall(r"\d+", inst))) or None
        got[key] = (FFT_TT if tt == "kTT" else int(tt),
                    16 if fr == "kRows" else int(fr), int(nt))
    assert "constexpr int kRows = 16;" in src
    assert got == FFT_TILING
    extra = {(M, kp) for M, kp in cuda_pfb.FFT_SHAPES
             if M not in (8, 16, 32, 64)}
    assert extra == {k for k in FFT_TILING if k}
    for M, kp in extra:
        assert f"case {M}: return kp == {kp} ? launch<{M}, {kp}> : " \
               f"nullptr;" in src
    for k, v in C5.items():
        lit = re.search(rf"constexpr float {k} = (-?[0-9.]+)f;", src)
        assert np.float32(float(lit.group(1))) == np.float32(v), k


@pytest.mark.parametrize("M,kp", [(8, 24), (16, 32), (64, 24), (10, 56)])
def test_fir_jobs_cover_each_column_once(M, kp):
    """Every (plane, column, chunk) of a tile is one thread's job, within
    the block's threads."""
    TT, FR, NT = fft_tiling(M, kp)[:3]
    jobs = fir_jobs(M, kp)
    assert len(jobs) <= NT
    assert sorted(map(tuple, jobs)) == [(p, c, ch) for p in range(2)
                                        for c in range(M)
                                        for ch in range(TT // FR)]


@pytest.mark.parametrize("M,kp,op", [
    (64, 24, "pfb_fft_f32"), (16, 32, "pfb_fft_f32"),
    (8, 24, "pfb_fft_f32"), (16, 8, "pfb_fft_f32"), (32, 32, "pfb_fft_f32"),
    (10, 56, "pfb_fft_f32"), (10, 48, "pfb_channelize_f32"),
    (10, 24, "pfb_channelize_f32"), (13, 24, "pfb_channelize_f32"),
    (12, 24, "pfb_channelize_f32"), (128, 24, "pfb_channelize_f32"),
    (64, 40, "pfb_channelize_f32"), (64, 12, "pfb_channelize_f32")])
def test_pfb_route(M, kp, op):
    assert cuda_pfb.route(M, kp) == op


@pytest.mark.parametrize("M", [8, 10, 13, 16, 32, 64])
def test_channelizer_route_recorded_on_cpu(rng, M):
    """A CPU IqPair call records the plain path under the routed kernel's
    name (and only there)."""
    ch = tch.PfbChannelizer(M, device="cpu")
    x = _iq(rng, 40 * M)
    kernel_paths.reset()
    ch(ch.init_state(), IqPair(torch.from_numpy(x.real.copy()),
                               torch.from_numpy(x.imag.copy())))
    op = cuda_pfb.route(M, ch.kp)
    assert kernel_paths.report() == {op: {
        "cuda": 0, "plain": 1, "shapes": {f"plain M{M} kp24": 1}}}
    assert op == ("pfb_fft_f32" if M in (8, 16, 32, 64)
                  else "pfb_channelize_f32")


RUN_SRC = FFT_SRC.with_name("depthwise_run.cu")
# depthwise_run_f32's block: threads, outputs a thread at once, groups of
# them a tile, ring stages
RUN_THREADS, RUN_R, RUN_SUB, RUN_STAGES = 128, 4, 4, 2
RUN_TT = RUN_THREADS * RUN_R * RUN_SUB


def _stage_body(st, body, m0, n, mis, hb):
    """stage_body: body samples [m0, m0 + n) to stage words hb + mis + i;
    16-byte chunks (words hb + 4c .. hb + 4c + 3, samples 4c - mis ..) that
    lie in [0, n) whole are copied whole, the others sample by sample."""
    for c in range((mis + n + 3) // 4):
        i = 4 * c - mis
        if i >= 0 and i + 4 <= n:
            st[hb + 4 * c:hb + 4 * c + 4] = body[m0 + i:m0 + i + 4]
        else:
            for k in range(4):
                if 0 <= i + k < n:
                    st[hb + 4 * c + k] = body[m0 + i + k]


def dw_run_model(xs, tf, out_len, tails, runs, offsets):
    """depthwise_run_f32's schedule in numpy. Row r of plane p is
    xc = [halo | body]: the tail and x (tail form) or x[:kp-1] and
    x[kp-1:] (VALID form); offsets[p][r] is its body's float offset in
    memory, whose value mod 4 (mis) places the body in the stage. The
    row's outputs are cut into `runs` runs that start at multiples of 4;
    each walks a ring of RUN_STAGES stages of [halo room | RUN_TT samples]
    (NaN until written), its first tile's halo from the tail or the body
    before the run, every later halo copied from the last kp-1 samples of
    the tile before. Thread t reads its window of kp+3 samples as aligned
    float4s from word hb + mis - (kp-1) - OFF + i0 and sums tap s - o into
    output o. xs, tails: (rows, n) and (rows, kp-1) f32 planes; tf (C, kp)
    flipped. Returns (planes, rows, out_len), asserting that every output
    is written once."""
    C, kp = tf.shape
    rows = xs[0].shape[0]
    hb = (kp - 1 + 3) & ~3
    sw = hb + RUN_TT + 8
    y = np.full((len(xs), rows, out_len), np.nan, np.float32)
    n4 = -(-out_len // 4)
    for p, x in enumerate(xs):
        for r in range(rows):
            halo = x[r, :kp - 1] if tails is None else tails[p][r]
            body = x[r, kp - 1:] if tails is None else x[r]
            taps = tf[r % C].astype(np.float64)
            mis = offsets[p][r] % 4
            off = (mis + 1 - kp) % 4
            nv = (off + kp + RUN_R - 1 + 3) // 4
            for run in range(runs):
                s = run * n4 // runs * 4
                e = min((run + 1) * n4 // runs * 4, out_len)
                if s >= e:
                    continue
                ring = np.full((RUN_STAGES, sw), np.nan, np.float32)
                for h in range(kp - 1):
                    g = s - (kp - 1) + h
                    ring[0, hb + mis - (kp - 1) + h] = \
                        body[g] if g >= 0 else halo[kp - 1 + g]
                _stage_body(ring[0], body, s, min(RUN_TT, e - s), mis, hb)
                n_tiles = -(-(e - s) // RUN_TT)
                for k in range(n_tiles):
                    m0 = s + k * RUN_TT
                    n = min(RUN_TT, e - m0)
                    cur = ring[k % RUN_STAGES]
                    if k + 1 < n_tiles:
                        nxt = ring[(k + 1) % RUN_STAGES]
                        _stage_body(nxt, body, m0 + RUN_TT,
                                    min(RUN_TT, e - m0 - RUN_TT), mis, hb)
                        a = hb + mis - (kp - 1)
                        nxt[a:a + kp - 1] = cur[a + RUN_TT:a + RUN_TT
                                                + kp - 1]
                    for u in range(RUN_SUB):
                        i0 = u * RUN_THREADS * RUN_R + \
                            RUN_R * np.arange(RUN_THREADS)
                        i0 = i0[i0 < n]
                        if not i0.size:
                            break
                        a = hb + mis - (kp - 1) - off + i0
                        assert (a % 4 == 0).all() and a.min() >= 0
                        assert a.max() + 4 * nv <= sw
                        win = cur[a[:, None] + np.arange(4 * nv)].astype(
                            np.float64)
                        for o in range(RUN_R):
                            acc = win[:, off + o:off + o + kp] @ taps
                            pos = i0 + o
                            ok = pos < n
                            assert np.isnan(y[p, r, m0 + pos[ok]]).all()
                            y[p, r, m0 + pos[ok]] = acc[ok]
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize("runs", [1, 3, 5])
@pytest.mark.parametrize("form", ["tail", "valid"])
def test_dw_run_model_matches_plain(rng, form, runs):
    """The synthesizer's taps (kp 23) in the tail form over two chained
    blocks, the channelizer's (kp 24) in the VALID form, 3 rows x 2 planes
    of 2 tiles and a ragged one (4,133 outputs), cut into 1, 3 and 5 runs
    (boundaries inside tiles); the rows' bodies at every offset mod 4.
    Within 1e-5 of depthwise_fir_plain's peak."""
    M, n_out = 3, 2 * RUN_TT + 37
    if form == "tail":
        tf = tch.PfbSynthesizer(64, device="cpu")._bt_flipped[:M].numpy()
    else:
        tf = tch.PfbChannelizer(64, device="cpu")._btq_flipped[:M].numpy()
    kp = tf.shape[1]
    assert cuda_depthwise.route(kp) == cuda_depthwise.RUN_OP
    st = rng.standard_normal((2, M, kp - 1)).astype(np.float32)
    for _ in range(2 if form == "tail" else 1):
        n_in = n_out if form == "tail" else n_out + kp - 1 + 1
        xs = [rng.standard_normal((M, n_in)).astype(np.float32)
              for _ in range(2)]
        tails = None if form == "valid" else [st[0], st[1]]
        # contiguous planes: row r's body at r * n_in (+ kp - 1, VALID)
        offsets = [[p * M * n_in + r * n_in + (kp - 1 if form == "valid"
                                               else 0) for r in range(M)]
                   for p in range(2)]
        assert {o % 4 for o in offsets[0]} | {o % 4 for o in offsets[1]} \
            == {0, 1, 2, 3} or form == "tail"
        got = dw_run_model(xs, tf, n_out, tails, runs, offsets)
        want = depthwise_fir_plain(
            tuple(torch.from_numpy(x) for x in xs), torch.from_numpy(tf),
            n_out, None if tails is None else tuple(
                torch.from_numpy(t) for t in tails))
        for g, w in zip(got, want):
            assert_same(w.numpy(), g, TOL, 0, peak=True)
        if tails is not None:
            st = np.stack([np.concatenate([t, x], -1)[:, -(kp - 1):]
                           for t, x in zip(tails, xs)])


@pytest.mark.parametrize("runs", [1, 6])
def test_dw_run_model_at_kp53(rng, runs):
    """MMDVMmulti's synthesizer taps (kp 53, 3 of its 10 rows) in the tail
    form over two chained blocks of 2 tiles and a ragged one, in 1 run and
    in 6 (the run count the kernel takes at a short row: runs shorter than
    a tile); within 1e-5 of depthwise_fir_plain's peak."""
    from qradiolink_tpu_torch.chains import mmdvm
    tf = mmdvm.MmdvmMultiTx(device="cpu").synthesizer._bt_flipped[:3]
    tf = tf.numpy()
    M, kp = tf.shape
    n_out = 2 * RUN_TT + 37
    assert kp == 53 and cuda_depthwise.route(kp) == cuda_depthwise.RUN_OP
    st = rng.standard_normal((2, M, kp - 1)).astype(np.float32)
    for _ in range(2):
        xs = [rng.standard_normal((M, n_out)).astype(np.float32)
              for _ in range(2)]
        tails = [st[0], st[1]]
        offsets = [[(p * M + r) * n_out for r in range(M)] for p in range(2)]
        got = dw_run_model(xs, tf, n_out, tails, runs, offsets)
        want = depthwise_fir_plain(
            tuple(torch.from_numpy(x) for x in xs), torch.from_numpy(tf),
            n_out, tuple(torch.from_numpy(t) for t in tails))
        for g, w in zip(got, want):
            assert_same(w.numpy(), g, TOL, 0, peak=True)
        st = np.stack([np.concatenate([t, x], -1)[:, -(kp - 1):]
                       for t, x in zip(tails, xs)])


def test_dw_run_model_follows_the_kernel_source():
    """dw_run_model's block, ring and kp set are the kernel's."""
    src = RUN_SRC.read_text()
    assert f"constexpr int kThreads = {RUN_THREADS};" in src
    assert f"constexpr int kR = {RUN_R};" in src
    assert f"constexpr int kSub = {RUN_SUB};" in src
    assert f"constexpr int kStages = {RUN_STAGES};" in src
    assert "return (KP - 1 + 3) & ~3;" in src
    assert "const int off = (mis + 1 - KP) & 3;" in src
    for kp in cuda_depthwise.RUN_KP:
        assert f"case {kp}: return launch<{kp}>;" in src
    assert len(re.findall(r"case \d+: return launch<", src)) == \
        len(cuda_depthwise.RUN_KP)


@pytest.mark.parametrize("kp,op", [
    (23, "depthwise_run_f32"), (24, "depthwise_run_f32"),
    (53, "depthwise_run_f32"), (52, "depthwise_fir_f32"),
    (1, "depthwise_fir_f32"), (8, "depthwise_fir_f32"),
    (13, "depthwise_fir_f32"), (16, "depthwise_fir_f32"),
    (22, "depthwise_fir_f32"), (25, "depthwise_fir_f32"),
    (32, "depthwise_fir_f32")])
def test_depthwise_route(kp, op):
    assert cuda_depthwise.route(kp) == op


@pytest.mark.parametrize("M", [8, 16, 32, 64, 10])
def test_depthwise_route_recorded_on_cpu(rng, M):
    """With default taps the synthesizer (kp 23, the tail form) and the
    channelizer on complex input (kp 24, the VALID form) record the plain
    path under depthwise_run_f32, with taps of another kp under
    depthwise_fir_f32."""
    s = torch.from_numpy(_iq(rng, (M, 40)))
    syn = tch.PfbSynthesizer(M, device="cpu")
    ch = tch.PfbChannelizer(M, device="cpu")
    kernel_paths.reset()
    syn(syn.init_state(), s)
    ch(ch.init_state(), torch.from_numpy(_iq(rng, 40 * M)))
    assert kernel_paths.report() == {"depthwise_run_f32": {
        "cuda": 0, "plain": 2, "shapes": {f"plain C{M} kp23 tail": 1,
                                          f"plain C{M} kp24": 1}}}
    other = tch.PfbSynthesizer(M, taps=np.ones(M * 16), device="cpu")
    kernel_paths.reset()
    other(other.init_state(), s)
    assert kernel_paths.report() == {"depthwise_fir_f32": {
        "cuda": 0, "plain": 1, "shapes": {f"plain C{M} kp16 tail": 1}}}
