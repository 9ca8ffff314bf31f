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
from qradiolink_tpu_torch.ops.cuda_pfb import (  # noqa: E402
    channelize, dft_factors, pfb_tables)
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
    stream_both(jch.PfbChannelizer(M, lead_shape=(2,)),
                tch.PfbChannelizer(M, lead_shape=(2,), device="cpu"),
                blocks, rtol=TOL, atol=0, state_rtol=0, state_atol=0,
                peak=True)
    op = "pfb_channelize_f32" if route == "pair" else "depthwise_fir_f32"
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
    assert kernel_paths.report()["depthwise_fir_f32"]["plain"] == 1
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
        assert kernel_paths.report()["pfb_channelize_f32"]["plain"] == 1
        want = np.asarray(wr) + 1j * np.asarray(wi)
        got = (yr.numpy() + 1j * yi.numpy())[..., :n_main]
        assert_same(want, got, TOL, 0, peak=True)
        hist = np.concatenate([hist, np.stack(xs, axis=1)],
                              axis=-1)[..., -kp * M:]
