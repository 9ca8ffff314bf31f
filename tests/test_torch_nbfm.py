"""The NBFM receive chain of the port against the JAX package on the CPU:
the IIR scan, emphasis and DC blocker, both squelches, the resampler's
default taps and NbfmDemod, each streamed over two blocks with every
output and state leaf compared (tests/torch_parity.stream_both).

Tolerances: the scan reproduces jax.lax.associative_scan's order of
operations, so the recurrences are held to 1e-6. NbfmDemod's audio passes
through atan2 and six filters whose sums PyTorch and XLA order
differently; it is held to 1e-5 (audio peaks near 2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.chains.nbfm import NbfmDemod as JaxNbfm  # noqa: E402
from qradiolink_tpu.ops import analog as janalog  # noqa: E402
from qradiolink_tpu.ops import iir as jiir  # noqa: E402
from qradiolink_tpu.ops import resample as jresample  # noqa: E402
from qradiolink_tpu.ops import squelch as jsquelch  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod  # noqa: E402
from qradiolink_tpu_torch.ops import analog, iir, resample, squelch  # noqa
from tests.torch_parity import (  # noqa: E402
    assert_same, stream_both, to_torch)

FS_AUDIO = 8_000
CTCSS_HZ = 123.0


def _fm_iq(rng, n_ch, T, ctcss_on=None):
    """Seeded 1 Msps NBFM IQ: a 1 kHz tone at 2.5 kHz deviation, plus a
    0.15 CTCSS tone where ctcss_on (a (T,) bool mask) holds, plus noise."""
    t = np.arange(T) / 1e6
    m = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    if ctcss_on is not None:
        m = m + 0.15 * np.cos(2 * np.pi * CTCSS_HZ * t) * ctcss_on
    ph = np.cumsum(2 * np.pi * 2500.0 * m / 1e6)
    x = np.exp(1j * (ph[None, :] + rng.uniform(0, 2 * np.pi, (n_ch, 1))))
    x = x + 0.05 * (rng.standard_normal((n_ch, T))
                    + 1j * rng.standard_normal((n_ch, T)))
    return x.astype(np.complex64)


def _pair_blocks(x, n):
    return [(c.real.copy(), c.imag.copy()) for c in np.split(x, n, axis=-1)]


# every scan here runs over (3, 800) or short rows, so the JAX side
# compiles each of its scan's operations once for the whole file
@pytest.mark.parametrize("T,per_sample_a", [(1, False), (2, True),
                                            (5, False), (800, False),
                                            (800, True)])
def test_linear_recurrence_matches_jax(rng, T, per_sample_a):
    u = rng.standard_normal((3, T)).astype(np.float32)
    y0 = rng.standard_normal(3).astype(np.float32)
    if per_sample_a:
        a = rng.uniform(0.5, 1.0, (3, T)).astype(np.float32)
        a_t = torch.from_numpy(a)
    else:
        a = np.float32(0.999)
        a_t = 0.999
    want = jiir.linear_recurrence(jnp.asarray(a), jnp.asarray(u),
                                  jnp.asarray(y0))
    got = iir.linear_recurrence(a_t, torch.from_numpy(u),
                                torch.from_numpy(y0))
    assert_same(want, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["first_order", "single_pole", "deemph",
                                  "preemph", "dc_blocker"])
def test_iir_blocks_streamed(rng, name):
    ls = (3,)
    if name == "first_order":
        pair = (jiir.FirstOrderIir(0.3, -0.2, 0.95, lead_shape=ls),
                iir.FirstOrderIir(0.3, -0.2, 0.95, lead_shape=ls,
                                  device="cpu"))
    elif name == "single_pole":
        pair = (jiir.SinglePoleIir(0.01, lead_shape=ls),
                iir.SinglePoleIir(0.01, lead_shape=ls, device="cpu"))
    elif name in ("deemph", "preemph"):
        mode = name[:-5]
        pair = (janalog.Emphasis(FS_AUDIO, mode=mode, lead_shape=ls),
                analog.Emphasis(FS_AUDIO, mode=mode, lead_shape=ls,
                                device="cpu"))
    else:
        pair = (janalog.DcBlocker(lead_shape=ls),
                analog.DcBlocker(lead_shape=ls, device="cpu"))
    x = rng.standard_normal((3, 1600)).astype(np.float32) + 0.5
    stream_both(*pair, np.split(x, 2, axis=-1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("emph", ["de", "pre"])
def test_emphasis_taps_identical(emph):
    fn = "fm_deemph_taps" if emph == "de" else "fm_preemph_taps"
    (b_j, a_j), (b_t, a_t) = (getattr(m, fn)(FS_AUDIO)
                              for m in (janalog, analog))
    assert np.array_equal(b_j, b_t) and a_j == a_t


@pytest.mark.parametrize("kind", ["pair", "complex", "real"])
def test_power_squelch_opens_and_closes(rng, kind):
    """The power steps between loud and quiet every 200 samples, so the
    gate opens and closes within each block and the state carries an
    envelope that is mid-ramp."""
    T = 800
    amp = np.where((np.arange(2 * T) // 200) % 2 == 0, 1.0, 0.01)
    x = (rng.standard_normal((3, 2 * T)) + 1j * rng.standard_normal(
        (3, 2 * T))) * amp / np.sqrt(2)
    x = x.astype(np.complex64)
    ls = (3,)
    blocks = np.split(x, 2, axis=-1)
    if kind == "pair":
        blocks = [(b.real.copy(), b.imag.copy()) for b in blocks]
    elif kind == "real":
        blocks = [b.real.copy() for b in blocks]
    jsq = jsquelch.PowerSquelch(-6.0, alpha=0.01, ramp=320, lead_shape=ls)
    tsq = squelch.PowerSquelch(-6.0, alpha=0.01, ramp=320, lead_shape=ls,
                               device="cpu")
    stream_both(jsq, tsq, blocks, rtol=1e-6, atol=1e-6)
    # the gate both opened and closed inside the first block
    p = np.abs(x[..., :T]) ** 2
    avg = np.asarray(jiir.linear_recurrence(
        jnp.float32(0.99), jnp.asarray(0.01 * p, jnp.float32),
        jnp.zeros(3, jnp.float32)))
    gate = avg >= 10.0 ** -0.6
    assert (np.diff(gate.astype(int), axis=-1) == 1).any()
    assert (np.diff(gate.astype(int), axis=-1) == -1).any()


def test_ctcss_squelch_streamed(rng):
    """Tone present in some 400-sample windows only, so the held gate
    switches inside each block."""
    T = 4000
    t = np.arange(2 * T) / FS_AUDIO
    on = (np.arange(2 * T) // 1200) % 2 == 0
    x = (0.3 * np.sin(2 * np.pi * 700.0 * t)
         + 0.3 * np.cos(2 * np.pi * CTCSS_HZ * t) * on)
    x = (x[None, :] + 0.01 * rng.standard_normal((2, 2 * T))).astype(
        np.float32)
    jsq = jsquelch.CtcssSquelch(FS_AUDIO, CTCSS_HZ, lead_shape=(2,))
    tsq = squelch.CtcssSquelch(FS_AUDIO, CTCSS_HZ, lead_shape=(2,),
                               device="cpu")
    stream_both(jsq, tsq, np.split(x, 2, axis=-1), rtol=1e-6, atol=1e-6)
    _, gate = jsq(jsq.init_state(), jnp.asarray(x))
    y = np.asarray(gate).reshape(2, -1, 400)
    assert (y != 0).any() and (y == 0).all(axis=-1).any()


@pytest.mark.parametrize("L,M", [(1, 50), (2, 5), (25, 4), (3, 125)])
def test_resampler_default_taps_bit_equal(L, M):
    a = jresample.design_resampler_taps(L, M)
    b = resample.design_resampler_taps(L, M)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    rs = resample.RationalResampler(L, M, device="cpu")
    jrs = jresample.RationalResampler(L, M)
    assert rs.kp == jrs.kp


def test_resampler_default_taps_streamed(rng):
    """The NBFM audio resampler (2/5, 225 default taps, kp 113) on real
    input, two blocks."""
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    stream_both(jresample.RationalResampler(2, 5, lead_shape=(2,)),
                resample.RationalResampler(2, 5, lead_shape=(2,),
                                           device="cpu"),
                np.split(x, 2, axis=-1))


# rssi is 10 log10 of a mean power: 1e-4 dB is 2.3e-5 of the power, the
# spread of the mean's sum order
NBFM_TOL = {"audio": (1e-5, 1e-5), "rssi": (0, 1e-4)}


def test_nbfm_demod_complex_input_matches_pairs(rng):
    """Complex input at the head gives the IqPair route's outputs. (It is
    held against the port's own IqPair route, not the JAX chain: with
    complex input the JAX chain runs its 133-tap channel LP as an FFT on
    the CPU, whose error is relative to the block's peak, and that
    scrambles the phase of the head's near-zero first samples.)"""
    x = _fm_iq(rng, 2, 2 * 5000)
    d = NbfmDemod(lead_shape=(2,), device="cpu")
    sc, sp = d.init_state(), d.init_state()
    for c in np.split(x, 2, axis=-1):
        sc, yc = d(sc, torch.from_numpy(c.copy()))
        sp, yp = d(sp, to_torch((c.real.copy(), c.imag.copy())))
        for k in ("audio", "rssi"):
            assert_same(yp[k], yc[k], *NBFM_TOL[k], what=k)


@pytest.mark.parametrize("ctcss_hz", [0.0, CTCSS_HZ])
def test_nbfm_demod_streamed(rng, ctcss_hz):
    """Without and with a 123 Hz CTCSS squelch, on a signal that carries
    the tone in the first block only. With the squelch, in the second
    block the first audio window is open (gated by the last window of the
    first block) and the second is shut."""
    T = 100_000  # 800 audio samples: two 400-sample windows a block
    x = _fm_iq(rng, 2, 2 * T, ctcss_on=np.arange(2 * T) < T)
    jd = JaxNbfm(ctcss_hz=ctcss_hz, lead_shape=(2,))
    td = NbfmDemod(ctcss_hz=ctcss_hz, lead_shape=(2,), device="cpu")
    _, (jy, _) = stream_both(jd, td, _pair_blocks(x, 2), key_tol=NBFM_TOL)
    peaks = np.abs(np.asarray(jy["audio"])).reshape(2, 2, 400).max(-1)
    if ctcss_hz:
        assert (peaks[:, 0] > 0.1).all() and (peaks[:, 1] == 0).all()
    else:
        assert (peaks > 0.1).all()
