"""The analog blocks and chains of the port against the JAX package on the
CPU: ComplexToMag, ComplexToReal, Scale, FrequencyMod, PhaseMod, Rotator,
ChannelModel, AmDemod, AmMod, WbfmDemod and NbfmMod, each streamed over
two blocks with every output and state leaf compared
(tests/torch_parity.stream_both); complex64 state leaves through
state_from_numpy / save_state; then torch-only loopbacks.

Tolerances, from the differences measured:
- elementwise ops: 1e-6 (cos and sin differ by an ulp between the two
  frameworks' libraries);
- FrequencyMod: its phase is a cumulative sum, which PyTorch and XLA add
  in different orders, so its error grows with the phase: outputs and the
  carried phase within 1e-6 of the phase's peak over the block (about 8
  f32 ulps; measured up to 3.4e-7);
- AmDemod, WbfmDemod, AmMod: 1e-5 of each output's and state leaf's peak
  (peak=True), rssi within 1e-4 dB; AmMod's 963-tap post-filter runs as an
  FFT on the JAX side (measured 2.3e-6);
- NbfmMod: its IQ is exp(j phase) of a carried cumulative sum (above):
  5e-5 of the peak (measured 1.7e-5, 1.4e-5 with the JAX chain's
  111-tap FFT audio filter swapped for direct form).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.chains import am as jam  # noqa: E402
from qradiolink_tpu.chains import channel as jchannel  # noqa: E402
from qradiolink_tpu.chains import nbfm as jnbfm  # noqa: E402
from qradiolink_tpu.chains import wbfm as jwbfm  # noqa: E402
from qradiolink_tpu.ops import analog as janalog  # noqa: E402
from qradiolink_tpu.ops import rotator as jrotator  # noqa: E402
from qradiolink_tpu_torch import core  # noqa: E402
from qradiolink_tpu_torch.chains import am, nbfm, wbfm  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402
from qradiolink_tpu_torch.ops import analog, rotator  # noqa: E402
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa
from tests.torch_parity import (  # noqa: E402
    assert_outputs_same, assert_same, assert_states_same, stream_both,
    to_jax, to_torch)
from tests.test_chains_analog import tone, tone_snr  # noqa: E402
from tests.test_torch_ssb import loopback  # noqa: E402

CHAIN_TOL = {"audio": (1e-5, 0.0), "rssi": (0.0, 1e-4)}


def _iq(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(
        shape))).astype(np.complex64)


def _pair(x):
    return x.real.copy(), x.imag.copy()


@pytest.mark.parametrize("kind", ["pair", "complex"])
@pytest.mark.parametrize("squared", [False, True])
def test_complex_to_mag(rng, kind, squared):
    """Including ~1e-20 samples, whose squares the reference flushes to
    zero as denormals."""
    x = _iq(rng, (3, 400))
    x[:, :50] *= np.float32(1e-20)
    x = _pair(x) if kind == "pair" else x
    want = janalog.ComplexToMag(squared).apply(to_jax(x))
    got = analog.ComplexToMag(squared).apply(to_torch(x))
    assert_same(want, got, 1e-6, 0.0)
    assert np.all(np.asarray(want)[:, :50] == 0)


def test_complex_to_real_and_scale(rng):
    x = _iq(rng, (3, 100))
    assert_same(janalog.ComplexToReal().apply(to_jax(x)),
                analog.ComplexToReal().apply(to_torch(x)), 0, 0)
    for k in (0.9, 1.333):
        assert_same(janalog.Scale(k).apply(to_jax(x)),
                    analog.Scale(k).apply(to_torch(x)), 0, 0)


@pytest.mark.parametrize("pair_out", [False, True])
@pytest.mark.parametrize("T", [1000, 5000])
def test_frequency_mod_streamed(rng, pair_out, T):
    """Two blocks; outputs and the carried phase within 1e-6 of the
    block's phase peak (state + cumulative sum, computed in float64)."""
    sens = 4 * np.pi * 2500.0 / 50_000.0
    x = rng.standard_normal((3, 2 * T)).astype(np.float32)
    jf = janalog.FrequencyMod(sens, lead_shape=(3,), pair_out=pair_out)
    tf = analog.FrequencyMod(sens, lead_shape=(3,), pair_out=pair_out,
                             device="cpu")
    js, ts = jf.init_state(), tf.init_state()
    for b in np.split(x, 2, axis=-1):
        phase = np.asarray(js, np.float64)[:, None] + np.cumsum(
            b.astype(np.float64) * sens, axis=-1)
        tol = 1e-6 * float(np.abs(phase).max())
        js, jy = jf(js, jnp.asarray(b))
        ts, ty = tf(ts, torch.from_numpy(b.copy()))
        assert_same(jy, ty, 0.0, tol, what="iq")
        assert_same(js, ts, 0.0, tol, what="phase")


def test_phase_mod(rng):
    x = rng.standard_normal((3, 500)).astype(np.float32)
    assert_same(janalog.PhaseMod(1.7).apply(jnp.asarray(x)),
                analog.PhaseMod(1.7).apply(torch.from_numpy(x)), 0, 1e-6)


@pytest.mark.parametrize("kind", ["pair", "complex"])
@pytest.mark.parametrize("T", [1000, 10_000])
def test_rotator_streamed(rng, kind, T):
    """A 12.5 kHz offset at 1 Msps over blocks longer than the 4,096-sample
    coarse step; the carried phase within 1e-6."""
    x = _iq(rng, (2, 2 * T))
    blocks = np.split(x, 2, axis=-1)
    if kind == "pair":
        blocks = [_pair(b) for b in blocks]
    stream_both(jrotator.Rotator.from_offset(12_500.0, 1e6, lead_shape=(2,)),
                rotator.Rotator.from_offset(12_500.0, 1e6, lead_shape=(2,),
                                            device="cpu"),
                blocks, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_channel_model_without_noise(rng, kind):
    """Gain, delay, frequency and phase offset, snr_db=None: the JAX
    channel's output."""
    x = _iq(rng, (2, 3000))
    if kind == "real":
        x = x.real.copy()
    kw = dict(freq_offset_hz=250.0, phase_offset=0.7, gain=0.8,
              delay_samples=17)
    want = jchannel.ChannelModel(1e6, **kw)(jnp.asarray(x))
    got = ChannelModel(1e6, **kw)(torch.from_numpy(x))
    assert_same(want, got, 1e-6, 1e-6)


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 30.0])
def test_channel_model_snr(rng, snr_db):
    """The noise the port adds (its own generator, not jax.random's bits)
    gives the SNR asked for within 0.2 dB; the same seed repeats it."""
    x = _iq(rng, (4, 50_000), 0.3)
    ch = ChannelModel(1e6, snr_db=snr_db, seed=5)
    y = ch(torch.from_numpy(x)).numpy()
    n = y - x
    snr = 10 * np.log10(np.mean(np.abs(x) ** 2) / np.mean(np.abs(n) ** 2))
    assert abs(snr - snr_db) < 0.2, snr
    again = ChannelModel(1e6, snr_db=snr_db, seed=5)(torch.from_numpy(x))
    np.testing.assert_array_equal(again.numpy(), y)
    assert not np.array_equal(ch(torch.from_numpy(x)).numpy(), y)


def _am_iq(rng, n_ch, T):
    """1 Msps AM: a 700 Hz tone at 50% on a carrier of random phase, plus
    noise."""
    t = np.arange(T) / 1e6
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 700.0 * t)
    x = 0.5 * env[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi,
                                                     (n_ch, 1)))
    return (x + 0.05 * (rng.standard_normal((n_ch, T)) + 1j
                        * rng.standard_normal((n_ch, T)))).astype(
        np.complex64)


def _wfm_iq(rng, n_ch, T):
    """1 Msps wide FM: an 800 Hz tone at 37.5 kHz deviation, plus noise."""
    t = np.arange(T) / 1e6
    ph = np.cumsum(2 * np.pi * 75_000.0 * 0.5 * np.sin(2 * np.pi * 800.0
                                                        * t) / 1e6)
    x = np.exp(1j * (ph[None, :] + rng.uniform(0, 2 * np.pi, (n_ch, 1))))
    return (x + 0.05 * (rng.standard_normal((n_ch, T)) + 1j
                        * rng.standard_normal((n_ch, T)))).astype(
        np.complex64)


@pytest.mark.parametrize("tiny", [False, True])
def test_am_demod_streamed(rng, tiny):
    """2 channels, two blocks of 25,000 IqPair samples (200 audio samples
    each). tiny: the first 5,000 samples at ~1e-20, whose magnitudes the
    reference flushes."""
    x = _am_iq(rng, 2, 50_000)
    if tiny:
        x[:, :5000] *= np.float32(1e-20)
    _, (jy, _) = stream_both(jam.AmDemod(lead_shape=(2,)),
                             am.AmDemod(lead_shape=(2,), device="cpu"),
                             [_pair(b) for b in np.split(x, 2, axis=-1)],
                             key_tol=CHAIN_TOL, peak=True)
    assert np.abs(np.asarray(jy["audio"])).max() > 0.1


def test_wbfm_demod_streamed(rng):
    """2 channels, two blocks of 25,000 IqPair samples."""
    x = _wfm_iq(rng, 2, 50_000)
    _, (jy, _) = stream_both(jwbfm.WbfmDemod(lead_shape=(2,)),
                             wbfm.WbfmDemod(lead_shape=(2,), device="cpu"),
                             [_pair(b) for b in np.split(x, 2, axis=-1)],
                             key_tol=CHAIN_TOL, peak=True)
    assert np.abs(np.asarray(jy["audio"])).max() > 0.1


def _audio_blocks(rng, n_ch, T, f=1000.0):
    t = np.arange(2 * T) / 8000
    a = 0.5 * np.sin(2 * np.pi * f * t)[None, :] \
        + 0.05 * rng.standard_normal((n_ch, 2 * T))
    return np.split(a.astype(np.float32), 2, axis=-1)


def test_am_mod_streamed(rng):
    """2 channels, two blocks of 200 audio samples (25,000 IQ samples)."""
    stream_both(jam.AmMod(lead_shape=(2,)),
                am.AmMod(lead_shape=(2,), device="cpu"),
                _audio_blocks(rng, 2, 200), rtol=1e-5, atol=0.0, peak=True)


@pytest.mark.parametrize("ctcss_hz,pair", [(0.0, False), (123.0, True)])
def test_nbfm_mod_streamed(rng, ctcss_hz, pair):
    """2 channels, two blocks of 400 audio samples (50,000 IQ samples),
    with and without CTCSS (its phase carried), complex or IqPair out."""
    stream_both(jnbfm.NbfmMod(ctcss_hz=ctcss_hz, lead_shape=(2,), pair=pair),
                nbfm.NbfmMod(ctcss_hz=ctcss_hz, lead_shape=(2,), pair=pair,
                             device="cpu"),
                _audio_blocks(rng, 2, 400), rtol=5e-5, atol=0.0, peak=True)


@pytest.mark.parametrize("name", ["am", "wbfm"])
def test_jax_state_carries_into_the_port(rng, name, tmp_path):
    """The JAX chain's state after one block, through state_from_numpy
    and through a snapshot file, gives the JAX chain's second block."""
    jc, tc = {"am": (jam.AmDemod, am.AmDemod),
              "wbfm": (jwbfm.WbfmDemod, wbfm.WbfmDemod)}[name]
    jd, td = jc(lead_shape=(2,)), tc(lead_shape=(2,), device="cpu")
    b0, b1 = [_pair(b) for b in np.split(_am_iq(rng, 2, 50_000), 2, -1)]
    js, _ = jd(jd.init_state(), to_jax(b0))
    js_np = jax.tree_util.tree_map(np.asarray, js)
    core.save_state(tmp_path / "s.npz", core.state_from_numpy(js_np, "cpu"))
    js, jy = jd(js, to_jax(b1))
    for ts in (core.state_from_numpy(js_np, "cpu"),
               core.load_state(tmp_path / "s.npz", td.init_state())):
        ts, ty = td(ts, to_torch(b1))
        assert_outputs_same(jy, ty, key_tol=CHAIN_TOL, peak=True)
        assert_states_same(js, ts, 1e-5, 0.0, peak=True)


def test_complex_state_leaves_round_trip(rng, tmp_path):
    """complex64 leaves (the CESSB stretcher's) keep dtype and bits through
    state_to_numpy / state_from_numpy and a snapshot."""
    st = (torch.from_numpy(_iq(rng, (3, 4))),
          (torch.zeros(3), torch.from_numpy(_iq(rng, (2, 4)))))
    back = core.state_from_numpy(core.state_to_numpy(st), "cpu")
    core.save_state(tmp_path / "c.npz", st)
    loaded = core.load_state(tmp_path / "c.npz", st)
    for tree in (back, loaded):
        for a, b in zip(core._flatten(st, []), core._flatten(tree, [])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_nbfm_loopback():
    out = loopback(nbfm.NbfmMod(device="cpu"), nbfm.NbfmDemod(device="cpu"),
                   tone(800.0, 4000))
    assert out.shape == (4000,)
    snr = tone_snr(out[1000:], 800.0)
    assert snr > 15.0, snr


def test_am_loopback():
    out = loopback(am.AmMod(device="cpu"), am.AmDemod(device="cpu"),
                   tone(700.0, 4000))
    snr = tone_snr(out[1500:], 700.0)
    assert snr > 12.0, snr


def test_wbfm_rx_of_wide_fm():
    """A wide FM tone made by the port's own blocks (the 125/1 resampler
    and FrequencyMod at 75 kHz deviation), demodulated: above 15 dB, as in
    tests/test_chains_analog.py."""
    up = RationalResampler(125, 1, device="cpu")
    _, audio_up = up(up.init_state(), torch.from_numpy(tone(800.0, 4000)))
    fm = analog.FrequencyMod(2 * np.pi * 75_000.0 / 1e6, device="cpu")
    _, iq = fm(fm.init_state(), audio_up)
    demod = wbfm.WbfmDemod(device="cpu")
    _, out = demod(demod.init_state(), iq)
    snr = tone_snr(out["audio"].numpy()[1500:], 800.0)
    assert snr > 15.0, snr
