"""The SSB chains of the port against the JAX package on the CPU: complex
taps in FirFilter and conv1d_valid, the CESSB clipper and stretcher (also
against the compiled reference's golden vectors), SsbDemod (USB, LSB) and
SsbMod, each streamed over two blocks with every output and state leaf
compared (tests/torch_parity.stream_both); then torch-only loopbacks.

Tolerances, from the differences measured:
- complex-tap FIRs in direct form on both sides: 1e-5, the bound the JAX
  package holds its FIR kernels to;
- the CESSB blocks: the golden test's own bounds (2e-6 for the clipper,
  1e-6 for the stretcher), 1e-6 against the JAX blocks;
- SsbDemod: 1e-5 of each output's and state leaf's peak (peak=True). The
  5,597-tap head sums in another order in PyTorch and XLA; the audio
  differs by 1.3e-6 - 2.1e-6 of its peak whether the JAX chain runs its
  97-tap audio band-pass as an FFT (impl="auto" on the CPU) or in direct
  form. rssi within 1e-4 dB;
- SsbMod: the JAX chain runs its 97-tap audio filter and 167-tap analytic
  filter as FFTs on the CPU; held to 1e-5 of the peak as it stands, and
  to the same with both swapped for direct form.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from qradiolink_tpu.chains import ssb as jssb  # noqa: E402
from qradiolink_tpu.ops import cessb as jcessb  # noqa: E402
from qradiolink_tpu.ops import fir as jfir  # noqa: E402
from qradiolink_tpu.ops import firdes as jfirdes  # noqa: E402
from qradiolink_tpu_torch.chains import ssb  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402
from qradiolink_tpu_torch.core import state_from_numpy  # noqa: E402
from qradiolink_tpu_torch.ops import cessb, fir  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.test_chains_analog import tone, tone_snr  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_outputs_same, assert_states_same, stream_both, to_jax, to_torch)

FIX = pathlib.Path(__file__).parent / "fixtures" / "cessb_golden.json"
SSB_TOL = {"audio": (1e-5, 0.0), "rssi": (0.0, 1e-4)}


def _ssb_taps():
    """The SSB chain's channel filter: 167 complex taps at 8 ksps."""
    return jfirdes.complex_band_pass(1.0, 8000, 200.0, 2700.0, 200.0,
                                     jfirdes.WIN_BLACKMAN_HARRIS)


def _pair_blocks(x, n):
    return [(c.real.copy(), c.imag.copy()) for c in np.split(x, n, axis=-1)]


def _ssb_iq(rng, n_ch, T, f=1000.0):
    """1 Msps IQ: a tone f Hz above the carrier (below it for f < 0) at a
    random phase, plus noise."""
    t = np.arange(T) / 1e6
    x = 0.5 * np.exp(2j * np.pi * f * t)[None, :] * np.exp(
        1j * rng.uniform(0, 2 * np.pi, (n_ch, 1)))
    x = x + 0.05 * (rng.standard_normal((n_ch, T))
                    + 1j * rng.standard_normal((n_ch, T)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("kind", ["pair", "complex", "real"])
def test_complex_taps_fir_streamed(rng, kind):
    """K167 complex taps on IqPair (the JAX package's direct-form IqPair
    path), complex and real input (JAX in direct form, impl="conv")."""
    taps = _ssb_taps()
    assert np.iscomplexobj(taps) and taps.shape == (167,)
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((3, 600)).astype(np.float32)
        im = rng.standard_normal((3, 600)).astype(np.float32)
        blocks.append({"pair": (re, im), "real": re,
                       "complex": (re + 1j * im).astype(np.complex64)}[kind])
    stream_both(jfir.FirFilter(taps, impl="conv", lead_shape=(3,)),
                fir.FirFilter(taps, lead_shape=(3,), device="cpu"), blocks)


@pytest.mark.parametrize("complex_x", [False, True])
def test_conv1d_valid_complex_taps(rng, complex_x):
    taps = _ssb_taps()
    x = rng.standard_normal((2, 900)).astype(np.float32)
    if complex_x:
        x = (x + 1j * rng.standard_normal((2, 900))).astype(np.complex64)
    want = np.asarray(jfir.conv1d_valid(to_jax(x), taps, 1))
    got = fir.conv1d_valid(torch.from_numpy(x), taps, 1).numpy()
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_complex_taps_are_two_launches_of_the_routed_kernel(rng):
    """One call of the routed kernel a tap plane, both at the same key; the
    launch report counts them as 2."""
    f = fir.FirFilter(_ssb_taps(), lead_shape=(3,), device="cpu")
    x = to_torch(tuple(rng.standard_normal((3, 200)).astype(np.float32)
                       for _ in range(2)))
    kernel_paths.reset()
    f(f.init_state(), x)
    assert kernel_paths.report() == {"fir_s1_f32": {
        "cuda": 0, "plain": 2, "shapes": {"plain K167 D1 tail 2x3": 2}}}


def _golden():
    fix = json.loads(FIX.read_text())
    x = (np.asarray(fix["in_re"], np.float32)
         + 1j * np.asarray(fix["in_im"], np.float32)).astype(np.complex64)
    return fix, x


def test_cessb_stretcher_golden():
    """The compiled reference stretcher's vectors, delayed 2 samples, within
    the golden test's bound (tests/test_golden_parity.py)."""
    fix, x = _golden()
    n = fix["n"]
    st = cessb.CessbStretcher(device="cpu")
    _, y = st(st.init_state(), torch.from_numpy(x))
    y = y.numpy()
    np.testing.assert_allclose(y[2:n + 2].real,
                               np.asarray(fix["stretch_re"], np.float32),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(y[2:n + 2].imag,
                               np.asarray(fix["stretch_im"], np.float32),
                               rtol=0, atol=1e-6)


def test_cessb_clipper_golden():
    fix, x = _golden()
    n = fix["n"]
    y = cessb.CessbClipper(0.95).apply(torch.from_numpy(x[:n])).numpy()
    ref = (np.asarray(fix["clip_re"], np.float32)
           + 1j * np.asarray(fix["clip_im"], np.float32))
    np.testing.assert_allclose(y, ref, rtol=0, atol=2e-6)


def test_cessb_streamed(rng):
    """Clipper and stretcher against the JAX blocks over two blocks, on
    IQ with overshoots, starting with ~1e-20 samples (a quiet channel);
    the stretcher's complex64 state carried."""
    x = (1.2 * (rng.standard_normal((3, 1000))
                + 1j * rng.standard_normal((3, 1000)))).astype(np.complex64)
    x[:, :100] *= np.float32(1e-20)
    blocks = np.split(x, 2, axis=-1)
    for b in blocks:
        want = jcessb.CessbClipper(0.95).apply(to_jax(b))
        got = cessb.CessbClipper(0.95).apply(to_torch(b))
        assert_outputs_same(want, got, 1e-6, 1e-6, what="clipper")
    stream_both(jcessb.CessbStretcher(lead_shape=(3,)),
                cessb.CessbStretcher(lead_shape=(3,), device="cpu"), blocks,
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("usb,tiny", [(True, False), (False, False),
                                      (True, True)])
def test_ssb_demod_streamed(rng, usb, tiny):
    """2 channels, two blocks of 25,000 IqPair samples (200 audio samples
    each), a tone in the chain's sideband. tiny: the first 5,000 samples at
    ~1e-20 (a quiet channel: the squelch shuts, the AGC's gain climbs)."""
    x = _ssb_iq(rng, 2, 50_000, 1000.0 if usb else -1000.0)
    if tiny:
        x[:, :5000] *= np.float32(1e-20)
    jd = jssb.SsbDemod(usb=usb, lead_shape=(2,))
    td = ssb.SsbDemod(usb=usb, lead_shape=(2,), device="cpu")
    _, (jy, _) = stream_both(jd, td, _pair_blocks(x, 2), key_tol=SSB_TOL,
                             peak=True)
    assert np.abs(np.asarray(jy["audio"])).max() > 0.1


def test_ssb_demod_takes_the_jax_state(rng):
    """The JAX chain's state after one block, carried into the port's
    chain (state_from_numpy, its complex64 stretcher leaf included), gives
    the JAX chain's second block."""
    x = _ssb_iq(rng, 2, 50_000)
    b0, b1 = _pair_blocks(x, 2)
    jd = jssb.SsbDemod(lead_shape=(2,))
    td = ssb.SsbDemod(lead_shape=(2,), device="cpu")
    js, _ = jd(jd.init_state(), to_jax(b0))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts[4].dtype == torch.complex64
    js, jy = jd(js, to_jax(b1))
    ts, ty = td(ts, to_torch(b1))
    assert_outputs_same(jy, ty, key_tol=SSB_TOL, peak=True)
    assert_states_same(js, ts, 1e-5, 0.0, peak=True)


def _audio_blocks(rng, n_ch, T):
    t = np.arange(2 * T) / 8000
    a = 0.5 * np.sin(2 * np.pi * 1000.0 * t)[None, :] \
        + 0.05 * rng.standard_normal((n_ch, 2 * T))
    return np.split(a.astype(np.float32), 2, axis=-1)


@pytest.mark.parametrize("usb", [True, False])
@pytest.mark.parametrize("direct", [False, True])
def test_ssb_mod_streamed(rng, usb, direct):
    """2 channels, two blocks of 200 audio samples (25,000 IQ samples
    each). direct=True swaps the JAX chain's two FFT filters for direct
    form."""
    jm = jssb.SsbMod(usb=usb, lead_shape=(2,))
    if direct:
        for name in ("audio_filter", "analytic"):
            setattr(jm, name, jfir.FirFilter(
                np.asarray(getattr(jm, name).taps), impl="conv",
                lead_shape=(2,)))
    tm = ssb.SsbMod(usb=usb, lead_shape=(2,), device="cpu")
    stream_both(jm, tm, _audio_blocks(rng, 2, 200), rtol=1e-5, atol=0.0,
                peak=True)


def loopback(mod, demod, audio, snr_db=30.0):
    """TX -> ChannelModel at snr_db -> RX, torch only, on the CPU."""
    _, tx = mod(mod.init_state(), torch.from_numpy(audio))
    rx = ChannelModel(1_000_000, snr_db=snr_db)(tx["iq"])
    _, out = demod(demod.init_state(), rx)
    return out["audio"].numpy()


@pytest.mark.parametrize("tx_usb,rx_usb,want", [
    (True, True, "above 10"), (False, False, "above 10"),
    (True, False, "below 5")])
def test_ssb_loopback(tx_usb, rx_usb, want):
    """The JAX tests' loopbacks and thresholds (tests/test_chains_analog.py):
    USB and LSB above 10 dB, the opposite sideband below 5 dB."""
    out = loopback(ssb.SsbMod(usb=tx_usb, device="cpu"),
                   ssb.SsbDemod(usb=rx_usb, device="cpu"),
                   tone(1000.0, 4000))
    assert out.shape == (4000,)
    snr = tone_snr(out[1500:], 1000.0)
    assert (snr > 10.0) if want == "above 10" else (snr < 5.0), snr
