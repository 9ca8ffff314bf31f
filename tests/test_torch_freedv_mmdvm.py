"""FreeDV's DSP ends, the MMDVM chains and the spectral probes of the port
(chains/freedv.py, chains/mmdvm.py, ops/spectrum.py) against their JAX
twins on the CPU, and the port's own loopbacks.

FreeDV: FreeDvDemod on the port's FreeDvMod IQ (a 1 kHz and a 1.5 kHz
passband tone, noise at 0.01 a plane) as IqPair planes, 2 rows x two
blocks of 1,000,000 samples, USB and LSB. The JAX chain runs its K167
audio band-pass as an FFT on the CPU (its band-passes on IqPair input are
direct), so it is compared twice ("direct": that filter in direct form;
"fft": as it is). Outputs and state leaves within 5e-6 (1 + peak)
(measured 2.7e-6, rssi in dB); FreeDvMod within 2.5e-6 (measured 7.4e-7).
The JAX FreeDV tests need libcodec2 and skip without it, so the port's
loopback is a passband tone through FreeDvMod -> ChannelModel(10 dB) ->
FreeDvDemod: tone SNR above 25 dB in the passband (measured 36.7) and below
0 dB through the opposite sideband (measured -13.3).

MMDVM: the demodulators on the port's modulators' IQ, the modulators on
tones (with a TDMA mask), two blocks each: MmdvmDemod and MmdvmMultiRx
within 5e-6 (measured 6.8e-7), MmdvmMod's IQ within 3e-3 (measured
1.1e-3: FrequencyMod's phase is a cumulative sum over the block's 24,000
samples at 3.3 rad a unit, summed in another order), MmdvmMultiTx's IQ
and state within 6e-3 (measured 2.3e-3, in the channel filters' tails of
the FM output: 7 tones of 0.4 at 300-900 Hz swing the phase by +-17 rad,
where f32's spacing is 1.9e-6); the carried FM phase modulo 2 pi. The
loopbacks hold tests/test_chains_mmdvm.py's thresholds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.chains import freedv as jfreedv  # noqa: E402
from qradiolink_tpu.chains import mmdvm as jmmdvm  # noqa: E402
from qradiolink_tpu.ops import spectrum as jspectrum  # noqa: E402
from qradiolink_tpu_torch.chains import freedv, mmdvm  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import spectrum  # noqa: E402
from tests.torch_parity import (direct_firs, stream_both,  # noqa: E402
                                to_numpy)

RX_TOL = 5e-6
FDV_TX_TOL = 2.5e-6
MMDVM_TX_TOL = 3e-3
MULTI_TX_TOL = 6e-3


def planes(iq):
    """A complex (..., T) array split into two (re, im) blocks."""
    return [(b.real.copy(), b.imag.copy()) for b in np.split(iq, 2, axis=-1)]


def passband(n, rate=8000):
    t = np.arange(n) / rate
    return np.stack([0.5 * np.sin(2 * np.pi * 1000 * t),
                     0.3 * np.sin(2 * np.pi * 1500 * t + 1.0)]
                    ).astype(np.float32)


@pytest.mark.parametrize("variant", ["direct", "fft"])
@pytest.mark.parametrize("usb", [True, False])
def test_freedv_demod_matches_jax(usb, variant):
    rng = np.random.default_rng(3)
    mod = freedv.FreeDvMod(usb=usb, lead_shape=(2,), device="cpu")
    iq = to_numpy(mod(mod.init_state(), torch.from_numpy(
        passband(16_000)))[1]["iq"])
    iq = (iq + 0.01 * (rng.standard_normal(iq.shape)
                       + 1j * rng.standard_normal(iq.shape))
          ).astype(np.complex64)
    jd = jfreedv.FreeDvDemod(usb=usb, lead_shape=(2,))
    if variant == "direct":
        jd = direct_firs(jd)
    stream_both(jd, freedv.FreeDvDemod(usb=usb, lead_shape=(2,),
                                       device="cpu"), planes(iq), RX_TOL,
                RX_TOL, peak=True)


@pytest.mark.parametrize("usb", [True, False])
def test_freedv_mod_matches_jax(usb):
    stream_both(jfreedv.FreeDvMod(usb=usb, lead_shape=(2,)),
                freedv.FreeDvMod(usb=usb, lead_shape=(2,), device="cpu"),
                np.split(passband(16_000), 2, axis=-1), FDV_TX_TOL,
                FDV_TX_TOL, peak=True)


def test_feedforward_agc_matches_jax(rng):
    """Three blocks of complex input whose level drops 100-fold: output and
    the held envelope within 1e-6 (1 + peak)."""
    x = (rng.standard_normal((2, 1500))
         + 1j * rng.standard_normal((2, 1500))).astype(np.complex64)
    x[:, 1000:] *= 0.01
    stream_both(jfreedv.FeedforwardAgc(lead_shape=(2,)),
                freedv.FeedforwardAgc(lead_shape=(2,), device="cpu"),
                np.split(x, 3, axis=-1), 1e-6, 1e-6, peak=True)


def tone_snr_db(x, freq, rate, lo=200.0, hi=3500.0, width=50.0):
    """Power within `width` of freq against the rest of [lo, hi]."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    f = np.fft.rfftfreq(len(x), 1 / rate)
    sig = spec[np.abs(f - freq) < width].sum()
    noise = spec[(np.abs(f - freq) >= width) & (f > lo) & (f < hi)].sum()
    return 10 * np.log10(sig / (noise + 1e-30))


@pytest.mark.parametrize("usb", [True, False])
def test_freedv_passband_tone_loopback(usb):
    """A 1 kHz passband tone (2 s) through FreeDvMod -> ChannelModel at
    10 dB -> FreeDvDemod on the port: tone SNR above 25 dB after the first
    0.5 s, below 0 dB through the opposite sideband's demodulator."""
    pb = passband(16_000)[:1].repeat(2, axis=0)
    mod = freedv.FreeDvMod(usb=usb, lead_shape=(2,), device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(pb))[1]["iq"]
    iq = ChannelModel(1_000_000, snr_db=10.0, seed=5)(iq)
    for side, lim in ((usb, 25.0), (not usb, 0.0)):
        dem = freedv.FreeDvDemod(usb=side, lead_shape=(2,), device="cpu")
        out = dem(dem.init_state(), iq)[1]["passband"].numpy()
        snr = min(tone_snr_db(r[4000:], 1000.0, 8000) for r in out)
        if side == usb:
            assert snr > lim, f"usb={usb}: tone SNR {snr:.1f} dB"
        else:
            assert snr < lim, f"usb={usb}, opposite sideband: {snr:.1f} dB"


# -- MMDVM -------------------------------------------------------------------
RATE24 = mmdvm.TARGET_RATE


def tone24(freq, n, amp=0.15):
    """tests/test_chains_mmdvm._tone: amp 0.15 is a 1.9 kHz peak deviation."""
    t = np.arange(n) / RATE24
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def mmdvm_tone_snr(audio, freq):
    """tests/test_chains_mmdvm._tone_snr_db."""
    return tone_snr_db(audio, freq, RATE24, lo=50.0, hi=4000.0, width=150.0)


@pytest.mark.parametrize("pair", [False, True])
def test_mmdvm_mod_matches_jax(pair):
    """2 rows x two blocks of 24,000 audio samples, a mask zeroing one
    720-sample slot in the first block."""
    a = np.stack([tone24(1000.0, 48_000, 0.5), tone24(700.0, 48_000, 0.3)])
    mask = np.ones_like(a)
    mask[:, 1000:1720] = 0.0
    blocks = list(zip(np.split(a, 2, axis=-1), np.split(mask, 2, axis=-1)))
    stream_both(jmmdvm.MmdvmMod(lead_shape=(2,), pair=pair),
                mmdvm.MmdvmMod(lead_shape=(2,), pair=pair, device="cpu"),
                blocks, MMDVM_TX_TOL, MMDVM_TX_TOL, peak=True,
                wrap_phase=True,
                call=lambda b, s, x, conv: b(s, conv(x[0]), conv(x[1])))


def test_mmdvm_demod_matches_jax():
    a = np.stack([tone24(1000.0, 48_000, 0.5), tone24(700.0, 48_000, 0.3)])
    mod = mmdvm.MmdvmMod(lead_shape=(2,), device="cpu")
    iq = to_numpy(mod(mod.init_state(), torch.from_numpy(a))[1]["iq"])
    stream_both(jmmdvm.MmdvmDemod(lead_shape=(2,)),
                mmdvm.MmdvmDemod(lead_shape=(2,), device="cpu"),
                planes(iq), RX_TOL, RX_TOL, peak=True)


def seven_tones(n):
    return np.stack([tone24(300.0 + 100 * i, n, 0.4) for i in range(7)])


@pytest.mark.parametrize("pair", [False, True])
def test_mmdvm_multi_tx_matches_jax(pair):
    """7 carriers x two blocks of 24,000 audio samples, a mask gating
    carrier 2 in the second block."""
    a = seven_tones(48_000)
    mask = np.ones((7, 50_000), np.float32)
    mask[2, 25_000:] = 0.0
    blocks = list(zip(np.split(a, 2, axis=-1), np.split(mask, 2, axis=-1)))
    stream_both(jmmdvm.MmdvmMultiTx(pair=pair),
                mmdvm.MmdvmMultiTx(pair=pair, device="cpu"), blocks,
                MULTI_TX_TOL, MULTI_TX_TOL, peak=True, wrap_phase=True,
                call=lambda b, s, x, conv: b(s, conv(x[0]),
                                             mask=conv(x[1])))


@pytest.mark.parametrize("kind", ["pair", "complex"])
def test_mmdvm_multi_rx_matches_jax(kind):
    """The port's 7-carrier IQ, two blocks of 250,000, as IqPair planes
    (the fused channelizer) or complex (the commutator and branch FIRs)."""
    tx = mmdvm.MmdvmMultiTx(device="cpu")
    iq = to_numpy(tx(tx.init_state(), torch.from_numpy(
        seven_tones(48_000)))[1]["iq"])
    blocks = planes(iq) if kind == "pair" else np.split(iq, 2, axis=-1)
    stream_both(jmmdvm.MmdvmMultiRx(), mmdvm.MmdvmMultiRx(device="cpu"),
                blocks, RX_TOL, RX_TOL, peak=True)


def test_mmdvm_multi_registry_chains_take_the_redesigned_kernels():
    """MMDVMmulti's RX and TX as the registry builds them on the CPU: the
    TX records its synthesizer's branch FIRs under depthwise_run_f32 (kp
    53, the tail form) and the RX its channelizer under pfb_fft_f32 (M 10,
    kp 56), a call a block, and nothing under pfb_channelize_f32 or
    depthwise_fir_f32; both still match the JAX chains (two blocks each)."""
    from qradiolink_tpu.models import registry as jregistry
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    tx = registry.tx_chain("MMDVMmulti", device="cpu")
    a = seven_tones(48_000)
    kernel_paths.reset()
    (_, ttx), _ = stream_both(jregistry.tx_chain("MMDVMmulti"), tx,
                              np.split(a, 2, axis=-1), MULTI_TX_TOL,
                              MULTI_TX_TOL, peak=True, wrap_phase=True)
    rep = kernel_paths.report()
    assert rep["depthwise_run_f32"]["shapes"] == {"plain C10 kp53 tail": 2}
    cplx = mmdvm.MmdvmMultiTx(device="cpu")
    iq = to_numpy(cplx(cplx.init_state(), torch.from_numpy(a))[1]["iq"])
    rx = registry.rx_chain("MMDVMmulti", device="cpu")
    kernel_paths.reset()
    stream_both(jregistry.rx_chain("MMDVMmulti"), rx, planes(iq), RX_TOL,
                RX_TOL, peak=True)
    rep = kernel_paths.report()
    assert rep["pfb_fft_f32"]["shapes"] == {"plain M10 kp56": 2}
    assert "pfb_channelize_f32" not in rep
    assert "depthwise_fir_f32" not in rep


def test_mmdvm_single_loopback():
    """tests/test_chains_mmdvm.py: a 1 kHz tone, SNR above 30 dB."""
    mod, dem = mmdvm.MmdvmMod(device="cpu"), mmdvm.MmdvmDemod(device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(tone24(1000.0, 19_200)))[1]
    iq = iq["iq"][: iq["iq"].shape[-1] - iq["iq"].shape[-1] % 125]
    audio = dem(dem.init_state(), iq)[1]["audio"].numpy()[2000:]
    assert mmdvm_tone_snr(audio, 1000.0) > 30.0


def test_mmdvm_multi_loopback_7ch():
    """tests/test_chains_mmdvm.py: 7 carriers through the synthesizer and
    the channelizer (IqPair planes, the fused channelizer), each tone's SNR
    above 25 dB, channel 0's tone below 10 dB in channel 3."""
    freqs = 600.0 + 300.0 * np.arange(7)
    audio = np.stack([tone24(f, 2400 * 8) for f in freqs])
    tx, rx = mmdvm.MmdvmMultiTx(7, device="cpu"), mmdvm.MmdvmMultiRx(
        7, device="cpu")
    iq = tx(tx.init_state(), torch.from_numpy(audio))[1]["iq"]
    m = iq.shape[-1] - iq.shape[-1] % 250
    rec = rx(rx.init_state(), IqPair(iq.real[:m].contiguous(),
                                     iq.imag[:m].contiguous()))[1]
    rec = rec["audio"].numpy()
    assert rec.shape[0] == 7
    for c in range(7):
        snr = mmdvm_tone_snr(rec[c, 4000:], freqs[c])
        assert snr > 25.0, f"channel {c} tone SNR {snr:.1f} dB"
    assert mmdvm_tone_snr(rec[3, 4000:], freqs[0]) < 10.0


def test_mmdvm_multi_tx_mask_gates_channel():
    """tests/test_chains_mmdvm.py: a zeroed mask on carrier 1 of 3 leaves
    its RF power below 1e-4 of the others'."""
    C, n24 = 3, 2400 * 4
    audio = np.stack([tone24(800.0 + 200 * c, n24) for c in range(C)])
    mask = np.ones((C, n24 * 25 // 24), np.float32)
    mask[1] = 0.0
    tx = mmdvm.MmdvmMultiTx(C, device="cpu")
    iq = tx(tx.init_state(), torch.from_numpy(audio),
            mask=torch.from_numpy(mask))[1]["iq"].numpy()[5000:]
    spec = np.abs(np.fft.fft(iq * np.hanning(len(iq)))) ** 2
    f = np.fft.fftfreq(len(iq), 1 / 250_000)

    def carrier_pow(fc):
        return spec[np.abs(f - fc) < 13_000].sum()

    p_on = carrier_pow(0.0) + carrier_pow(50_000.0)
    assert carrier_pow(25_000.0) < p_on * 1e-4


def test_mmdvm_multi_block_invariance():
    """tests/test_chains_mmdvm.py: two blocks give one double block's
    audio within 1e-4."""
    C, n24 = 4, 2400 * 4
    audio = np.stack([tone24(700.0 + 150 * c, n24) for c in range(C)])
    tx = mmdvm.MmdvmMultiTx(C, device="cpu")
    iq = tx(tx.init_state(), torch.from_numpy(audio))[1]["iq"]
    m = iq.shape[-1] - iq.shape[-1] % 500
    iq = iq[:m]
    rx = mmdvm.MmdvmMultiRx(C, device="cpu")
    full = rx(rx.init_state(), iq)[1]["audio"]
    st, o1 = rx(rx.init_state(), iq[:m // 2])
    _, o2 = rx(st, iq[m // 2:])
    np.testing.assert_allclose(torch.cat([o1["audio"], o2["audio"]],
                                         -1).numpy(), full.numpy(),
                               atol=1e-4)


# -- spectral probes ---------------------------------------------------------
@pytest.mark.parametrize("kind", ["pair", "complex"])
def test_rssi_dbm_slots_matches_jax(rng, kind):
    x = (rng.standard_normal((3, 2000))
         + 1j * rng.standard_normal((3, 2000))).astype(np.complex64)
    x[1] *= 1e-3
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if kind == "pair":
        from qradiolink_tpu.core import IqPair as JaxPair
        jx = JaxPair(jnp.asarray(x.real), jnp.asarray(x.imag))
        tx = IqPair(tx.real.contiguous(), tx.imag.contiguous())
    want = np.asarray(jspectrum.rssi_dbm_slots(jx, 720))
    got = spectrum.rssi_dbm_slots(tx, 720).numpy()
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["real", "complex", "pair"])
def test_rssi_probe_matches_jax(rng, kind):
    """RssiProbe streamed over three blocks of 2 x 1,500 (shorter than the
    2,000-sample window): the dB stream within 1e-4 dB, the history and
    the IIR value elementwise within 1e-5 + 1e-5 |value|."""
    x = rng.standard_normal((2, 4500)) + 1j * rng.standard_normal((2, 4500))
    x = x.astype(np.complex64)
    if kind == "real":
        blocks = np.split(x.real.copy(), 3, axis=-1)
    elif kind == "complex":
        blocks = np.split(x, 3, axis=-1)
    else:
        blocks = planes(x[:, :3000]) + planes(x[:, 3000:])[1:]
    stream_both(jspectrum.RssiProbe(lead_shape=(2,)),
                spectrum.RssiProbe(lead_shape=(2,), device="cpu"), blocks,
                rtol=0.0, atol=1e-4, state_rtol=1e-5, state_atol=1e-5)


def test_spectrum_probe_matches_jax(rng):
    """SpectrumProbe over the last 1,024 of 3 x 3,000 complex samples: dB
    within 1e-3 where the power is within 80 dB of the peak bin."""
    x = (rng.standard_normal((3, 3000))
         + 1j * rng.standard_normal((3, 3000))).astype(np.complex64)
    want = np.asarray(jspectrum.SpectrumProbe(1024)(jnp.asarray(x)))
    got = spectrum.SpectrumProbe(1024, device="cpu")(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1024)
    live = want > want.max() - 80.0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-3)
