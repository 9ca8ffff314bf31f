"""FreeDV's vocoder-modem in the port (audio/freedv.py, chains/freedv.py
FreeDvTx / FreeDvRx, the controller's FreeDV RX branch) against the JAX
package's, on the CPU. Skipped, as tests/test_freedv.py is, where
libcodec2 has no FreeDV API.

- The bridge: for 1600, 700C and 2400A the port's FreeDV gives the JAX
  bridge's modem samples exactly (the same library on the same speech),
  and decodes them with modem sync to as many samples as the JAX bridge
  (tests/test_freedv.py:27-98's gates). Decoded speech is compared by
  length, sync and power, not sample by sample: the speech decoder may
  draw from a generator shared by the whole process.
- FreeDvTx: the 200-3500 Hz band-pass (95 taps) within FIR_TOL of the
  peak of the JAX filter's output over two chained blocks, the int16 PCM
  within one LSB (its truncation toward zero flips a sample whose float
  lies at a boundary; the count is printed); given the same PCM the same
  modem samples, and FreeDvMod's IQ within FDV_TX_TOL of the peak
  (tests/test_torch_freedv_mmdvm.py's bound for FreeDvMod).
- FreeDvRx: the passband within RX_TOL (that file's bound for
  FreeDvDemod, the JAX chain's K167 band-pass an FFT on the CPU) over two
  chained blocks, the int16 PCM within one LSB, the same sync and speech
  length.
- The port's RF loopbacks, USB and LSB: FreeDV 1600 through ChannelModel
  at 20 dB, 2400A clean, with tests/test_freedv.py's gates.
- The stored modem stream (tests/fixtures/freedv1600_modem.npz, which
  chip_smoke.py runs FreeDV's DSP ends on where a machine's libcodec2 has
  no FreeDV API) is what scripts/make_freedv_stream.py writes, and the
  port's band-pass gives its PCM within one LSB.
- RadioController in FreeDV1600USB RX: the JAX controller's events on the
  same IQ (kinds, sample times, rssi within 1e-3 dB, audio lengths, the
  x2 gain and rx_volume); without the FreeDV API, as the JAX controller,
  no audio event, and the port logs that once.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

import jax.numpy as jnp  # noqa: E402
from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.audio import freedv as jfreedv_api  # noqa: E402
from qradiolink_tpu.chains import freedv as jfreedv  # noqa: E402
from qradiolink_tpu_torch import config  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.audio import freedv as freedv_api  # noqa: E402
from qradiolink_tpu_torch.chains import freedv  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402

pytestmark = pytest.mark.skipif(not freedv_api.freedv_available(),
                                reason="libcodec2 freedv API missing")

CPU = "cpu"
FIR_TOL = 1e-5       # the band-pass, relative to its output's peak
FDV_TX_TOL = 2.5e-6  # FreeDvMod's IQ (tests/test_torch_freedv_mmdvm.py)
RX_TOL = 5e-6        # FreeDvDemod's passband (the same file)
BLOCK = 125_000


def _utterance(n=8000 * 2, rate=8000):
    """tests/test_freedv.py:14-22: pitch harmonics with a syllable-rate
    envelope, int16."""
    t = np.arange(n) / rate
    x = sum(np.sin(2 * np.pi * 110.0 * k * t) / k for k in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (x / np.abs(x).max() * 12000).astype(np.int16)


def _lsb(a, b):
    """Samples of two int16 arrays that differ, all by at most one LSB."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    d = np.abs(a.astype(np.int32) - b)
    assert d.max(initial=0) <= 1
    return int((d > 0).sum())


@pytest.mark.parametrize("mode", ["1600", "700C", "2400A"])
def test_modem_loopback_matches_jax(mode):
    fd_j, fd_tx, fd_rx = (m.FreeDV(mode) for m in
                          (jfreedv_api, freedv_api, freedv_api))
    for f in ("n_speech", "n_nom_modem", "n_max_modem", "n_max_speech",
              "modem_rate"):
        assert getattr(fd_tx, f) == getattr(fd_j, f), f
    speech = _utterance()
    modem = fd_tx.tx(speech)
    np.testing.assert_array_equal(modem, fd_j.tx(speech))
    assert modem.size > 0 and modem.dtype == np.int16
    out = fd_rx.rx(modem)
    assert fd_rx.sync
    assert out.size > 0
    if mode == "1600":
        assert out.size >= speech.size * 0.7
        assert np.mean(out.astype(np.float64) ** 2) > 1e4
    fd_jrx = jfreedv_api.FreeDV(mode)
    assert fd_jrx.rx(modem).size == out.size and fd_jrx.sync
    for f in (fd_j, fd_tx, fd_rx, fd_jrx):
        f.close()


def test_modes_and_availability_match_jax():
    assert freedv_api.MODE_IDS == jfreedv_api.MODE_IDS
    assert freedv_api.freedv_available() == jfreedv_api.freedv_available()


def test_stored_modem_stream_is_current():
    from scripts.make_freedv_stream import OUT, stream

    stored = np.load(OUT)
    for k, v in zip(("speech", "pcm", "modem"), stream()):
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    af = freedv.tx_audio_filter(CPU)
    _, y = af(af.init_state(), torch.from_numpy(
        stored["speech"].astype(np.float32) / 32768.0))
    pcm = np.clip(y.numpy() * 32765.0, -32765, 32765).astype(np.int16)
    print(f"{_lsb(pcm, stored['pcm'])} PCM samples one LSB apart")


@pytest.mark.parametrize("usb", [True, False])
def test_freedv_tx_matches_jax(usb):
    """Two chained blocks of 1.2 s of speech through both FreeDvTx, part by
    part (band-pass, PCM, freedv_tx, FreeDvMod)."""
    jtx = jfreedv.FreeDvTx("1600", usb=usb)
    ptx = freedv.FreeDvTx("1600", usb=usb, device=CPU)
    speech = _utterance(8000 * 3).astype(np.float32) / 32768.0
    flipped = 0
    for blk in np.split(speech[:19_200], 2):
        jtx._af_state, jf = jtx.audio_filter(jtx._af_state,
                                             jnp.asarray(blk))
        jf = np.asarray(jf)
        pf = ptx.filter(blk)
        assert pf.dtype == jf.dtype == np.float32 and pf.shape == jf.shape
        assert float(np.abs(pf - jf).max()) <= \
            FIR_TOL * float(np.abs(jf).max())
        jpcm, ppcm = (np.clip(f * 32765.0, -32765, 32765).astype(np.int16)
                      for f in (jf, pf))
        flipped += _lsb(jpcm, ppcm)
        modem = jtx.freedv.tx(jpcm)
        np.testing.assert_array_equal(ptx.freedv.tx(jpcm), modem)
        assert modem.size > 0
        pb = modem.astype(np.float32) / 32765.0
        jtx._state, jo = jtx.chain(jtx._state, jnp.asarray(pb))
        jiq = np.asarray(jo["iq"])
        piq = ptx.modulate(modem)
        assert piq.dtype == jiq.dtype == np.complex64
        assert piq.shape == jiq.shape == (modem.size * 125,)
        assert float(np.abs(piq - jiq).max()) <= \
            FDV_TX_TOL * float(np.abs(jiq).max())
    print(f"usb={usb}: {flipped} PCM samples one LSB apart")
    assert ptx.modulate(np.zeros(0, np.int16)).shape == (0,)


@pytest.fixture(scope="module")
def freedv_iq():
    """2.4 s of speech through the JAX FreeDvTx, USB: complex64 IQ, whole
    BLOCKs."""
    iq = jfreedv.FreeDvTx("1600", usb=True).process(
        _utterance(8000 * 3).astype(np.float32) / 32768.0)
    return iq[:iq.size - iq.size % BLOCK]


def test_freedv_rx_matches_jax(freedv_iq):
    """The JAX TX's IQ in two chained blocks through both FreeDvRx: the
    passband within RX_TOL, the PCM within one LSB, the same sync and
    speech length (the speech itself by its power)."""
    jrx = jfreedv.FreeDvRx("1600", usb=True)
    prx = freedv.FreeDvRx("1600", usb=True, device=CPU)
    n = freedv_iq.size // 2 - (freedv_iq.size // 2) % 125
    flipped, outs = 0, ([], [])
    for blk in (freedv_iq[:n], freedv_iq[n:]):
        jrx._state, jo = jrx.chain(jrx._state, jnp.asarray(blk))
        jpb = np.asarray(jo["passband"])
        ppb = prx.demodulate(blk)
        assert ppb.dtype == jpb.dtype == np.float32 and ppb.shape == jpb.shape
        assert float(np.abs(ppb - jpb).max()) <= \
            RX_TOL * (1.0 + float(np.abs(jpb).max()))
        jpcm, ppcm = (np.clip(pb * 32768.0, -32767, 32767).astype(np.int16)
                      for pb in (jpb, ppb))
        flipped += _lsb(jpcm, ppcm)
        outs[0].append(jrx.freedv.rx(jpcm))
        outs[1].append(prx.freedv.rx(ppcm))
    print(f"{flipped} PCM samples one LSB apart")
    assert prx.sync and jrx.sync
    js, ps = (np.concatenate(o) for o in outs)
    assert ps.size == js.size > 8000
    assert np.mean(ps.astype(np.float64) ** 2) > 1e4


@pytest.mark.parametrize("usb", [True, False])
def test_freedv_rf_loopback_1600(usb):
    """tests/test_freedv.py:55-74 on the port: speech -> FreeDvTx -> AWGN
    at 20 dB -> FreeDvRx, decoded with modem sync."""
    tx = freedv.FreeDvTx("1600", usb=usb, device=CPU)
    rx = freedv.FreeDvRx("1600", usb=usb, device=CPU)
    speech = _utterance(8000 * 3).astype(np.float32) / 32768.0
    iq = tx.process(speech)
    assert iq.size > 0
    iq = ChannelModel(1_000_000, snr_db=20.0, seed=2)(
        torch.from_numpy(iq)).numpy()
    out = rx.process(iq[:iq.size - iq.size % 125])
    assert rx.sync, "FreeDV modem did not sync over the RF loopback"
    assert out.size > speech.size * 0.5
    assert np.mean(out ** 2) > 1e-4


@pytest.mark.parametrize("usb", [True, False])
def test_freedv_2400a_rf_loopback(usb):
    """tests/test_freedv.py:88-103 on the port: 2400A over the wide SSB
    chain, clean."""
    tx = freedv.FreeDvTx("2400A", usb=usb, filter_width=4000.0, device=CPU)
    rx = freedv.FreeDvRx("2400A", usb=usb, filter_width=4000.0, device=CPU)
    speech = _utterance(8000 * 3).astype(np.float32) / 32768.0
    iq = tx.process(speech)
    assert iq.size > 0
    out = rx.process(iq)
    assert out.size > 0
    assert np.mean(out.astype(np.float64) ** 2) > 1e-4


def _controllers(rx_volume=0.5, logger=None):
    kw = dict(rx_mode="FreeDV1600USB", tx_mode="FreeDV1600USB",
              rx_volume=rx_volume)
    out = []
    for mod, cfg, extra in ((jctl, jconfig, {}),
                            (ctl, config, {"device": CPU})):
        s = cfg.Settings()
        for k, v in kw.items():
            setattr(s, k, v)
        c = mod.RadioController(s, logger=logger, **extra) if extra \
            else mod.RadioController(s)
        c.toggle_rx_mode("FreeDV1600USB")
        out.append(c)
    return out


def _events(c, iq):
    return [e for i in range(0, iq.size, BLOCK)
            for e in c.rx_block(iq[i:i + BLOCK])]


def test_controller_freedv_rx_matches_jax(freedv_iq):
    """rx_block in FreeDV1600USB over 125,000-sample blocks: the JAX
    controller's events (rssi and decoded audio, scaled by 2 and by
    rx_volume)."""
    jc, pc = _controllers(rx_volume=0.5)
    want, got = _events(jc, freedv_iq), _events(pc, freedv_iq)
    assert [e.kind for e in got] == [e.kind for e in want]
    assert sum(e.kind == "audio" for e in got) >= 3
    for w, g in zip(want, got):
        assert g.sample_time == w.sample_time
        if w.kind == "rssi":
            assert abs(g.rssi - w.rssi) <= 1e-3
        else:
            assert g.audio.dtype == w.audio.dtype == np.float32
            assert g.audio.shape == w.audio.shape
            assert float(np.abs(g.audio).max()) <= 2.0 * 0.5
    assert pc._freedv_variant("FreeDV700DLSB") == "700D"
    assert list(pc._freedv_rx) == ["FreeDV1600USB"]


def test_controller_freedv_rx_without_the_api(freedv_iq, monkeypatch):
    """Without libcodec2's FreeDV API both controllers give rssi events
    only; the port logs the missing API once."""
    monkeypatch.setattr(freedv_api, "freedv_available", lambda: False)
    monkeypatch.setattr(jfreedv_api, "freedv_available", lambda: False)
    records = []
    log = logging.getLogger("test_torch_freedv_vocoder")
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    try:
        jc, pc = _controllers(logger=log)
        iq = freedv_iq[:3 * BLOCK]
        want, got = _events(jc, iq), _events(pc, iq)
    finally:
        log.removeHandler(handler)
    assert [e.kind for e in got] == [e.kind for e in want] == ["rssi"] * 3
    missing = [r for r in records if "FreeDV API" in r.getMessage()]
    assert len(missing) == 1 and missing[0].levelno == logging.WARNING
