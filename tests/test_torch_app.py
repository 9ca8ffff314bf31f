"""The port's application layer (app/controller.py, app/cli.py,
__main__.py) against the JAX package's, on the CPU (device="cpu",
--device cpu), each case on the same numpy IQ:

- 4FSK2K text: the port's TX IQ within Fsk4Mod's bound of the JAX
  controller's (tests/test_torch_fsk.py TX_TOL, relative to the peak);
  fed the JAX TX IQ, the port's RX gives the JAX RX's event list: kinds,
  texts, payloads, frame types and sample times exactly, rssi within
  1e-3 dB. The RX watchdog, TOT and VOX make the same decisions at the
  same sample times (tests/test_app.py:45-90).
- The CLI: `modes` prints the JAX CLI's lines; `tx --text` then `rx`
  prints the text; FM `tx --wav-in` then `rx --wav-out` keeps the 800 Hz
  tone, and the port's WAV is within NbfmDemod's bound
  (tests/test_torch_nbfm.py NBFM_TOL) plus one 16-bit step of the JAX
  CLI's WAV from the same IQ file; `loopback --snr 12` returns 0.
- DMR through rx_block (tests/test_app.py:383-427, the RX half): the JAX
  controller's events.
- Scan, FrequencyScanner, RepeaterForwarder and beacon_frame: the JAX
  results.
- mmdvm_tx_poll is idle without a session; a chain factory's unrelated
  TypeError propagates. (The FreeDV, audio processor, recorder and video
  branches are held to the JAX controller in test_torch_freedv_vocoder.py,
  test_torch_audio.py and test_torch_video_voip.py.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu.app import cli as jcli  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu_torch import config  # noqa: E402
from qradiolink_tpu_torch.app import cli  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.framing.layer1 import FrameType  # noqa: E402
from qradiolink_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402

CPU = "cpu"
BLOCK = 125_000
TX_TOL = 1e-4            # tests/test_torch_fsk.py, Fsk4Mod's IQ
NBFM_TOL = (1e-5, 1e-5)  # tests/test_torch_nbfm.py, NbfmDemod's audio
TEXT = "hello tpu radio"


def _settings(cls, **kw):
    s = cls()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _port(**kw):
    return ctl.RadioController(_settings(config.Settings, **kw),
                               device=CPU)


def _jax(**kw):
    return jctl.RadioController(_settings(jconfig.Settings, **kw))


def _blocks(iq, block=BLOCK):
    iq = np.concatenate([iq, np.zeros((-len(iq)) % block, np.complex64)])
    return iq.reshape(-1, block)


def _events(c, blocks):
    return [ev for b in blocks for ev in c.rx_block(b)]


def assert_same_events(want, got):
    """Kinds, texts, payloads, frame types and sample times exactly; rssi
    within 1e-3 dB; audio of the same length. (Codec2's decoder draws its
    unvoiced excitation from one generator for the whole process, so two
    decoders in one process give other noise for the same frames; the
    frames themselves are compared where the codec is taken out.)"""
    assert [e.kind for e in got] == [e.kind for e in want]
    for w, g in zip(want, got):
        for f in ("text", "frame_type", "payload", "sample_time"):
            assert getattr(g, f) == getattr(w, f), (w.kind, f)
        if w.rssi is None:
            assert g.rssi is None
        else:
            assert abs(g.rssi - w.rssi) <= 1e-3, (w.rssi, g.rssi)
        if w.audio is None:
            assert g.audio is None
        else:
            assert g.audio.shape == w.audio.shape
            assert g.audio.dtype == w.audio.dtype


@pytest.fixture(scope="module")
def fsk_tx():
    """The 4FSK2K transmission of tests/test_app.py:_text_transmission,
    from both controllers: {"pre": ..., "text": ...} IQ a package."""
    out = {}
    for name, c in (("jax", _jax(tx_mode="4FSK2K")),
                    ("port", _port(tx_mode="4FSK2K"))):
        c.toggle_tx_mode("4FSK2K")
        c.start_transmission()
        pre = c._framer.frame(b"\xaa" * 64, FrameType.VOICE_2) * 30
        out[name] = {"pre": c.tx_bytes(pre), "text": c.tx_text(TEXT)}
    return out


def test_fsk_tx_iq_matches_jax(fsk_tx):
    for part in ("pre", "text"):
        want, got = fsk_tx["jax"][part], fsk_tx["port"][part]
        assert got.dtype == np.complex64 and got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= TX_TOL * float(np.abs(want).max()), (part, err)


def test_text_roundtrip_events_match_jax(fsk_tx):
    """tests/test_app.py:24 on the JAX TX IQ: the text arrives and the
    reception ends, with the same events out of both controllers."""
    tx = fsk_tx["jax"]
    blocks = _blocks(np.concatenate(
        [tx["pre"], tx["text"], np.zeros(50_000, np.complex64)]))
    want = _events(_jax(rx_mode="4FSK2K"), blocks)
    got = _events(_port(rx_mode="4FSK2K"), blocks)
    assert_same_events(want, got)
    assert "audio" in [e.kind for e in got] or ctl.AudioEncoder is None
    assert TEXT in "".join(e.text for e in got if e.kind == "text")
    assert "receive_end" in [e.kind for e in got]


def test_rx_watchdog_matches_jax(fsk_tx):
    """Voice frames then silence, no END frame: the 200 ms data watchdog
    ends the reception at the same sample time in both."""
    blocks = _blocks(np.concatenate(
        [fsk_tx["jax"]["pre"], np.zeros(375_000, np.complex64)]))
    want = _events(_jax(rx_mode="4FSK2K", rx_timeout_ms=200), blocks)
    got = _events(_port(rx_mode="4FSK2K", rx_timeout_ms=200), blocks)
    assert_same_events(want, got)
    assert "receive_end" in [e.kind for e in got]
    assert FrameType.END not in [e.frame_type for e in got]


def test_tot_and_vox_match_jax():
    """TOT ends the transmission after the same block, VOX gates the same
    blocks (tests/test_app.py:64-90)."""
    tone = (0.5 * np.sin(2 * np.pi * 800 * np.arange(4000) / 8000)
            ).astype(np.float32)
    silent = np.zeros(4000, np.float32)
    runs = []
    for make in (_jax, _port):
        c = make(tx_mode="FM", tot_seconds=0.5, vox_level=0.1)
        c.toggle_tx_mode("FM")
        c.start_transmission()
        trace = []
        for pcm in (silent, tone, tone, tone):
            iq = c.tx_audio_block(pcm)
            trace.append((iq is None, c.transmitting, c._tx_sample_time))
        runs.append(trace)
    assert runs[1] == runs[0]
    assert runs[0][0][0] and not runs[0][1][0]    # VOX: silent gated
    assert not runs[0][-1][1]                      # TOT: ended


def test_cli_modes_prints_the_jax_lines(capsys):
    assert jcli.main(["modes"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["modes"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 42


def test_cli_text_tx_rx_and_loopback(tmp_path, capsys):
    """tx --text then rx of that file prints the text, a frame's bytes a
    line (repeated: the RX loops lock during the first frame, as the JAX
    CLI's do, since `tx` sends no preamble); loopback --snr 12 returns 0
    (the port alone)."""
    iq_path = tmp_path / "t.cf32"
    assert cli.main(["tx", "--mode", "4FSK2K", "--text", "cq de tpu " * 6,
                     "--iq-out", str(iq_path), "--device", CPU]) == 0
    assert cli.main(["rx", "--mode", "4FSK2K", "--iq-in", str(iq_path),
                     "--device", CPU]) == 0
    out = capsys.readouterr().out
    texts = [ln[len("[text] "):] for ln in out.splitlines()
             if ln.startswith("[text] ")]
    assert "cq de tpu cq de tpu" in "".join(texts)
    assert "[end of transmission]" in out
    assert cli.main(["loopback", "--mode", "4FSK2K", "--snr", "12",
                     "--device", CPU]) == 0
    assert "loopback OK" in capsys.readouterr().out


def test_cli_fm_wav_matches_jax(tmp_path):
    """FM: tx --wav-in then rx --wav-out keeps the 800 Hz tone; the JAX
    CLI's rx of the same IQ file gives the same WAV within NbfmDemod's
    bound and one 16-bit step."""
    t = np.arange(12_000) / 8000.0
    write_wav(tmp_path / "in.wav",
              (0.5 * np.sin(2 * np.pi * 800 * t)).astype(np.float32), 8000)
    iq_path = tmp_path / "fm.cf32"
    assert cli.main(["tx", "--mode", "FM", "--wav-in",
                     str(tmp_path / "in.wav"), "--iq-out", str(iq_path),
                     "--device", CPU]) == 0
    assert cli.main(["rx", "--mode", "FM", "--iq-in", str(iq_path),
                     "--wav-out", str(tmp_path / "t.wav"),
                     "--device", CPU]) == 0
    assert jcli.main(["rx", "--mode", "FM", "--iq-in", str(iq_path),
                      "--wav-out", str(tmp_path / "j.wav")]) == 0
    got, rate = read_wav(tmp_path / "t.wav")
    want, _ = read_wav(tmp_path / "j.wav")
    assert rate == 8000 and got.shape == want.shape and got.size > 8000
    rtol, atol = NBFM_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol + 1 / 32767)
    x = got[4000:]
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    f = np.fft.rfftfreq(len(x), 1 / 8000)
    band = (f > 200) & (f < 3000)
    assert abs(f[band][np.argmax(spec[band])] - 800.0) < 40.0


def test_dmr_rx_block_matches_jax():
    """tests/test_app.py:383-427, the RX half: a BS stream with slot 2 a
    voice call (header, one superframe, terminator; the port's builders,
    which tests/test_torch_dmr_call.py holds to the JAX ones, and DmrMod)
    through each controller's rx_block, codec2 taken out so the voice
    payloads arrive as frames and compare exactly: the same events, voice
    frames, receive_end and the source id."""
    from qradiolink_tpu_torch.chains.dmr import DmrMod
    from qradiolink_tpu_torch.fec import ambe
    from qradiolink_tpu_torch.protocols import dmr as dmrp
    from qradiolink_tpu_torch.protocols.dmr_stream import build_bs_stream

    rng = np.random.default_rng(2)
    lc = dmrp.LinkControl(flco=dmrp.FLCO_GROUP, src_id=44556, dst_id=9)
    voice = ambe.voice_encode(rng.integers(0, 2, (6, 3, 49)).astype(
        np.uint8), CPU)
    slot2 = ([dmrp.make_lc_burst(lc, 1, dmrp.DT_VOICE_LC_HEADER,
                                 device=CPU)]
             + list(dmrp.make_voice_superframe(voice, lc, 1, device=CPU))
             + [dmrp.make_lc_burst(lc, 1, dmrp.DT_TERMINATOR_WITH_LC,
                                   device=CPU)])
    idle = dmrp.make_data_burst(np.zeros(196, np.uint8), 1, dmrp.DT_IDLE,
                                device=CPU)
    bits = build_bs_stream([idle] * (len(slot2) + 2), slot2, lead_idle=4,
                           device=CPU)
    mod = DmrMod(device=CPU)
    iq = mod(mod.init_state(), torch.from_numpy(bits))[1]["iq"].numpy()
    blocks = _blocks(iq[:len(iq) - len(iq) % BLOCK])
    evs = []
    for make in (_jax, _port):
        c = make(rx_mode="DMR")
        c.toggle_rx_mode("DMR")
        c._dmr_stack().config.timeslot = 2
        c._codec = None
        evs.append(_events(c, blocks))
    assert_same_events(*evs)
    kinds = [e.kind for e in evs[1]]
    assert kinds.count("frame") >= 4 and "receive_end" in kinds
    assert "44556" in [e.text for e in evs[1]
                       if e.kind in ("callsign", "receive_end")]


def test_scan_memory_channels_matches_jax():
    """tests/test_app.py:119: the scan stops on the same channel."""
    def iq_source(ch):
        rng = np.random.default_rng(1)
        n = 50_000
        if ch.name == "active":
            t = np.arange(n) / 1e6
            yield (0.7 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
        else:
            yield (1e-4 * (rng.standard_normal(n) + 1j
                           * rng.standard_normal(n))).astype(np.complex64)

    hits = []
    for make, cfg in ((_jax, jconfig), (_port, config)):
        chans = cfg.RadioChannels([
            cfg.MemoryChannel("quiet", 433_000_000, 0, "FM", "FM", -60.0),
            cfg.MemoryChannel("skipped", 432_000_000, 0, "FM", "FM", -200.0,
                              skip=True),
            cfg.MemoryChannel("active", 434_000_000, 0, "FM", "FM", -60.0)])
        hit = make().scan_memory_channels(chans, iq_source,
                                          blocks_per_channel=1)
        hits.append(dataclasses.asdict(hit))
    assert hits[1] == hits[0] and hits[0]["name"] == "active"


def test_frequency_scanner_matches_jax():
    """tests/test_app.py:180: the same offsets, carrier steps and pauses,
    tick by tick."""
    traces = []
    for make, mod in ((_jax, jctl), (_port, ctl)):
        c = make(rx_sample_rate=1_000_000, scan_resume_ms=5000)
        sc = mod.FrequencyScanner(c, step_hz=100_000)
        trace = []
        for i, recv in enumerate([0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0]):
            sc.tick(receiving=bool(recv), now_s=0.2 * i + (i > 6) * 5.0)
            trace.append((c.settings.demod_offset, c.settings.rx_frequency,
                          c._rotator is not None))
        sc.stop()
        traces.append((trace, sc.active, c.settings.demod_offset))
    assert traces[1] == traces[0]


def test_repeater_and_beacon_match_jax():
    """tests/test_app.py:207-246: the forwarded text's IQ within Fsk4Mod's
    bound, nothing forwarded when disabled, the same beacon frame."""
    outs = []
    for make, mod in ((_jax, jctl), (_port, ctl)):
        c = make(rx_mode="4FSK2K", tx_mode="4FSK2K", repeater_enabled=True,
                 callsign="N0REP", rx_frequency=439_000_000,
                 tx_shift=-7_600_000)
        fwd = mod.RepeaterForwarder(c)
        out = fwd.forward([mod.RxEvent("text", text="CQ CQ"),
                           mod.RxEvent("rssi", rssi=-50.0)])
        c.settings.repeater_enabled = False
        assert fwd.forward([mod.RxEvent("text", text="CQ")]) == []
        outs.append((out, mod.beacon_frame(c), mod.beacon_frame(c, "X1")))
    (jout, jb, jb2), (tout, tb, tb2) = outs
    assert len(tout) == len(jout) == 1 and tout[0].shape == jout[0].shape
    assert np.abs(tout[0] - jout[0]).max() <= \
        TX_TOL * np.abs(jout[0]).max()
    assert (tb, tb2) == (jb, jb2)


def test_mmdvm_tx_poll_is_idle_without_a_session():
    """Without an MMDVM session mmdvm_tx_poll gives nothing, as in the JAX
    controller."""
    assert _port().mmdvm_tx_poll(2400) is None
    assert _jax().mmdvm_tx_poll(2400) is None


def test_chain_faults_propagate(monkeypatch):
    """_build_chain passes the CTCSS tone, the filter width and `pair` only
    to chains that take them (registry.chain_keywords), as the JAX
    controller's retries end up doing, and retries nothing: a TypeError
    from inside a chain propagates."""
    from qradiolink_tpu_torch.models import registry

    kw = dict(rx_mode="FM", tx_mode="FM", rx_ctcss=88.5, tx_ctcss=88.5,
              filter_width=4000)
    c, j = _port(**kw), _jax(**kw)
    for x in (c, j):
        x.toggle_tx_mode("FM")
        x.toggle_rx_mode("FM")
    assert c._tx.fm.pair_out is True          # pair kept: NbfmMod takes it
    assert c._tx.ctcss_hz == j._tx.ctcss_hz == 88.5
    assert c._rx.filter_width == j._rx.filter_width == 4000.0
    # 2FSK10K fixes its own filter width and 4FSK2K has no CTCSS: the
    # settings are left out, not retried
    assert "filter_width" not in registry.chain_keywords("2FSK10K")
    assert "ctcss_hz" not in registry.chain_keywords("4FSK2K", rx=False)
    for mode in ("2FSK10K", "4FSK2K"):
        for rx in (True, False):
            assert c._build_chain(mode, rx=rx).device.type == CPU

    def broken(mode, **kw):
        raise TypeError("unsupported operand type(s) for +: 'Tensor' and "
                        "'NoneType'")

    def inner(mode, **kw):
        raise TypeError("g() got an unexpected keyword argument 'pair'")

    monkeypatch.setattr(ctl, "rx_chain", broken)
    with pytest.raises(TypeError, match="unsupported operand"):
        c.toggle_rx_mode("FM")
    assert c._rx is None
    monkeypatch.setattr(ctl, "tx_chain", inner)
    with pytest.raises(TypeError, match="'pair'"):
        c._build_chain("FM", rx=False)


def test_controller_and_cli_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ctl.RadioController(config.Settings())
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["loopback"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["headless", "--control-port", "0"])
    c = ctl.RadioController(config.Settings(), device=CPU)
    c.toggle_rx_mode("NBFM")
    assert c._rx.device.type == "cpu"


def test_main_module_imports_without_running(capsys):
    import importlib
    importlib.import_module("qradiolink_tpu_torch.__main__")
    assert capsys.readouterr().out == ""
