"""The port's host modules against the JAX package's, on the CPU: the IQ
file formats (io/iq.py) byte for byte and array for array against the JAX
module's default path (its C++ engine for cs16 and cu8), IqFileSource's
blocks, SignalSource, the WAV round trip (io/wav.py), Settings and
RadioChannels saved by the JAX package loading in the port (config.py),
the layer-2 frames and protobuf bytes (framing/layer2.py), the band plan
(app/limits.py) and the logger."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu.app import limits as jlimits  # noqa: E402
from qradiolink_tpu.framing import layer2 as jl2  # noqa: E402
from qradiolink_tpu.io import iq as jiq  # noqa: E402
from qradiolink_tpu.io import wav as jwav  # noqa: E402
from qradiolink_tpu_torch import config, logger  # noqa: E402
from qradiolink_tpu_torch.app import limits  # noqa: E402
from qradiolink_tpu_torch.framing import layer2 as l2  # noqa: E402
from qradiolink_tpu_torch.io import iq, wav  # noqa: E402


def _iq(n, seed=0, scale=0.7):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale
    x[:4] = [1.2 + 0j, -1.2j, 0.5 / 32767, -0.5 / 127.5]  # clip, ties
    return x.astype(np.complex64)


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cu8"])
def test_iq_formats_match_jax(fmt, tmp_path):
    x = _iq(10_007)
    iq.write_iq(tmp_path / "t.iq", x, fmt)
    jiq.write_iq(tmp_path / "j.iq", x, fmt)
    assert (tmp_path / "t.iq").read_bytes() == \
        (tmp_path / "j.iq").read_bytes()
    got, want = iq.read_iq(tmp_path / "j.iq", fmt), \
        jiq.read_iq(tmp_path / "j.iq", fmt)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown IQ format"):
        iq.write_iq(tmp_path / "x.iq", x, "cs8")


@pytest.mark.parametrize("fmt", ["cf32", "cu8"])
def test_iq_file_source_and_sink_match_jax(fmt, tmp_path):
    x = _iq(5_300, seed=1)
    with iq.IqFileSink(tmp_path / "s.iq", fmt=fmt) as sink:
        sink.write(x[:2000])
        sink.write(x[2000:])
    got = list(iq.IqFileSource(tmp_path / "s.iq", 1000, fmt=fmt))
    want = list(jiq.IqFileSource(tmp_path / "s.iq", 1000, fmt=fmt))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (1000,) and g.dtype == np.complex64
        np.testing.assert_array_equal(g, w)
    rep = iq.IqFileSource(tmp_path / "s.iq", 1000, fmt=fmt, repeat=True)
    it = iter(rep)
    blocks = [next(it) for _ in range(8)]
    np.testing.assert_array_equal(blocks[6], got[0])


@pytest.mark.parametrize("fmt", ["cs16", "cu8"])
def test_every_code_and_half_step_match_jax(fmt, tmp_path):
    """Every cs16 code or all 256 cu8 codes read, and writes at every half
    step of the format (the ties), equal qradiolink_tpu.io.iq's as it
    stands (its engine where g++ builds it), byte for byte."""
    codes = np.arange(-32768, 32768, dtype=np.int16) if fmt == "cs16" \
        else np.arange(256, dtype=np.uint8)
    (tmp_path / "codes.iq").write_bytes(codes.tobytes())
    got = iq.read_iq(tmp_path / "codes.iq", fmt)
    want = jiq.read_iq(tmp_path / "codes.iq", fmt)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    scale, offset = (32767.0, 0.0) if fmt == "cs16" else (127.5, 127.5)
    steps = np.arange(-32767, 32767) if fmt == "cs16" else np.arange(256)
    half = ((steps + 0.5 - offset) / scale).astype(np.float32)
    x = (half[0::2] + 1j * half[1::2]).astype(np.complex64)
    iq.write_iq(tmp_path / "t.iq", x, fmt)
    jiq.write_iq(tmp_path / "j.iq", x, fmt)
    assert (tmp_path / "t.iq").read_bytes() == \
        (tmp_path / "j.iq").read_bytes()


def test_signal_source_matches_jax():
    kw = dict(block_len=4096, sample_rate=1e6, tone_hz=[1000.0, -25_000.0],
              noise_db=-20.0, seed=3)
    t, j = iq.SignalSource(**kw), jiq.SignalSource(**kw)
    for _ in range(2):
        np.testing.assert_array_equal(next(t), next(j))


def test_wav_roundtrip_and_jax(tmp_path):
    rng = np.random.default_rng(2)
    mono = np.clip(rng.standard_normal(8000) * 0.3, -1, 1).astype(np.float32)
    stereo = np.stack([mono, -mono])
    for x in (mono, stereo):
        wav.write_wav(tmp_path / "t.wav", x, 8000)
        jwav.write_wav(tmp_path / "j.wav", x, 8000)
        assert (tmp_path / "t.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes()
        got, rate = wav.read_wav(tmp_path / "j.wav")
        want, _ = jwav.read_wav(tmp_path / "j.wav")
        assert rate == 8000 and got.shape == x.shape
        np.testing.assert_array_equal(got, want)
        assert np.abs(got - x).max() <= 1.0 / 32767


def test_settings_saved_by_jax_load_in_port(tmp_path):
    """The same schema and defaults: a Settings and a RadioChannels table
    the JAX package saved load in the port with equal fields, and back."""
    assert [(f.name, f.default) for f in
            dataclasses.fields(config.Settings)] == \
        [(f.name, f.default) for f in dataclasses.fields(jconfig.Settings)]
    js = jconfig.Settings(rx_mode="DMR", tx_mode="4FSK2K", callsign="N0TPU",
                          rx_frequency=439_000_000, tx_shift=-7_600_000,
                          squelch_db=-95.5, dmr_talker_alias="TPU",
                          tot_seconds=30.0)
    path = js.save(tmp_path / "s.json")
    ts = config.Settings.load(path)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    back = jconfig.Settings.load(ts.save(tmp_path / "t.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(js)
    assert dataclasses.asdict(config.Settings.load(tmp_path / "none")) == \
        dataclasses.asdict(jconfig.Settings())
    jch = jconfig.RadioChannels([
        jconfig.MemoryChannel("quiet", 433_000_000, 0, "FM", "FM", -60.0),
        jconfig.MemoryChannel("rep", 439_000_000, -7_600_000, "DMR", "DMR",
                              -90.0, skip=True)])
    tch = config.RadioChannels.load(jch.save(tmp_path / "c.json"))
    assert [dataclasses.asdict(c) for c in tch.channels] == \
        [dataclasses.asdict(c) for c in jch.channels]


def test_layer2_matches_jax():
    """Layer-2 frames and the protobuf wire bytes (tests/test_framing.py:
    122-150) equal the JAX module's."""
    msg = l2.PageMessage("CALL1", "CALL2", "hello there")
    jmsg = jl2.PageMessage("CALL1", "CALL2", "hello there")
    assert msg.encode() == jmsg.encode()
    for t in (l2.MSG_RAW, l2.MSG_PAGE, l2.MSG_REPEATER_INFO):
        f = l2.build_layer2_frame(msg.encode(), t)
        assert f == jl2.build_layer2_frame(jmsg.encode(), t)
        assert l2.parse_layer2_frame(f) == jl2.parse_layer2_frame(f)
    assert l2.PageMessage.decode(msg.encode()) == msg
    bad = bytearray(l2.build_layer2_frame(b"abc"))
    bad[6] ^= 0xFF
    assert l2.parse_layer2_frame(bytes(bad)) is None
    assert l2.parse_layer2_frame(b"short") is None
    m = l2.PageMessage(target_callsign="N0CALL", source_callsign="M0ABC",
                       message="hello page")
    jm = jl2.PageMessage(target_callsign="N0CALL", source_callsign="M0ABC",
                         message="hello page")
    for rt in (False, True):
        wire = l2.page_message_to_proto(m, retransmit=rt)
        assert wire == jl2.page_message_to_proto(jm, retransmit=rt)
        assert l2.page_message_from_proto(wire) == m
    chans = [(1, 0, "Main", "Main channel"), (2, 1, "Sub", "")]
    users = [(7, "op1", 100, 1), (300, "op2", 70_000, 2)]
    wire = l2.repeater_info_to_proto(chans, users)
    assert wire == jl2.repeater_info_to_proto(chans, users)
    assert l2.repeater_info_from_proto(wire) == (chans, users)


def test_limits_and_logger_match_jax(tmp_path):
    assert limits.TX_LIMITS == jlimits.TX_LIMITS
    for f in (0, 1_810_000, 1_900_000, 145_500_000, 146_000_000,
              434_000_000, 10_100_000_000, 11_000_000_000):
        assert limits.check_limit(f) == jlimits.check_limit(f)
        assert limits.get_rfe_band(f) == jlimits.get_rfe_band(f)
    log = logger.get_logger("qradiolink_tpu_torch.test",
                            logfile=tmp_path / "log" / "q.log",
                            console=False)
    log.info("hello %d", 7)
    for h in log.handlers:
        h.flush()
    assert "INFO: hello 7" in (tmp_path / "log" / "q.log").read_text()
    assert logger.get_logger("qradiolink_tpu_torch.test") is log
