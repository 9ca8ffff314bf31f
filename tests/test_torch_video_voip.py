"""The port's video and VOIP modules (video/jpeg.py, voip/mumble.py,
voip/forwarder.py), the controller's video branches and the command
processor's recorder and Mumble verbs, against the JAX package's, on the
CPU:

- JPEG air frames byte for byte equal to the JAX encoder's (a structured
  frame, a frame that needs a lower quality, a frame of another size) and
  decoded to the same pixels; the last-good fallback.
- tx_video_frame: the QPSKVideo IQ within VIDEO_TX_TOL of the peak of the
  JAX controller's. The RX `video` event: the frame's bits through each
  controller's deframer and dispatch (its QpskDemod stands in by the
  bits it would give: the port's plain PSK loops take about 150 us a
  sample on the CPU, and one 3,122-byte frame is about 200,000 samples;
  the RF path runs on the card in chip_smoke.py), the same event, bytes
  and pixels.
- Mumble: varints equal, each package reading the other's; a session with
  tests/test_mumble.py's fake server: the bytes the server receives (the
  ping's clock field aside), the client's state and its callbacks equal;
  the voice packet's layout.
- VoipForwarder: text remote control answered as the JAX forwarder does;
  Opus voice out and back through the mixer (the same packets and frame).
- CommandProcessor: `connectserver` (to a fake server, and to a port that
  refuses), `voipstatus`, `mumblemsg`, `mutemumble`, `disconnectserver`,
  `recordstatus` and `setaudiorecorder` (a FLAC of the RX audio between
  `setaudiorecorder 1` and `0`) answered with the JAX processor's text.
"""

import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu import video as jvideo  # noqa: E402
from qradiolink_tpu.app import command as jcommand  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.audio import codecs as jcodecs  # noqa: E402
from qradiolink_tpu.voip import forwarder as jforwarder  # noqa: E402
from qradiolink_tpu.voip import mumble as jmumble  # noqa: E402
from qradiolink_tpu_torch import config, video  # noqa: E402
from qradiolink_tpu_torch.app import command  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.audio import codecs  # noqa: E402
from qradiolink_tpu_torch.audio.flac import read_flac  # noqa: E402
from qradiolink_tpu_torch.framing.layer1 import (  # noqa: E402
    FrameType, Layer1Framer)
from qradiolink_tpu_torch.voip import forwarder, mumble  # noqa: E402
from tests.test_mumble import FakeServer  # noqa: E402

CPU = "cpu"
VIDEO_TX_TOL = 6.25e-6   # the QPSKVideo IQ, relative to the peak
WAIT_S = 10.0


def _test_image():
    """tests/test_video.py:12-19: 320x240 gradient and blocks."""
    y, x = np.mgrid[0:240, 0:320]
    return np.stack([(x * 255 // 320).astype(np.uint8),
                     (y * 255 // 240).astype(np.uint8),
                     (((x // 40 + y // 40) % 2) * 200).astype(np.uint8)],
                    axis=-1)


IMAGES = {
    "structured": _test_image,
    "noise": lambda: np.random.default_rng(5).integers(
        0, 256, (240, 320, 3), dtype=np.uint8),
    "resized": lambda: _test_image()[::2, ::2].copy(),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_jpeg_frame_equals_jax(name):
    img = IMAGES[name]()
    frame = video.encode_jpeg_frame(img)
    assert frame == jvideo.encode_jpeg_frame(img)
    assert len(frame) == video.VIDEO_FRAME_BYTES == jvideo.VIDEO_FRAME_BYTES
    got, want = video.decode_jpeg_frame(frame), jvideo.decode_jpeg_frame(frame)
    assert got is not None and got.shape == (240, 320, 3)
    np.testing.assert_array_equal(got, want)
    if name == "structured":
        assert np.mean(np.abs(got.astype(int) - img.astype(int))) < 20


def test_video_encoder_fallback_matches_jax():
    """tests/test_video.py:22-37: a corrupt size field gives the last good
    frame; garbage before any good frame gives None."""
    frame = video.encode_jpeg_frame(_test_image())
    bad = b"\xff\xff\xff\xff" + frame[4:]
    for mod in (video, jvideo):
        enc = mod.VideoEncoder()
        assert enc.decode(bad) is None and enc.decode(b"\x01") is None
        good = enc.decode(frame)
        np.testing.assert_array_equal(enc.decode(bad), good)
        assert enc.encode(_test_image()) == frame


def _settings(cls, **kw):
    s = cls()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _pair(**kw):
    """(JAX controller, port controller on the CPU)."""
    return (jctl.RadioController(_settings(jconfig.Settings, **kw)),
            ctl.RadioController(_settings(config.Settings, **kw),
                                device=CPU))


def test_tx_video_frame_matches_jax():
    """tests/test_video.py:69-84's TX: preamble, the frame, a tail; each
    part's IQ within VIDEO_TX_TOL of the peak of the JAX controller's."""
    img = _test_image()
    parts = []
    for c in _pair(rx_mode="QPSKVideo", tx_mode="QPSKVideo"):
        c.toggle_tx_mode("QPSKVideo")
        parts.append([c.tx_bytes(b"\xaa" * 300), c.tx_video_frame(img),
                      c.tx_bytes(b"\xaa" * 300)])
    for want, got in zip(*parts):
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= \
            VIDEO_TX_TOL * float(np.abs(want).max())
    # a controller in another TX mode switches to QPSKVideo
    _, c = _pair(tx_mode="4FSK2K")
    c.toggle_tx_mode("4FSK2K")
    assert c.tx_video_frame(img).size and c._tx_mode == "QPSKVideo"


class _Bits:
    """A chain that gives the bits of `data`, a slice a call, as QpskDemod
    would give them for the IQ of those bytes: (state, {"bits": ...})."""

    def __init__(self, data, as_tensor):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos, self.as_tensor = 0, as_tensor

    def __call__(self, state, iq):
        n = iq.shape[-1] // 8
        b = self.bits[self.pos:self.pos + n]
        self.pos += n
        return state, {"bits": torch.from_numpy(b) if self.as_tensor else b}


def test_rx_video_event_matches_jax():
    """The frame's bits in 50,000-sample blocks through each controller's
    rx_block: one `video` event, its payload the frame sent, its image the
    frame decoded; then a corrupt frame repeats the last good image."""
    img = _test_image()
    frame = video.encode_jpeg_frame(img)
    framer = Layer1Framer("QPSKVideo")
    corrupt = b"\x00\x00\x01\x00" + frame[4:]
    data = (b"\xaa" * 400 + framer.frame(frame, FrameType.VIDEO)
            + framer.frame(corrupt, FrameType.VIDEO) + framer.end_frame()
            + b"\xaa" * 800)
    events = []
    for c in _pair(rx_mode="QPSKVideo", tx_mode="QPSKVideo"):
        c.toggle_rx_mode("QPSKVideo")
        c._rx = _Bits(data, isinstance(c, ctl.RadioController))
        blocks = np.zeros(-(-len(data) * 64 // 50_000) * 50_000,
                          np.complex64).reshape(-1, 50_000)
        events.append([e for b in blocks for e in c.rx_block(b)])
    want, got = events
    assert [e.kind for e in got] == [e.kind for e in want]
    vids = [e for e in got if e.kind == "video"]
    assert len(vids) == 2 and vids[0].payload == frame
    for w, g in zip(want, got):
        assert (g.payload, g.sample_time, g.frame_type) == \
            (w.payload, w.sample_time, w.frame_type)
        if w.kind == "video":
            np.testing.assert_array_equal(g.image, w.image)
    np.testing.assert_array_equal(vids[0].image, video.decode_jpeg_frame(
        frame))
    np.testing.assert_array_equal(vids[1].image, vids[0].image)


# ---------------------------------------------------------------- Mumble
VARINTS = (0, 1, 127, 128, 300, 16383, 16384, 2_000_000, 0x1FFFFF,
           0x200000, 200_000_000, 0xFFFFFFF, 0x10000000, 2**40)


def test_mumble_varints_match_jax():
    for v in VARINTS:
        data = mumble.mumble_varint(v)
        assert data == jmumble.mumble_varint(v)
        assert mumble.read_mumble_varint(data, 0) == (v, len(data))
        assert jmumble.read_mumble_varint(b"\x07" + data, 1) == \
            (v, len(data) + 1)
    for mod in (mumble, jmumble):
        with pytest.raises(ValueError, match="unsupported varint prefix"):
            mod.read_mumble_varint(b"\xf8", 0)


def _received(srv):
    """The server's messages, the ping's clock field zeroed."""
    return [(t, jmumble._pb_uint(1, 0) if t == jmumble.MSG_PING else p)
            for t, p in srv.received]


def _wait(cl, done):
    end = time.monotonic() + WAIT_S
    while not done() and time.monotonic() < end:
        cl.poll()
        time.sleep(0.005)
    assert done()


def _session(mod):
    """tests/test_mumble.py:92-128's session with `mod`'s client: returns
    what the client saw and the messages the server received."""
    srv = FakeServer()
    srv.start()
    cl = mod.MumbleClient("127.0.0.1", srv.port, username="N0CALL",
                          password="pw", use_ssl=False)
    ev = {"text": [], "voice": [], "joined": [], "connected": []}
    cl.on_text = lambda m, s, ch: ev["text"].append((m, s, ch))
    cl.on_voice = lambda sid, opus: ev["voice"].append((sid, opus))
    cl.on_user_joined = lambda st: ev["joined"].append(
        (st.id, st.callsign, st.channel_id))
    cl.on_connected = lambda sid: ev["connected"].append(sid)
    cl.connect()
    _wait(cl, lambda: cl.synchronized)
    cl.join_channel(7)
    cl.set_self_mute(True)
    cl.set_self_deaf(False)
    cl.send_text("hello net")
    cl.send_text("direct", session=33)
    cl.send_opus_voice(b"\x01\x02\x03\x04fake-opus")
    cl.send_opus_voice(b"second", target=3)
    _wait(cl, lambda: len(ev["text"]) == 2 and len(ev["voice"]) == 2)
    state = dict(session=cl.session, current=cl.current_channel,
                 channels={k: (c.parent, c.name)
                           for k, c in cl.channels.items()},
                 stations={k: (s.callsign, s.channel_id)
                           for k, s in cl.stations.items()}, seq=cl._seq)
    cl.close()
    srv.join(timeout=5)
    return ev, state, _received(srv)


def test_mumble_session_matches_jax():
    jev, jstate, jrecv = _session(jmumble)
    pev, pstate, precv = _session(mumble)
    assert pev == jev and pstate == jstate and precv == jrecv
    assert pstate["session"] == 42 and pstate["channels"][7][1] == "Radio"
    assert pev["voice"][0] == (33, b"\x01\x02\x03\x04fake-opus")
    assert pev["joined"] == [(33, "K1OTH", 7)]
    types = [t for t, _ in precv]
    assert types[:2] == [jmumble.MSG_VERSION, jmumble.MSG_AUTHENTICATE]
    tun = [p for t, p in precv if t == jmumble.MSG_UDPTUNNEL]
    assert tun[0][0] >> 5 == mumble.VOICE_OPUS
    seq, pos = mumble.read_mumble_varint(tun[0], 1)
    ln, pos = mumble.read_mumble_varint(tun[0], pos)
    assert seq == 0 and tun[0][pos:pos + (ln & 0x1FFF)] == \
        b"\x01\x02\x03\x04fake-opus"
    assert tun[1][0] == (mumble.VOICE_OPUS << 5) | 3


class _StubClient:
    """tests/test_mumble.py's stub: records what the forwarder sends."""
    synchronized = True

    def __init__(self):
        self.on_voice = self.on_text = None
        self.sent, self.packets = [], []

    def send_text(self, m, **kw):
        self.sent.append(m)

    def send_opus_voice(self, p, **kw):
        self.packets.append(p)


def test_forwarder_text_control_matches_jax():
    """tests/test_mumble.py:153-180: a private text is a command, answered
    by text; a channel text is ignored."""
    sent = []
    for fwd_mod, cmd_mod, c in zip((jforwarder, forwarder),
                                   (jcommand, command), _pair()):
        cl = _StubClient()
        fwd_mod.VoipForwarder(cl, codec=None,
                              command_processor=cmd_mod.CommandProcessor(c))
        for text, channel in (("rxstatus", False), ("chat chatter", True),
                              ("setrxvolume 40", False), ("nosuch", False),
                              ("rxvolume", False)):
            cl.on_text(text, "op", channel)
        sent.append(cl.sent)
    assert sent[1] == sent[0] and len(sent[1]) == 4
    assert "RX inactive" in sent[1][0]


@pytest.mark.skipif(not codecs.opus_available(), reason="opus missing")
def test_forwarder_voice_matches_jax():
    """tests/test_mumble.py:183-213: two 40 ms Opus packets out of 640
    samples of a tone, the first looped back as user 33's voice and mixed:
    the same packets and frame in both packages; nothing goes out when the
    client is not synchronized."""
    t = np.arange(700) / 8000.0
    tone = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    outs = []
    for fwd_mod, enc in ((jforwarder, jcodecs.AudioEncoder()),
                         (forwarder, codecs.AudioEncoder())):
        cl = _StubClient()
        fwd = fwd_mod.VoipForwarder(cl, codec=enc)
        fwd.radio_rx_audio(tone)
        fwd.radio_rx_audio((tone * 20000).astype(np.int16))
        cl.on_voice(33, cl.packets[0])
        cl.on_voice(34, b"\xff")
        frame = fwd.mixed_frame()
        cl.synchronized = False
        fwd.radio_rx_audio(tone)
        outs.append((cl.packets, frame, fwd.mixed_frame()))
    (jp, jf, jn), (pp, pf, pn) = outs
    assert pp == jp and len(pp) == 4
    np.testing.assert_array_equal(pf, jf)
    assert pf.shape == (320,) and np.abs(pf).max() > 500
    assert pn is None and jn is None


# ------------------------------------------------------ command processor
def _processors(**kw):
    j, p = _pair(**kw)
    return jcommand.CommandProcessor(j), command.CommandProcessor(p)


def _refusing_port():
    """A TCP port bound but not listening: a connection is refused."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    return s


def test_mumble_verbs_answer_as_jax():
    """connectserver to a refusing port (the handler makes its
    MumbleClient, TLS as the reference's, and its connect fails), then,
    with a plain-TCP client of each package attached, to that package's
    fake server; the VOIP verbs while connected and after
    disconnectserver."""
    procs = _processors()
    refusing = _refusing_port()
    try:
        port = refusing.getsockname()[1]
        answers = [[pr.process(f"connectserver 127.0.0.1 {port}"),
                    pr.process("voipstatus")] for pr in procs]
    finally:
        refusing.close()
    assert answers[1] == answers[0]
    assert answers[1][0].startswith("Could not connect to server: ")
    assert isinstance(procs[1].voip, mumble.MumbleClient)
    assert procs[1].settings.voip_port == port
    recv = []
    for pr, mod, ans in zip(_processors(), (jmumble, mumble), answers):
        srv = FakeServer()
        srv.start()
        pr.voip = mod.MumbleClient("127.0.0.1", srv.port, use_ssl=False)
        ans.append(pr.process(f"connectserver 127.0.0.1 {srv.port}"))
        _wait(pr.voip, lambda: pr.voip.synchronized)
        for line in ("voipstatus", "mumblemsg hello", "mutemumble 1",
                     "mutemumble 7", "disconnectserver", "voipstatus",
                     "mumblemsg late", "mutemumble 0", "connectserver x y"):
            ans.append(pr.process(line))
        assert pr.settings.voip_port == srv.port
        srv.join(timeout=5)
        recv.append(_received(srv))
        ans[2] = ans[2].replace(str(srv.port), "PORT")
    assert answers[1] == answers[0]
    assert answers[1][2:5] == ["Connecting to server 127.0.0.1 port PORT",
                               "VOIP connected", "Sending message: hello"]
    assert recv[1] == recv[0]
    assert any(t == jmumble.MSG_TEXTMESSAGE for t, _ in recv[1])


def test_recorder_verbs_answer_as_jax(tmp_path, monkeypatch, rng):
    """setaudiorecorder opens an AudioRecorder in the working directory
    (the JAX handler's), the controller's RX audio goes to it, and
    `setaudiorecorder 0` writes the FLAC: the JAX processor's answers and
    the JAX controller's file, byte for byte. The FM chain stands in by
    the audio it would give (_Audio): the same float blocks reach both
    controllers' dispatch."""
    blocks = [(0.4 * rng.standard_normal(400)).astype(np.float32)
              for _ in range(3)]
    answers, files = [], []
    for pr, sub in zip(_processors(rx_mode="FM", rx_volume=0.8),
                       ("jax", "port")):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.chdir(d)
        a = [pr.process(v) for v in ("recordstatus", "setaudiorecorder 7",
                                     "setaudiorecorder 1", "recordstatus")]
        pr.ctl.toggle_rx_mode("FM")
        pr.ctl._rx = _Audio(blocks, isinstance(pr.ctl, ctl.RadioController))
        events = [e for _ in blocks for e in pr.ctl.rx_block(
            np.zeros(50_000, np.complex64))]
        assert [e.kind for e in events] == ["audio"] * 3
        a += [pr.process(v) for v in ("setaudiorecorder 0", "recordstatus",
                                      "setaudiorecorder 0")]
        answers.append(a)
        (f,) = list(d.iterdir())
        files.append(f)
    assert answers[1] == answers[0]
    assert answers[1][:4] == ["Not recording",
                              "Parameter value is not supported",
                              "Setting audio recording to 1", "Recording"]
    assert files[1].name.startswith("rec-") and files[1].suffix == ".flac"
    assert files[1].read_bytes() == files[0].read_bytes()
    y, rate = read_flac(files[1])
    want = np.clip(np.concatenate(blocks) * np.float32(0.8) * 32767.0,
                   -32767, 32767).astype(np.int16)
    assert rate == 8000
    np.testing.assert_array_equal(y, want)


class _Audio:
    """A chain that gives the next of `blocks` as its audio output."""

    def __init__(self, blocks, as_tensor):
        self.blocks, self.as_tensor = list(blocks), as_tensor

    def __call__(self, state, iq):
        a = self.blocks.pop(0)
        return state, {"audio": torch.from_numpy(a) if self.as_tensor
                       else a}
