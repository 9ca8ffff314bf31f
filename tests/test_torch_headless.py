"""The headless service in the port (app/command.py, app/telnet.py,
app/gpredict.py, the CLI's `headless`) against the JAX package's, on the
CPU:

- CommandProcessor: every verb of the reference's list served, and a
  script of every verb with valid and refused arguments answered with the
  JAX processor's text, leaving the same settings, the recorder's and the
  Mumble client's verbs among them (a recording in the working
  directory, a connection to a port that refuses it);
  tests/test_command.py's and tests/test_command_parity.py's cases on the
  port.
- TelnetServer: the same bytes on the wire as the JAX server for the same
  session.
- GPredict: the same replies and actions for a rigctld session
  (tests/test_limits_gpredict.py), and the server moving the carrier
  offset through the controller.
- `headless --udp --start-trx --device cpu` with ephemeral ports: a 4FSK2K
  transmission as cf32 datagrams decodes to its text, telnet verbs change
  the mode and PTT, `shutdown` ends the loop with 0.

Sockets take port 0; the UDP sender keeps a window of datagrams in flight
against the service's reads, so nothing waits on the clock.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu.app import command as jcommand  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.app import gpredict as jgpredict  # noqa: E402
from qradiolink_tpu.app import telnet as jtelnet  # noqa: E402
from qradiolink_tpu_torch import config  # noqa: E402
from qradiolink_tpu_torch.app import cli, command, gpredict, telnet  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from tests.test_command_parity import REFERENCE_VERBS  # noqa: E402

CPU = "cpu"
WAIT_S = 20.0


def _channels(mod):
    return mod.RadioChannels([
        mod.MemoryChannel(name="ch0", rx_frequency=430_100_000,
                          rx_mode="NBFM", tx_mode="NBFM"),
        mod.MemoryChannel(name="APRS", rx_frequency=144_800_000,
                          rx_mode="NBFM", tx_mode="NBFM")])


def _pair(**kw):
    """(port processor, JAX processor) on fresh controllers."""
    s, js = config.Settings(**kw), jconfig.Settings(**kw)
    p = command.CommandProcessor(ctl.RadioController(s, device=CPU),
                                 channels=_channels(config))
    j = jcommand.CommandProcessor(jctl.RadioController(js),
                                  channels=_channels(jconfig))
    return p, j


# every verb: 0-argument ones bare, the rest with a valid argument, a
# refused one, or none; the recorder's and the Mumble client's verbs come
# after (their handlers open files and connections: test_script_answers_
# as_jax runs them in a temporary directory, against a refusing port)
SCRIPT = [
    "rxstatus", "txstatus", "txactive", "rxmode", "txmode", "rxvolume",
    "txvolume", "squelch", "rssi", "voxstatus", "rxfreq", "txfreq",
    "voxlevel", "voipbitrate", "rxctcss", "txctcss", "rxgain", "txgain",
    "voipstatus", "forwardingstatus", "repeaterstatus", "duplexstatus",
    "agcattack", "agcdecay", "udpstatus", "voipvolume", "muteforwarding",
    "gettxlimits", "recordstatus", "list_modes", "listradiochan", "help",
    "?", "", "nosuchverb", "setsquelch", "bad;chars",
    "setrx 1", "rxstatus", "setrx 2", "setrx x", "settx 1", "txstatus",
    "setrxmode AM", "setrxmode 1", "setrxmode 999", "settxmode NBFM",
    "settxmode FM", "setsquelch -120", "setsquelch 999", "setsquelch x",
    "setrxvolume 55", "setrxvolume 101", "settxvolume 40",
    "tunerx 145500000", "tunerx x", "tunetx 145000000", "setoffset 5000",
    "setoffset 0", "setshift -600000", "setvox 1", "voxstatus",
    "setvox 0", "setcompressor 1", "setcompressor 3",
    "setrssicalibration -70", "setrssicalibration -300",
    "setvoxlevel 30", "voxlevel", "setvoipbitrate 9600",
    "setvoipbitrate 100", "ptt_on", "txactive", "ptt_off", "txactive",
    "textmsg hello", "start_trx", "stop_trx", "rxstatus",
    "setradiochan 1", "rxfreq", "setradiochan 9", "changechannel 0",
    "settxlimits 1", "gettxlimits", "settxlimits 0", "setrxctcss 88.5",
    "rxctcss", "setrxctcss 500", "settxctcss 67", "txctcss",
    "setrxgain 42", "setrxgain 200", "settxgain 7", "setduplex 1",
    "duplexstatus", "setforwarding 1", "forwardingstatus",
    "setrepeater 1", "repeaterstatus", "setmuteforwarding 1",
    "muteforwarding", "setpttvoip 1", "setudpenabled 1", "udpstatus",
    "autosquelch", "setfilterwidth 5000", "setfilterwidth 50",
    "setagcattack 5", "agcattack", "setagcdecay 250", "setagcdecay 9000",
    "setvoipvolume 55", "voipvolume", "setrxsamprate 2",
    "setrxsamprate 0", "setrelays 1", "disconnectserver", "mumblemsg hi",
    "mutemumble 1", "mutemumble 5", "connectserver host",
    "recordstatus", "setaudiorecorder 1", "recordstatus",
    "setaudiorecorder 7", "setaudiorecorder 0", "recordstatus",
    "connectserver 127.0.0.1 {refusing}", "voipstatus",
    "connectserver 127.0.0.1 x", "disconnectserver", "mumblemsg hi",
    "mutemumble 0", "shutdown",
]


def test_every_reference_verb_served_as_in_jax():
    """tests/test_command_parity.py:57-72: the port serves every verb of
    the reference's list, with the JAX table's arity and help text."""
    p, j = _pair()
    missing = [v for v in REFERENCE_VERBS if v not in p._commands]
    assert not missing, f"verbs missing from CommandProcessor: {missing}"
    assert {k: v[:2] for k, v in p._commands.items()} == \
        {k: v[:2] for k, v in j._commands.items()}
    for verb in REFERENCE_VERBS:
        if not p._commands[verb][0]:
            resp = p.process(verb)
            assert resp != "Command not recognized", verb
            assert "Command failed" not in resp, (verb, resp)


def test_script_answers_as_jax(tmp_path, monkeypatch):
    """Every line of SCRIPT: the JAX processor's reply, the same settings
    after, the same chain state (modes, transmitting). The recordings go
    to the working directory (a temporary one); `connectserver` meets a
    port that is bound but does not listen."""
    monkeypatch.chdir(tmp_path)
    p, j = _pair()
    refusing = socket.socket()
    refusing.bind(("127.0.0.1", 0))
    port = refusing.getsockname()[1]
    script = [line.format(refusing=port) for line in SCRIPT]
    try:
        _run_script(p, j, script)
    finally:
        refusing.close()
    assert p.shutdown_requested and j.shutdown_requested
    # one recording a processor, named by the second it started in (the
    # two may share a name)
    recs = list(tmp_path.iterdir())
    assert 1 <= len(recs) <= 2
    assert all(r.name.startswith("rec-") and r.suffix == ".flac"
               for r in recs)
    assert p.settings.voip_port == port


def _run_script(p, j, script):
    for line in script:
        assert p.process(line) == j.process(line), line
        assert dataclasses.asdict(p.settings) == \
            dataclasses.asdict(j.settings), line
        assert (p.ctl._rx_mode, p.ctl._tx_mode, p.ctl.transmitting,
                p.ctl._rx is None, p.ctl._tx is None) == \
            (j.ctl._rx_mode, j.ctl._tx_mode, j.ctl.transmitting,
             j.ctl._rx is None, j.ctl._tx is None), line


def test_status_and_set_verbs():
    """tests/test_command.py:24-45."""
    p, _ = _pair(rx_mode="NBFM", tx_mode="NBFM")
    c = p.ctl
    assert p.process("rxstatus") == "RX inactive"
    assert "Starting receiver" in p.process("setrx 1")
    assert p.process("rxstatus") == "RX active"
    assert "NBFM" in p.process("rxmode")
    assert "Setting squelch" in p.process("setsquelch -120")
    assert c.settings.squelch_db == -120
    assert p.process("setsquelch 999") == "Parameter value is not supported"
    assert "Tuning receiver to 145500000" in p.process("tunerx 145500000")
    assert p.process("rxfreq") == "145500000"
    assert "Setting RX volume" in p.process("setrxvolume 55")
    assert abs(c.settings.rx_volume - 0.55) < 1e-9
    assert "Setting demodulator offset" in p.process("setoffset 5000")
    assert c._rotator is not None
    assert p.process("nosuchverb") == "Command not recognized"
    assert p.process("setsquelch") == \
        "Command parameters are missing or incorrect"
    assert "Available commands" in p.process("help")
    assert "rxstatus" in p.process("?")


def test_mode_switch_ptt_channels_and_chain_rebuilds():
    """tests/test_command.py:48-70 and tests/test_command_parity.py:87-126:
    list_modes' index, PTT, memory channels, the CTCSS and filter-width
    verbs rebuilding the NBFM chain on the controller's device."""
    p, _ = _pair()
    modes = p.process("list_modes").splitlines()
    am = next(i for i, m in enumerate(modes) if m.endswith(" AM"))
    assert "Setting RX mode to AM" in p.process(f"setrxmode {am}")
    assert p.ctl._rx_mode == "AM"
    assert "PTT on" in p.process("ptt_on") and p.ctl.transmitting
    assert "PTT off" in p.process("ptt_off") and not p.ctl.transmitting
    p.process("setrxmode NBFM")
    assert p.ctl._rx.ctcss is None
    assert "88.5" in p.process("setrxctcss 88.5")
    assert p.ctl._rx.ctcss is not None and p.ctl._rx.device.type == CPU
    base = p.ctl._rx.chan_filter.ntaps
    assert "5000" in p.process("setfilterwidth 5000")
    assert p.ctl._rx.chan_filter.ntaps != base
    assert "APRS" in p.process("listradiochan")
    assert "Changing to memory channel APRS" in p.process("setradiochan 1")
    assert p.settings.rx_frequency == 144_800_000
    p.ctl.last_rssi = -120.0
    p.settings.rssi_calibration_value = -80
    assert "-70" in p.process("autosquelch")
    assert p.settings.squelch_db == -70.0
    assert "Shutting down" in p.process("shutdown") and p.shutdown_requested


def _telnet_session(server, lines):
    """The bytes a telnet client reads: the banner, then each line's
    reply up to its CRLF, then what is left when the server ends it."""
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=WAIT_S) as c:
        f = c.makefile("rwb")
        got = [f.readline(), f.readline()]
        for line in lines:
            f.write(line.encode() + b"\n")
            f.flush()
            if line == "quit" or line == "shutdown":
                got.append(f.read())
                break
            reply = f.readline()
            while reply and not reply.endswith(b"\r\n"):
                reply += f.readline()   # a reply of several lines
            got.append(reply)
        return got


@pytest.mark.parametrize("last", ["quit", "shutdown"])
def test_telnet_bytes_match_jax(last):
    """The same session on the port's TelnetServer and the JAX one: the
    same bytes; `shutdown` stops the server's flag in both."""
    lines = ["rxstatus", "setrxmode AM", "rxmode", "ptt_on", "txactive",
             "ptt_off", "list_modes", "nosuchverb", last]
    out, servers = [], []
    for mod_t, proc in ((telnet, _pair()[0]), (jtelnet, _pair()[1])):
        srv = mod_t.TelnetServer(proc, port=0)
        srv.start()
        try:
            out.append(_telnet_session(srv, lines))
            servers.append((srv.shutdown_requested, proc.ctl._rx_mode))
        finally:
            srv.stop()
    assert out[0] == out[1]
    assert out[0][0].startswith(b"Welcome")
    assert servers[0] == servers[1] == (last == "shutdown", "AM")


def test_gpredict_matches_jax():
    """tests/test_limits_gpredict.py:24-38 on the port, and a rigctld
    session giving the JAX control's replies and actions."""
    s, js = config.Settings(), jconfig.Settings()
    for x in (s, js):
        x.rx_frequency = 435_000_000
        x.demod_offset = 0
        x.tx_shift = 1_000
    gp = gpredict.GPredictControl(s, lnb_lo_freq=0)
    jgp = jgpredict.GPredictControl(js, lnb_lo_freq=0)
    reply, act = gp.process_messages("F 435003000\n")
    assert reply == "RPRT 0\n"
    assert act.action == gpredict.OFFSET_RX and act.rx_freq_delta == 3_000
    assert gp.process_messages("f\n")[0].startswith("f: 435000000")
    reply, act = gp.process_messages("F 437500000\n")
    assert act.action == gpredict.TUNE_RX and act.rx_freq == 437_500_000
    jgp.process_messages("F 435003000\n")
    jgp.process_messages("F 437500000\n")
    session = ["f", "i", "F 437504000", "F 437570000", "I 145801000",
               "I 145801400", "I 145900000", "S 1 VFOB", "F 1000",
               "I 27000000", "F 437504000\nf", "\n", "X"]
    for msg in session:
        (r, a), (jr, ja) = gp.process_messages(msg + "\n"), \
            jgp.process_messages(msg + "\n")
        assert r == jr and dataclasses.asdict(a) == dataclasses.asdict(ja)
    assert (gpredict.NO_ACTION, gpredict.TUNE_RX, gpredict.TUNE_TX,
            gpredict.OFFSET_RX, gpredict.OFFSET_TX,
            gpredict.DOPPLER_RETUNE_HZ) == \
        (jgpredict.NO_ACTION, jgpredict.TUNE_RX, jgpredict.TUNE_TX,
         jgpredict.OFFSET_RX, jgpredict.OFFSET_TX,
         jgpredict.DOPPLER_RETUNE_HZ)


def test_gpredict_server_applies_offsets():
    """tests/test_limits_gpredict.py:41-59: Doppler offsets reach the
    controller's rotator on its device; a retune moves the frequency."""
    s = config.Settings()
    s.rx_frequency = 435_000_000
    c = ctl.RadioController(s, device=CPU)
    srv = gpredict.GPredictServer(c, port=0)
    srv.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=WAIT_S) as conn:
            f = conn.makefile("rwb")
            for msg, offset in ((b"F 435004000\n", 4_000),
                                (b"F 435004500\n", 4_500)):
                f.write(msg)
                f.flush()
                assert f.readline() == b"RPRT 0\n"
                assert s.demod_offset == offset
            assert c._rotator is not None
            f.write(b"F 436000000\n")
            f.flush()
            assert f.readline() == b"RPRT 0\n"
            assert s.rx_frequency == 436_000_000 - 4_500
    finally:
        srv.stop()


def test_headless_flags_parse_as_jax():
    """tests/test_app.py:517-528, and every flag of the JAX `headless`
    with its default; the port adds --device (default the card)."""
    from qradiolink_tpu.app import cli as jcli
    argv = ["headless", "--start-trx", "--ptt", "--udp", "--gpredict",
            "--net", "--mmdvm", "--rx-mode", "DMR", "--tx-mode", "M17"]
    for a in (["headless"], argv):
        got = vars(cli.build_parser().parse_args(a))
        want = vars(jcli.build_parser().parse_args(a))
        assert got.pop("device") == "cuda"
        got.pop("fn"), want.pop("fn")
        assert got == want
    got = vars(cli.build_parser().parse_args(["mmdvm-proxy"]))
    want = vars(jcli.build_parser().parse_args(["mmdvm-proxy"]))
    got.pop("fn"), want.pop("fn")
    assert got == want


class CountedSocket:
    """The service's UDP socket, counting its reads (the sender's window
    waits on this count)."""

    def __init__(self, sock):
        self.sock = sock
        self.reads = 0

    def recvfrom(self, n):
        out = self.sock.recvfrom(n)
        self.reads += 1
        return out

    def __getattr__(self, name):
        return getattr(self.sock, name)


def send_windowed(sink, counted, iq, window=64):
    """sink.write a datagram at a time, no more than `window` ahead of the
    service's reads (the socket's buffer holds them all)."""
    sent = 0
    for i in range(0, iq.size, sink.chunk):
        while sent - counted.reads >= window:
            time.sleep(0.0005)
        sink.write(iq[i:i + sink.chunk])
        sent += 1


def test_headless_service_end_to_end():
    """`headless --udp --start-trx --rx-mode 4FSK2K --device cpu` on
    ephemeral ports, its loop in a thread: telnet verbs change the mode
    and back and key PTT; a 4FSK2K transmission of a text sent as cf32
    datagrams decodes to the text; `shutdown` ends the loop with 0."""
    from qradiolink_tpu_torch.framing.layer1 import FrameType
    from qradiolink_tpu_torch.io.iq import UdpIqSink

    text = "hello headless"
    s = config.Settings(tx_mode="4FSK2K")
    tx = ctl.RadioController(s, device=CPU)
    tx.toggle_tx_mode("4FSK2K")
    pre = tx._framer.frame(b"\xaa" * 64, FrameType.VOICE_1) * 6
    iq = np.concatenate([tx.tx_bytes(pre), tx.tx_text(text),
                         np.zeros(60_000, np.complex64)])
    iq = np.concatenate([iq, np.zeros((-iq.size) % 125_000, np.complex64)])
    args = cli.build_parser().parse_args(
        ["headless", "--udp", "--udp-port", "0", "--control-port", "0",
         "--rx-mode", "4FSK2K", "--start-trx", "--device", "cpu"])
    svc = cli.HeadlessService(args)
    events, done = [], []
    inner = svc.ctl.rx_block

    def rx_block(b):
        new = inner(b)
        events.extend(new)
        done.append(1)
        return new

    svc.ctl.rx_block = rx_block
    counted = CountedSocket(svc.src.sock)
    svc.src.sock = counted
    rc = {}
    th = threading.Thread(target=lambda: rc.update(v=svc.run()),
                          daemon=True)
    th.start()
    try:
        replies = _telnet_session(svc.telnet, [
            "rxstatus", "setrxmode NBFM", "rxmode", "setrxmode 4FSK2K",
            "ptt_on", "txactive", "ptt_off"])
        assert replies[2:] == [b"RX active\r\n",
                               b"Setting RX mode to NBFM\r\n", b"NBFM\r\n",
                               b"Setting RX mode to 4FSK2K\r\n",
                               b"PTT on\r\n", b"transmitting\r\n",
                               b"PTT off\r\n"]
        sink = UdpIqSink(svc.src.sock.getsockname()[1])
        send_windowed(sink, counted, iq)
        sink.close()
        n_blocks = iq.size // 125_000
        end = time.monotonic() + 120
        while len(done) < n_blocks and time.monotonic() < end:
            time.sleep(0.01)
        got = "".join(e.text for e in events if e.kind == "text")
        assert text in got, got
        bye = _telnet_session(svc.telnet, ["shutdown"])
        assert bye[2] == b"Shutting down\r\n"
        th.join(timeout=WAIT_S)
        assert rc.get("v") == 0 and not th.is_alive()
    finally:
        if th.is_alive():
            svc.telnet.server.stop_flag.set()
            th.join(timeout=WAIT_S)
    assert svc.src.sock.fileno() == -1
