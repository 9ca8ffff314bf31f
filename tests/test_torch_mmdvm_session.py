"""MMDVM's session and transports in the port (framing/tdma.py,
io/mmdvm_transport.py, app/mmdvm_session.py, io/zmq_proxy.py, the
controller's MMDVM paths and the CLI's mmdvm-proxy) against the JAX
package's, on the CPU: the wire bytes, BurstTimer and slot_mask equal;
RadioController in MMDVM and MMDVMmulti publishing the same 720-sample
slots as the JAX controller on the same IQ (int16 samples and rssi
within one step: the chains agree within 5e-6 of the peak,
tests/test_torch_freedv_mmdvm.py, and the slots truncate to integers)
and modulating the same polled bursts (IQ within that file's TX bounds
of the peak); the cases of tests/test_io.py, tests/test_mmdvm_session.py
and tests/test_chains_mmdvm.py on the port.

Every ipc path lives in a temporary directory of the test, never
/tmp/mmdvm-*, and each peer waits on its peer (a PUSH socket's POLLOUT, a
receive with a generous deadline), not on the clock.
"""

import functools
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
zmq = pytest.importorskip("zmq")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.app import mmdvm_session as jms  # noqa: E402
from qradiolink_tpu.framing import tdma as jtdma  # noqa: E402
from qradiolink_tpu.io import mmdvm_transport as jmt  # noqa: E402
from qradiolink_tpu_torch import config  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.app import mmdvm_session as ms  # noqa: E402
from qradiolink_tpu_torch.chains import mmdvm  # noqa: E402
from qradiolink_tpu_torch.core import get_iq  # noqa: E402
from qradiolink_tpu_torch.framing import tdma  # noqa: E402
from qradiolink_tpu_torch.io import mmdvm_transport as mt  # noqa: E402
from qradiolink_tpu_torch.models.registry import MODES, get_mode  # noqa: E402

CPU = "cpu"
SLOT = mt.SAMPLES_PER_SLOT
WAIT_MS = 20_000             # a peer's deadline
MMDVM_TX_TOL = 3e-3          # tests/test_torch_freedv_mmdvm.py
MULTI_TX_TOL = 6e-3


@pytest.fixture
def ipc(tmp_path_factory):
    """Socket path templates in a short temporary directory (an ipc path
    must fit in 107 bytes)."""
    d = tmp_path_factory.mktemp("mm")
    return {k: f"ipc://{d}/{k}{{}}.ipc" for k in ("rx", "tx", "jrx", "jtx")}


def wait_peers(publisher):
    """Until every PUSH socket of the publisher has a connected peer."""
    for s in publisher.socks:
        assert s.poll(WAIT_MS, zmq.POLLOUT), "no peer connected"


def pull(path):
    p = zmq.Context.instance().socket(zmq.PULL)
    p.setsockopt(zmq.RCVTIMEO, WAIT_MS)
    p.connect(path)
    return p


def rep_at(path):
    """A REP peer bound at path whose receives give up at the deadline (a
    serving thread always ends before its socket closes)."""
    r = zmq.Context.instance().socket(zmq.REP)
    r.setsockopt(zmq.RCVTIMEO, WAIT_MS)
    r.bind(path)
    return r


def tone(n, freq=1000.0, amp=0.15, rows=()):
    t = np.arange(n) / mmdvm.TARGET_RATE
    ph = np.arange(int(np.prod(rows)) or 1).reshape(rows + (1,)) / 8 \
        if rows else 0.0
    return (amp * np.sin(2 * np.pi * freq * t + ph)).astype(np.float32)


def tone_snr(audio, freq):
    """tests/test_chains_mmdvm._tone_snr_db."""
    x = audio - audio.mean()
    sp = np.abs(np.fft.rfft(x * np.hanning(x.size))) ** 2
    f = np.fft.rfftfreq(x.size, 1 / mmdvm.TARGET_RATE)
    sig = sp[np.abs(f - freq) < 150].sum()
    noise = sp[(np.abs(f - freq) >= 150) & (f > 50) & (f < 4000)].sum()
    return 10 * np.log10(sig / (noise + 1e-12))


# ------------------------------------------------------------- wire, TDMA


def test_wire_format_matches_jax():
    samples = (np.arange(720) - 360).astype(np.int16)
    control = np.zeros(720, np.uint8)
    control[0] = mt.MARK_SLOT1
    msg = mt.pack_rx_message(samples, control, rssi=42)
    assert msg == jmt.pack_rx_message(samples, control, rssi=42)
    assert len(msg) == 8 + 720 + 1440
    s2, c2, rssi = mt.unpack_rx_message(msg)
    np.testing.assert_array_equal(s2, samples)
    np.testing.assert_array_equal(c2, control)
    assert rssi == 42
    tmsg = mt.pack_tx_message(samples, control)
    assert tmsg == jmt.pack_tx_message(samples, control)
    s3, c3 = mt.unpack_tx_message(tmsg)
    np.testing.assert_array_equal(s3, samples)
    np.testing.assert_array_equal(c3, control)
    assert (mt.MARK_NONE, mt.MARK_SLOT1, mt.MARK_SLOT2, SLOT) == \
        (jmt.MARK_NONE, jmt.MARK_SLOT1, jmt.MARK_SLOT2, jmt.SAMPLES_PER_SLOT)


def test_burst_timer_matches_jax():
    """The same calls give the same slot times, check_time returns and
    masks (tests/test_io.py:110-131 among them)."""
    for delay in (jtdma.BURST_DELAY_NS, 0):
        a = tdma.BurstTimer(num_channels=2, burst_delay_ns=delay)
        b = jtdma.BurstTimer(num_channels=2, burst_delay_ns=delay)
        for t in (a, b):
            t.set_timer(0)
            t.set_timer(5_000, chan=1)
            t.increment(0, 720)
        script = [("allocate_slot", 1, 0), ("allocate_slot", 2, 0),
                  ("allocate_slot", 1, 1), ("tx_mask", 24_000, 0),
                  ("allocate_slot", 2, 0), ("tx_mask", 3_000, 1)]
        for name, arg, chan in script:
            got, want = getattr(a, name)(arg, chan), getattr(b, name)(arg,
                                                                      chan)
            np.testing.assert_array_equal(got, want)
        got = [a.check_time(0) for _ in range(30_000)]
        want = [b.check_time(0) for _ in range(30_000)]
        assert got == want
        assert [a.time_delta(c) for c in (0, 1)] == \
            [b.time_delta(c) for c in (0, 1)]
    bt = tdma.BurstTimer(num_channels=1)
    bt.set_timer(0)
    t1 = bt.allocate_slot(1)
    on = np.nonzero(bt.tx_mask(24_000))[0]
    assert on.size == tdma.SAMPLES_PER_SLOT
    assert abs((on[0] + 1) * tdma.TIME_PER_SAMPLE_NS - t1) <= \
        tdma.TIME_PER_SAMPLE_NS


@pytest.mark.parametrize("slot,phase", [(1, 0), (2, 0), (1, 300), (2, 719)])
def test_slot_mask_matches_jax(slot, phase):
    m = tdma.slot_mask(2880, active_slot=slot, phase=phase)
    np.testing.assert_array_equal(
        m, jtdma.slot_mask(2880, active_slot=slot, phase=phase))
    assert m.dtype == np.float32
    np.testing.assert_array_equal(
        tdma.slot_mask(2880, 1, phase=phase)
        + tdma.slot_mask(2880, 2, phase=phase), np.ones(2880, np.float32))


def test_bursttimer_drives_mmdvm_tx_loop():
    """tests/test_chains_mmdvm.py:109-137 on the port (allocate_slot ->
    tx_mask -> MmdvmMod, RF confined to the reserved slots), and the IQ
    within MmdvmMod's bound of the JAX chain's on the same mask."""
    bt = tdma.BurstTimer(num_channels=1, burst_delay_ns=0)
    bt.set_timer(0, chan=0)
    t1 = bt.allocate_slot(1, chan=0)
    t2 = bt.allocate_slot(2, chan=0)
    assert t2 - t1 == bt.slot_time
    n24 = SLOT * 8
    mask = bt.tx_mask(n24, chan=0)
    assert mask.sum() == 2 * SLOT
    audio = tone(n24, 1200.0)
    mod = mmdvm.MmdvmMod(device=CPU)
    iq = get_iq(mod(mod.init_state(), torch.from_numpy(audio),
                    mask=torch.from_numpy(mask))[1]["iq"])
    up = len(iq) / n24
    s1 = int(t1 / tdma.TIME_PER_SAMPLE_NS * up)
    span = int(2 * SLOT * up)
    inside = np.mean(np.abs(iq[s1 + 50:s1 + span - 50]) ** 2)
    outside = np.mean(np.abs(iq[s1 + span + 2000:]) ** 2)
    assert inside > 1e3 * max(outside, 1e-12), (inside, outside)
    from qradiolink_tpu.chains.mmdvm import MmdvmMod as JMod
    jmod = JMod()
    want = np.asarray(jmod(jmod.init_state(), jnp.asarray(audio),
                           mask=jnp.asarray(mask))[1]["iq"])
    assert np.abs(iq - want).max() <= MMDVM_TX_TOL * np.abs(want).max()


# ------------------------------------------------------------- transports


def test_publisher_slots_match_jax(ipc):
    """The port's and the JAX publisher, each to a PULL peer, on the same
    float baseband in blocks that split slots, with per-slot rssi: the
    same messages, byte for byte (tests/test_io.py:90-107, 199-216)."""
    rng = np.random.default_rng(0)
    blocks = [rng.uniform(-1.1, 1.1, n).astype(np.float32)
              for n in (1000, 2000, 1600)]
    msgs = []
    for mod, key in ((mt, "rx"), (jmt, "jrx")):
        pub = mod.MmdvmRxPublisher(1, path_tpl=ipc[key])
        peer = pull(ipc[key].format(1))
        wait_peers(pub)
        for k, b in enumerate(blocks):
            pub.push_samples(0, b, rssi=np.arange(b.size // SLOT + 1) + k)
        msgs.append([peer.recv() for _ in range(sum(map(len, blocks))
                                                 // SLOT)])
        pub.close()
        peer.close(0)
    assert msgs[0] == msgs[1] and len(msgs[0]) == 6
    s, c, rssi = mt.unpack_rx_message(msgs[0][0])
    assert s.size == SLOT and rssi == 0 and not c.any()


def test_tx_poller_against_fake_mmdvmhost(ipc):
    """tests/test_io.py:157-196: a REP peer serves one burst, then an idle
    (empty) reply."""
    rep = rep_at(ipc["tx"].format(1))
    burst = (np.arange(720) % 100).astype(np.int16)
    ctrl = np.full(720, mt.MARK_SLOT1, np.uint8)

    def serve():
        rep.recv()
        rep.send(mt.pack_tx_message(burst, ctrl))
        rep.recv()
        rep.send(mt.pack_tx_message(np.zeros(0, np.int16),
                                    np.zeros(0, np.uint8)))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    poller = mt.MmdvmTxPoller(1, path_tpl=ipc["tx"], timeout_ms=WAIT_MS)
    try:
        samples, control = poller.poll(0)
        np.testing.assert_array_equal(samples, burst)
        np.testing.assert_array_equal(control, ctrl)
        got2 = poller.poll(0)
        assert got2 is not None and got2[0].size == 0
    finally:
        t.join(timeout=WAIT_MS / 1000)
        poller.close()
        rep.close(0)


def test_per_slot_rssi_matches_jax():
    """tests/test_io.py:199-216: MmdvmDemod's rssi_slots show an amplitude
    step, and equal the JAX chain's within 1e-4 dB."""
    from qradiolink_tpu.chains.mmdvm import MmdvmDemod as JDemod
    n = 250_000
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.01
    iq[n // 2:] *= 20.0
    iq = iq.astype(np.complex64)
    dem, jdem = mmdvm.MmdvmDemod(device=CPU), JDemod()
    slots = dem(dem.init_state(), torch.from_numpy(iq))[1]["rssi_slots"]
    want = np.asarray(jdem(jdem.init_state(), jnp.asarray(iq))[1]
                      ["rssi_slots"])
    slots = slots.numpy()
    assert slots.shape == want.shape and slots.size >= 30
    assert slots[-2] - slots[2] > 20.0
    np.testing.assert_allclose(slots, want, atol=1e-4)


def test_zmq_udp_proxy(ipc):
    """tests/test_io.py:246-296 on the port's proxy: UDP audio in -> a
    slot message out; the peer's TX burst -> a UDP datagram."""
    from qradiolink_tpu_torch.io.zmq_proxy import ZmqUdpProxy

    rx_path, tx_path = ipc["rx"].format(1), ipc["tx"].format(1)
    rep = rep_at(tx_path)
    burst = (np.arange(720) % 50).astype(np.int16)

    def serve():
        rep.recv()
        rep.send(mt.pack_tx_message(burst, np.zeros(720, np.uint8)))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    proxy = ZmqUdpProxy(udp_listen_port=0, udp_send_port=0,
                        rx_path=rx_path, tx_path=tx_path)
    proxy.req.setsockopt(zmq.RCVTIMEO, WAIT_MS)
    proxy.req.setsockopt(zmq.SNDTIMEO, WAIT_MS)
    peer = pull(rx_path)
    udp_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp_rx.bind(("127.0.0.1", 0))
    udp_rx.settimeout(WAIT_MS / 1000)
    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert proxy.push.poll(WAIT_MS, zmq.POLLOUT)
        proxy.udp_addr = ("127.0.0.1", udp_rx.getsockname()[1])
        pcm = (np.arange(720) % 99).astype(np.int16)
        tx_sock.sendto(pcm.tobytes(), proxy.udp.getsockname())
        proxy.udp.setblocking(True)   # wait for the datagram, then drain
        proxy.udp.settimeout(WAIT_MS / 1000)
        first = proxy.udp.recvfrom(65536)[0]
        proxy.udp.setblocking(False)
        proxy._pending = np.frombuffer(first, np.int16)
        pushed, sent = proxy.pump()
        assert (pushed, sent) == (1, 1)
        samples, _, rssi = mt.unpack_rx_message(peer.recv())
        np.testing.assert_array_equal(samples, pcm)
        data, _ = udp_rx.recvfrom(65536)
        np.testing.assert_array_equal(np.frombuffer(data, np.int16), burst)
    finally:
        proxy.close()
        peer.close(0)
        rep.close(0)
        udp_rx.close()
        tx_sock.close()
        t.join(timeout=WAIT_MS / 1000)


def test_cli_mmdvm_proxy_subcommand(monkeypatch):
    """tests/test_io.py:384-398: mmdvm-proxy is reachable from the CLI and
    closes after its ticks; the proxy gets the reference's socket paths of
    its channel."""
    from qradiolink_tpu_torch.app.cli import main as cli_main
    from qradiolink_tpu_torch.io import zmq_proxy

    seen = {}
    monkeypatch.setattr(zmq_proxy.ZmqUdpProxy, "__init__",
                        lambda self, **kw: seen.update(kw))
    monkeypatch.setattr(zmq_proxy.ZmqUdpProxy, "pump",
                        lambda self: seen.__setitem__(
                            "ticks", seen.get("ticks", 0) + 1) or (0, 0))
    monkeypatch.setattr(zmq_proxy.ZmqUdpProxy, "close",
                        lambda self: seen.__setitem__("closed", True))
    assert cli_main(["mmdvm-proxy", "--ticks", "3", "--channel", "2",
                     "--udp-listen-port", "0"]) == 0
    assert seen["ticks"] == 3 and seen["closed"]
    assert seen["rx_path"] == "ipc:///tmp/mmdvm-rx2.ipc"
    assert seen["tx_path"] == "ipc:///tmp/mmdvm-tx2.ipc"
    assert seen["udp_listen_port"] == 0 and seen["udp_send_port"] == 4941


def test_full_transport_loop(ipc):
    """tests/test_io.py:299-381 on the port's chains and transport: RF ->
    MmdvmDemod -> publisher -> a peer that echoes 4 slots -> poller ->
    MmdvmMod -> MmdvmDemod keeps the 1 kHz tone above 20 dB."""
    n24 = SLOT * 8
    mod0 = mmdvm.MmdvmMod(device=CPU)
    iq_in = get_iq(mod0(mod0.init_state(), torch.from_numpy(tone(n24)))[1]
                   ["iq"])
    dem = mmdvm.MmdvmDemod(device=CPU)
    m = len(iq_in) - len(iq_in) % 125
    out = dem(dem.init_state(), torch.from_numpy(iq_in[:m]))[1]
    peer = pull(ipc["rx"].format(1))
    rep = rep_at(ipc["tx"].format(1))
    pub = mt.MmdvmRxPublisher(1, path_tpl=ipc["rx"])
    poller = mt.MmdvmTxPoller(1, path_tpl=ipc["tx"], timeout_ms=WAIT_MS)

    def mmdvmhost():
        slots = [mt.unpack_rx_message(peer.recv())[0] for _ in range(4)]
        for s in slots:
            rep.recv()
            rep.send(mt.pack_tx_message(s, np.zeros(SLOT, np.uint8)))

    th = threading.Thread(target=mmdvmhost, daemon=True)
    try:
        wait_peers(pub)
        th.start()
        pub.push_samples(0, out["audio"].numpy(),
                         rssi=-(out["rssi_slots"].numpy().astype(int)))
        tx = [poller.poll(0)[0] for _ in range(4)]
        mod = mmdvm.MmdvmMod(device=CPU)
        base = np.concatenate(tx).astype(np.float32) / 32767.0
        iq_out = get_iq(mod(mod.init_state(), torch.from_numpy(base))[1]
                        ["iq"])
        dem2 = mmdvm.MmdvmDemod(device=CPU)
        m2 = len(iq_out) - len(iq_out) % 125
        rec = dem2(dem2.init_state(), torch.from_numpy(iq_out[:m2]))[1][
            "audio"].numpy()[1000:]
        assert tone_snr(rec, 1000.0) > 20.0
    finally:
        th.join(timeout=WAIT_MS / 1000)
        pub.close()
        poller.close()
        peer.close(0)
        rep.close(0)


# ------------------------------------------------ the session, controller


def test_mmdvm_modes_registered():
    """tests/test_mmdvm_session.py:24-30."""
    for name in ("MMDVM", "MMDVMmulti"):
        spec = get_mode(name)
        assert spec.kind == "mmdvm"
        assert spec.rx_factory is not None and spec.tx_factory is not None
    assert "MMDVM" in MODES and "MMDVMmulti" in MODES


class ServedBursts:
    """A poller double: serves queued wire messages, then idle replies
    (fewer than 4 bytes), through MmdvmTxPoller.poll's own unpacking."""

    def __init__(self, msgs_per_chan):
        self.q = [list(m) for m in msgs_per_chan]

    def poll(self, chan):
        buf = self.q[chan].pop(0) if self.q[chan] else b""
        return None if len(buf) < 4 else mt.unpack_tx_message(buf)

    def close(self):
        pass


def test_session_poll_tx_matches_jax(ipc):
    """poll_tx carries a burst's leftover into the next call, fills idle
    time with zeros and builds the burst mask, as the JAX session does on
    the same served bursts (1,000-sample bursts into 720-sample calls, 3
    carriers)."""
    bursts = [[mt.pack_tx_message(
        ((np.arange(1000) * (c + 1)) % 3000 - 1500).astype(np.int16),
        np.zeros(1000, np.uint8)) for _ in range(2)] for c in range(3)]
    s = config.Settings()
    sess = ms.MmdvmSession(s, num_channels=3, publisher=object(),
                           poller=ServedBursts(bursts))
    jsess = jms.MmdvmSession(jconfig.Settings(), num_channels=3,
                             rx_path_tpl=ipc["jrx"], tx_path_tpl=ipc["jtx"])
    jsess.poller.close()
    jsess.poller = ServedBursts(bursts)
    try:
        for n in (720, 720, 720, 720):
            (a, m), (ja, jm) = sess.poll_tx(n), jsess.poll_tx(n)
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(m, jm)
            assert a.shape == (3, n) and a.dtype == np.float32
        assert m.sum() == 0          # 2,000 samples a carrier, then idle
    finally:
        jsess.close()
    assert sess.burst_timer.burst_delay == s.burst_delay_msec * 1_000_000


def test_session_needs_pyzmq_unless_given_transports(monkeypatch):
    """Without pyzmq the session raises, and so does the controller
    entering an MMDVM mode (its init_error set, the chain left down);
    given a publisher and a poller it needs none."""
    monkeypatch.setattr(ms, "zmq_available", lambda: False)
    with pytest.raises(RuntimeError, match="pyzmq"):
        ms.MmdvmSession(config.Settings())
    sess = ms.MmdvmSession(config.Settings(), publisher=object(),
                           poller=ServedBursts([[]]))
    assert sess.C == 1
    c = ctl.RadioController(config.Settings(), device=CPU)
    with pytest.raises(RuntimeError, match="pyzmq"):
        c.toggle_rx_mode("MMDVM")
    assert c._rx is None and "pyzmq" in c.init_error


def _sessions(monkeypatch, ipc, timeout_ms=WAIT_MS):
    """Both packages' sessions on this test's socket paths."""
    monkeypatch.setattr(ms, "MmdvmSession", functools.partial(
        ms.MmdvmSession, rx_path_tpl=ipc["rx"], tx_path_tpl=ipc["tx"],
        timeout_ms=timeout_ms))
    monkeypatch.setattr(jms, "MmdvmSession", functools.partial(
        jms.MmdvmSession, rx_path_tpl=ipc["jrx"], tx_path_tpl=ipc["jtx"],
        timeout_ms=timeout_ms))


def test_session_full_loop(monkeypatch, ipc):
    """tests/test_mmdvm_session.py:33-96 on the port: the controller's RX
    publishes slots to a peer, which serves 4 of them back; mmdvm_tx_poll
    modulates them and the tone survives both FM hops above 20 dB."""
    _sessions(monkeypatch, ipc)
    c = ctl.RadioController(config.Settings(rx_mode="MMDVM",
                                            tx_mode="MMDVM"), device=CPU)
    c.toggle_rx_mode("MMDVM")
    c.toggle_tx_mode("MMDVM")
    assert c._mmdvm is not None and c._mmdvm.C == 1
    peer = pull(ipc["rx"].format(1))
    rep = rep_at(ipc["tx"].format(1))

    def mmdvmhost():
        slots = [mt.unpack_rx_message(peer.recv())[0] for _ in range(4)]
        for s in slots:
            rep.recv()
            rep.send(mt.pack_tx_message(s, np.zeros(SLOT, np.uint8)))

    th = threading.Thread(target=mmdvmhost, daemon=True)
    try:
        wait_peers(c._mmdvm.publisher)
        th.start()
        n24 = SLOT * 8
        mod0 = mmdvm.MmdvmMod(device=CPU)
        iq_in = get_iq(mod0(mod0.init_state(), torch.from_numpy(
            tone(n24)))[1]["iq"])
        events = c.rx_block(iq_in[:len(iq_in) - len(iq_in) % 125])
        assert [e.kind for e in events] == ["rssi"]
        iq_out = c.mmdvm_tx_poll(SLOT * 4)
        assert iq_out is not None
        dem = mmdvm.MmdvmDemod(device=CPU)
        m2 = len(iq_out) - len(iq_out) % 125
        rec = dem(dem.init_state(), torch.from_numpy(iq_out[:m2]))[1][
            "audio"].numpy()[1000:]
        assert tone_snr(rec, 1000.0) > 20.0
    finally:
        th.join(timeout=WAIT_MS / 1000)
        c._mmdvm.close()
        peer.close(0)
        rep.close(0)


@pytest.mark.parametrize("mode", ["MMDVM", "MMDVMmulti"])
def test_controller_publishes_and_polls_like_jax(mode, monkeypatch, ipc):
    """The JAX controller and the port's, each with its own session and
    peer, on the same IQ (two 30,000-sample blocks): the same events and
    the same slots (int16 samples and rssi within one step); served the
    same bursts (carrier 0 three of 720 samples and one of 500, then
    idle; the other carriers idle), mmdvm_tx_poll's IQ within the TX bound of the peak and
    the same mask; then leaving the mode closes the session."""
    _sessions(monkeypatch, ipc)
    C = 7 if mode == "MMDVMmulti" else 1
    rng = np.random.default_rng(7)
    if C == 1:
        tx = mmdvm.MmdvmMod(device=CPU)
        audio = torch.from_numpy(tone(2 * 2880))
    else:
        tx = mmdvm.MmdvmMultiTx(device=CPU)
        audio = torch.from_numpy(tone(2 * 2880, rows=(C,)))
    iq = get_iq(tx(tx.init_state(), audio)[1]["iq"])
    iq = (iq + 0.01 * (rng.standard_normal(iq.size)
                       + 1j * rng.standard_normal(iq.size))
          ).astype(np.complex64)
    blocks = iq.reshape(2, -1)
    burst = (1000 * np.sin(np.arange(3 * SLOT + 500) / 7)).astype(np.int16)
    served = [burst[i:i + SLOT] for i in range(0, burst.size, SLOT)]
    results = []
    for pkg, (rx_key, tx_key) in (("port", ("rx", "tx")),
                                  ("jax", ("jrx", "jtx"))):
        if pkg == "port":
            c = ctl.RadioController(config.Settings(), device=CPU)
        else:
            c = jctl.RadioController(jconfig.Settings())
        c.toggle_rx_mode(mode)
        c.toggle_tx_mode(mode)
        peers = [pull(ipc[rx_key].format(k + 1)) for k in range(C)]
        reps = [rep_at(ipc[tx_key].format(k + 1)) for k in range(C)]
        wait_peers(c._mmdvm.publisher)
        events = [e for b in blocks for e in c.rx_block(b)]
        slots = [[mt.unpack_rx_message(p.recv()) for _ in range(8)]
                 for p in peers]

        def serve():
            # carrier 0 the bursts, then each carrier one idle reply
            for k, r in enumerate(reps):
                for s in (served if k == 0 else []) + [b""]:
                    r.recv()
                    r.send(s if isinstance(s, bytes) else
                           mt.pack_tx_message(s, np.zeros(s.size, np.uint8)))

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        masks = []
        inner = c._tx

        def spy(state, a, mask=None):
            masks.append(np.asarray(mask))
            return inner(state, a, mask=mask)

        c._tx = spy
        out = c.mmdvm_tx_poll(2880)
        th.join(timeout=WAIT_MS / 1000)
        c._tx = inner
        sess = c._mmdvm
        closed = []
        sess.close = (lambda f=sess.close: closed.append(1) or f())
        c.toggle_rx_mode("NBFM")
        results.append((events, slots, out, masks[0], c._mmdvm, closed))
        for p in peers + reps:
            p.close(0)
    (ev, sl, out, mask, left, closed), (jev, jsl, jout, jmask, jleft,
                                        jclosed) = results
    assert [e.kind for e in ev] == [e.kind for e in jev] == ["rssi"] * 2
    for e, je in zip(ev, jev):
        assert abs(e.rssi - je.rssi) <= 1e-3
    for chan, jchan in zip(sl, jsl):
        for (s, c_, r), (js, jc, jr) in zip(chan, jchan):
            assert s.size == js.size == SLOT
            assert np.abs(s.astype(int) - js.astype(int)).max() <= 1
            assert abs(r - jr) <= 1
            np.testing.assert_array_equal(c_, jc)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.shape[-1] == (3000 if C > 1 else 2880)
    tol = MULTI_TX_TOL if C > 1 else MMDVM_TX_TOL
    assert out.shape == jout.shape
    assert np.abs(out - jout).max() <= tol * np.abs(jout).max()
    assert left is None and jleft is None and closed == jclosed == [1]
