"""IP-over-radio in the port (net/netdev.py) against the JAX package's
(tests/test_net.py), on the CPU: the air frames byte for byte with the
majority vote and the CRC, NetPump's flow control and data-modem reset
tick for tick, the controller's IP path (tx_net_poll's IQ within the
modulator's bound of the JAX controller's, a received IP frame delivered
to the device), and a port loopback TAP -> pump -> 4FSK100K -> RX ->
pump -> TAP. LoopbackNetDevice throughout: no test opens /dev/net/tun."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu import net as jnet  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.net import netdev as jnetdev  # noqa: E402
from qradiolink_tpu_torch import config, net  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.framing.layer1 import FrameType  # noqa: E402
from qradiolink_tpu_torch.net import netdev  # noqa: E402

CPU = "cpu"
TX_TOL = 1e-4            # tests/test_torch_psk.py / test_torch_fsk.py: the
#                          mods' IQ, relative to the peak


def _payload(n, seed=0):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


def test_ip_frame_roundtrip_and_majority_vote():
    """tests/test_net.py:18-33, each frame equal to the JAX one."""
    payload = _payload(900)
    frame = net.ip_frame_encode(payload, 1516)
    assert frame == jnet.ip_frame_encode(payload, 1516)
    assert len(frame) == 1516
    assert net.ip_frame_decode(frame) == payload
    bad = bytearray(frame)
    bad[0] ^= 0xFF
    assert net.ip_frame_decode(bytes(bad)) == payload
    bad[4] ^= 0xFF                   # two copies of three now disagree
    assert net.ip_frame_decode(bytes(bad)) == \
        jnet.ip_frame_decode(bytes(bad))
    bad = bytearray(frame)
    bad[100] ^= 0xFF
    assert net.ip_frame_decode(bytes(bad)) is None
    assert netdev.idle_frame(1516) == jnetdev.idle_frame(1516)
    assert net.ip_frame_decode(netdev.idle_frame(1516)) is None
    assert net.ip_frame_encode(b"", 622) == jnet.ip_frame_encode(b"", 622)
    with pytest.raises(ValueError, match="exceeds frame budget"):
        net.ip_frame_encode(_payload(607), 622)
    assert net.IP_MODE_PARAMS == jnet.IP_MODE_PARAMS


def test_net_pump_flow_control_matches_jax():
    """tests/test_net.py:36-52: idle frames keep the modem fed, an
    injected packet goes out, 300 s of TX sleep the modem 2 s; the port's
    pump returns the JAX pump's frame (or None) on every tick."""
    pumps = []
    for mod in (net, jnet):
        dev = mod.LoopbackNetDevice()
        pumps.append((dev, mod.NetPump(dev, "QPSK250K")))
    (dev, pump), (jdev, jpump) = pumps
    ticks = int(300 / 0.05) + 2 + int(2 / 0.05) + 3
    for i in range(ticks):
        if i in (1, 500, 6100):
            for d in (dev, jdev):
                d.inject(b"\x45" + bytes([i % 256]) * 99)
        assert pump.poll_tx(0.05) == jpump.poll_tx(0.05), i
    assert pump.resets == jpump.resets == 1
    f = pump.poll_tx(0.05)
    assert f is not None and net.ip_frame_decode(f) is None
    with pytest.raises(ValueError, match="not an IP modem mode"):
        net.NetPump(net.LoopbackNetDevice(), "NBFM")


def test_burst_mode_sends_nothing_when_idle():
    """tests/test_net.py:55-57, and push_rx delivers as the JAX pump."""
    pump = net.NetPump(net.LoopbackNetDevice(), "4FSK100K", burst_mode=True)
    assert pump.poll_tx(0.05) is None
    payload = _payload(300, 1)
    frame = net.ip_frame_encode(payload, 622)
    assert pump.push_rx(frame) is True
    assert pump.device.delivered() == [payload]
    assert pump.push_rx(netdev.idle_frame(622)) is False
    assert pump.device.delivered() == []


@pytest.mark.parametrize("mode", ["QPSK250K", "4FSK100K"])
def test_controller_ip_path_matches_jax(mode):
    """tx_net_poll: the same air frame, framed as layer-1 IP, modulated to
    IQ within the mod's bound of the JAX controller's; idle (burst mode)
    gives None in both. _dispatch_frame of a received IP frame: a "net"
    event, the payload on the device; a bad frame: a "frame" event."""
    payload = _payload(IP_READ[mode], 2)
    outs = []
    for mod, c in ((net, ctl.RadioController(config.Settings(tx_mode=mode),
                                            device=CPU)),
                   (jnet, jctl.RadioController(
                       jconfig.Settings(tx_mode=mode)))):
        dev = mod.LoopbackNetDevice()
        pump = mod.NetPump(dev, mode, burst_mode=True)
        assert c.tx_net_poll(pump, 0.05) is None
        dev.inject(payload)
        iq = c.tx_net_poll(pump, 0.05)
        rx_dev = mod.LoopbackNetDevice()
        c.attach_net(mod.NetPump(rx_dev, mode))
        frame = mod.ip_frame_encode(payload, mod.IP_MODE_PARAMS[mode][0])
        ev = c._dispatch_frame(FrameType.IP, frame, 0.25)
        bad = c._dispatch_frame(FrameType.IP, frame[:20], 0.5)
        outs.append((iq, (ev.kind, ev.frame_type, ev.payload,
                          ev.sample_time), rx_dev.delivered(),
                     (bad.kind, bad.payload)))
    (iq, ev, got, bad), (jiq, jev, jgot, jbad) = outs
    assert iq.shape == jiq.shape and iq.dtype == jiq.dtype
    assert np.abs(iq - jiq).max() <= TX_TOL * np.abs(jiq).max()
    assert ev == jev and ev[0] == "net"
    assert got == jgot == [payload]
    assert bad == jbad and bad[0] == "frame"


IP_READ = {m: p[1] for m, p in netdev.IP_MODE_PARAMS.items()}


def test_ip_over_radio_loopback():
    """tests/test_net.py:60-104 on the port at 4FSK100K, one payload (the
    plain loops on the CPU run at tens of microseconds a sample): TAP ->
    pump -> layer-1 IP frame -> modem TX -> RX chain -> deframer -> pump
    -> TAP."""
    mode = "4FSK100K"
    payload = _payload(64, 3)
    tx_dev, rx_dev = net.LoopbackNetDevice(), net.LoopbackNetDevice()
    tx_pump = net.NetPump(tx_dev, mode, burst_mode=True)
    tx_dev.inject(payload)
    s = config.Settings()
    s.tx_mode = s.rx_mode = mode
    c = ctl.RadioController(s, device=CPU)
    c.start_transmission()
    iq = np.concatenate([c.tx_bytes(b"\xaa" * 300),
                         c.tx_net_poll(tx_pump, 0.05),
                         c.tx_bytes(b"\xaa" * 500)])
    rx = ctl.RadioController(s, device=CPU)
    rx.attach_net(net.NetPump(rx_dev, mode))
    rx.toggle_rx_mode(mode)
    block = 50_000
    events = [e for i in range(0, iq.size - iq.size % block, block)
              for e in rx.rx_block(iq[i:i + block])]
    assert rx_dev.delivered() == [payload]
    assert [e.payload for e in events if e.kind == "net"] != []
