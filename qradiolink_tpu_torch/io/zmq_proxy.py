"""UDP audio <-> MMDVM ZeroMQ proxy (reference src/zeromqclient.cpp; port
of qradiolink_tpu/io/zmq_proxy.py, host-side).

The reference's `--mmdvm --udp` mode bridges MMDVMHost's per-channel
ZeroMQ IPC baseband sockets to plain UDP datagrams (SVXLink-style
short samples): one pthread pumps UDP -> ZMQ PUSH (radio TX), another
ZMQ PULL -> UDP (radio RX). Here the proxy is poll-driven so it embeds
in the host control loop without threads (call pump() each tick), with
the same 720-sample slot messages as io/mmdvm_transport.py.
"""

from __future__ import annotations

import socket

import numpy as np

from qradiolink_tpu_torch.io.mmdvm_transport import (
    pack_rx_message, unpack_tx_message, SAMPLES_PER_SLOT, zmq_available)


class ZmqUdpProxy:
    def __init__(self, udp_listen_port: int = 0, udp_send_port: int = 4941,
                 udp_host: str = "127.0.0.1",
                 rx_path: str = "ipc:///tmp/mmdvm-rx1.ipc",
                 tx_path: str = "ipc:///tmp/mmdvm-tx1.ipc"):
        if not zmq_available():
            raise RuntimeError("pyzmq not available")
        import zmq
        self._zmq = zmq
        ctx = zmq.Context.instance()
        # UDP side
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.bind((udp_host, udp_listen_port))
        self.udp.setblocking(False)
        self.udp_addr = (udp_host, udp_send_port)
        # ZMQ side (we face MMDVMHost like the radio does)
        self.push = ctx.socket(zmq.PUSH)     # -> MMDVMHost RX
        self.push.setsockopt(zmq.SNDHWM, 32)
        self.push.bind(rx_path)
        self.rep = None
        self.req = ctx.socket(zmq.REQ)       # <- MMDVMHost TX
        self.req.setsockopt(zmq.RCVTIMEO, 5)
        self.req.setsockopt(zmq.SNDTIMEO, 5)
        self.req.setsockopt(zmq.LINGER, 0)
        self.req.connect(tx_path)
        self._pending = np.zeros(0, np.int16)

    def pump(self) -> tuple[int, int]:
        """One proxy tick: UDP -> ZMQ slots, ZMQ TX -> UDP. Returns
        (slots_pushed, datagrams_sent)."""
        pushed = sent = 0
        # UDP -> ZMQ
        while True:
            try:
                data, _ = self.udp.recvfrom(65536)
            except BlockingIOError:
                break
            self._pending = np.concatenate(
                [self._pending, np.frombuffer(data, np.int16)])
        while self._pending.size >= SAMPLES_PER_SLOT:
            slot = self._pending[:SAMPLES_PER_SLOT]
            self._pending = self._pending[SAMPLES_PER_SLOT:]
            msg = pack_rx_message(slot,
                                  np.zeros(SAMPLES_PER_SLOT, np.uint8), 0)
            try:
                self.push.send(msg, flags=self._zmq.DONTWAIT)
                pushed += 1
            except self._zmq.Again:
                pass
        # ZMQ TX poll -> UDP
        try:
            self.req.send(b"s")
            buf = self.req.recv()
            if len(buf) >= 4:
                samples, _ctrl = unpack_tx_message(buf)
                if samples.size:
                    self.udp.sendto(samples.tobytes(), self.udp_addr)
                    sent += 1
        except self._zmq.ZMQError:
            pass
        return pushed, sent

    def close(self):
        self.udp.close()
        self.push.close(0)
        self.req.close(0)
