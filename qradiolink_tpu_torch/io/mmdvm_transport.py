"""MMDVMHost transport: ZeroMQ IPC sockets with the reference's exact
wire format (port of qradiolink_tpu/io/mmdvm_transport.py; numpy and
pyzmq, host-side).

The reference bridges each MMDVM carrier to an external MMDVMHost
process over two ZeroMQ sockets per channel (reference
src/gr/gr_mmdvm_sink.cpp:44-50, gr_mmdvm_source.cpp:50-56):

  RX:  PUSH  ipc:///tmp/mmdvm-rx{N}.ipc   radio -> MMDVMHost
  TX:  REQ   ipc:///tmp/mmdvm-tx{N}.ipc   radio <- MMDVMHost (poll)

Message format (gr_mmdvm_sink.cpp:155-165, both directions):

  [u32 num_items][u32 rssi]           (RX only: rssi; TX omits it)
  [num_items x u8 control]            MARK_NONE/MARK_SLOT1/MARK_SLOT2
  [num_items x i16 samples]           24 ksps FM baseband

one 720-sample (30 ms) slot per message. This module speaks that exact
protocol so an unmodified MMDVMHost (with the reference's ZMQ patch)
can connect; channel N defaults to the reference's socket paths. The
sockets sit behind two methods, MmdvmRxPublisher._send and
MmdvmTxPoller._request, so that a caller without pyzmq can carry the
same wire messages another way (chip_smoke.py does).
"""

from __future__ import annotations

import numpy as np

try:
    import zmq
    _ZMQ = True
except ImportError:          # pragma: no cover - pyzmq is optional
    _ZMQ = False

MARK_NONE = 0
MARK_SLOT1 = 1
MARK_SLOT2 = 2
SAMPLES_PER_SLOT = 720


def zmq_available() -> bool:
    return _ZMQ


def pack_rx_message(samples: np.ndarray, control: np.ndarray,
                    rssi: int = 0) -> bytes:
    """(N,) int16 samples + (N,) u8 control -> wire message."""
    samples = np.ascontiguousarray(samples, np.int16)
    control = np.ascontiguousarray(control, np.uint8)
    assert samples.size == control.size
    head = np.array([samples.size, rssi], np.uint32).tobytes()
    return head + control.tobytes() + samples.tobytes()


def unpack_rx_message(buf: bytes):
    """wire message -> (samples int16, control u8, rssi)."""
    n, rssi = np.frombuffer(buf[:8], np.uint32)
    control = np.frombuffer(buf[8:8 + n], np.uint8)
    samples = np.frombuffer(buf[8 + n:8 + n + 2 * n], np.int16)
    return samples, control, int(rssi)


def pack_tx_message(samples: np.ndarray, control: np.ndarray) -> bytes:
    """MMDVMHost -> radio reply (gr_mmdvm_source.cpp:90-99: u32 count,
    then control bytes, then shorts)."""
    samples = np.ascontiguousarray(samples, np.int16)
    control = np.ascontiguousarray(control, np.uint8)
    head = np.array([samples.size], np.uint32).tobytes()
    return head + control.tobytes() + samples.tobytes()


def unpack_tx_message(buf: bytes):
    n = int(np.frombuffer(buf[:4], np.uint32)[0])
    control = np.frombuffer(buf[4:4 + n], np.uint8)
    samples = np.frombuffer(buf[4 + n:4 + n + 2 * n], np.int16)
    return samples, control


class MmdvmRxPublisher:
    """Radio side of the RX path: PUSH demodulated 24k baseband slots to
    MMDVMHost (one socket per channel, gr_mmdvm_sink equivalent)."""

    def __init__(self, num_channels: int = 1,
                 path_tpl: str = "ipc:///tmp/mmdvm-rx{}.ipc"):
        if not _ZMQ:
            raise RuntimeError("pyzmq not available")
        self.ctx = zmq.Context.instance()
        self.socks = []
        for c in range(num_channels):
            s = self.ctx.socket(zmq.PUSH)
            s.setsockopt(zmq.SNDHWM, 32)
            s.bind(path_tpl.format(c + 1))
            self.socks.append(s)
        self._init_slots(num_channels)

    def _init_slots(self, num_channels: int):
        self._pending = [np.zeros(0, np.int16)] * num_channels
        self._ctrl = [np.zeros(0, np.uint8)] * num_channels
        self._rssi = [np.zeros(0, np.int64)] * num_channels

    def push_samples(self, chan: int, samples: np.ndarray,
                     control: np.ndarray | None = None, rssi=0):
        """Buffer + emit complete 720-sample slot messages.

        rssi: a scalar applied to every slot in this block, or a
        per-slot vector (e.g. the chains' `rssi_slots` tap, negated to
        the reference's positive-dB convention) — each emitted slot
        then carries its own burst RSSI like the reference's
        rssi_tag_block tags (gr_mmdvm_sink.cpp rssi handling)."""
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = np.clip(samples * 32767.0, -32767, 32767).astype(np.int16)
        if control is None:
            control = np.zeros(samples.size, np.uint8)
        n_slots = samples.size // SAMPLES_PER_SLOT + 1
        rssi_v = np.broadcast_to(
            np.round(np.atleast_1d(np.asarray(rssi))).astype(np.int64),
            (n_slots,)) if np.ndim(rssi) == 0 else \
            np.round(np.asarray(rssi)).astype(np.int64)
        self._pending[chan] = np.concatenate([self._pending[chan], samples])
        self._ctrl[chan] = np.concatenate(
            [self._ctrl[chan], np.asarray(control, np.uint8)])
        self._rssi[chan] = np.concatenate([self._rssi[chan], rssi_v])
        while self._pending[chan].size >= SAMPLES_PER_SLOT:
            slot_rssi = int(self._rssi[chan][0]) if self._rssi[chan].size \
                else 0
            msg = pack_rx_message(
                self._pending[chan][:SAMPLES_PER_SLOT],
                self._ctrl[chan][:SAMPLES_PER_SLOT], slot_rssi)
            self._send(chan, msg)
            self._pending[chan] = self._pending[chan][SAMPLES_PER_SLOT:]
            self._ctrl[chan] = self._ctrl[chan][SAMPLES_PER_SLOT:]
            self._rssi[chan] = self._rssi[chan][1:]

    def _send(self, chan: int, msg: bytes):
        try:
            self.socks[chan].send(msg, flags=zmq.DONTWAIT)
        except zmq.Again:
            pass  # MMDVMHost not draining: drop, like the reference

    def close(self):
        for s in self.socks:
            s.close(0)


class MmdvmTxPoller:
    """Radio side of the TX path: REQ poll MMDVMHost for baseband to
    transmit (gr_mmdvm_source equivalent)."""

    def __init__(self, num_channels: int = 1,
                 path_tpl: str = "ipc:///tmp/mmdvm-tx{}.ipc",
                 timeout_ms: int = 10):
        if not _ZMQ:
            raise RuntimeError("pyzmq not available")
        self.ctx = zmq.Context.instance()
        self.socks = []
        for c in range(num_channels):
            s = self.ctx.socket(zmq.REQ)
            s.setsockopt(zmq.RCVTIMEO, timeout_ms)
            s.setsockopt(zmq.SNDTIMEO, timeout_ms)
            s.setsockopt(zmq.LINGER, 0)
            s.connect(path_tpl.format(c + 1))
            self.socks.append(s)

    def poll(self, chan: int):
        """-> (samples int16, control u8) or None when idle."""
        buf = self._request(chan)
        if buf is None or len(buf) < 4:
            return None
        return unpack_tx_message(buf)

    def _request(self, chan: int):
        """One REQ/REP round trip: the reply's bytes, None on timeout."""
        try:
            self.socks[chan].send(b"s")
            return self.socks[chan].recv()
        except zmq.Again:
            return None

    def close(self):
        for s in self.socks:
            s.close(0)
