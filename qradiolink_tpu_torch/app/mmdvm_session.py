"""MMDVM session: chain + ZeroMQ transport + TDMA burst timing glue (port
of qradiolink_tpu/app/mmdvm_session.py; numpy, host-side).

Promotes the reference's MMDVM integration to a first-class mode: the
demod chain's 24 ksps baseband is published to external MMDVMHost
processes over ZeroMQ ipc sockets (reference gr_mmdvm_sink.cpp:33-176
PUSH ipc:///tmp/mmdvm-rx{N}.ipc), and TX baseband is polled back over
REQ/REP (gr_mmdvm_source.cpp:35-266 ipc:///tmp/mmdvm-tx{N}.ipc) with
BurstTimer-scheduled slot gating and idle zero-fill
(gr_mmdvm_source.cpp:117-130 + gr_zero_idle_bursts.cpp:27-84).

RadioController stands one of these up when the mode is MMDVM or
MMDVMmulti (reference radiocontroller.cpp:1996-2003 forces 250 ksps and
wires the ZMQ chains). The session takes its publisher and poller as
arguments where the caller has its own (anything with the ZMQ classes'
push_samples / poll / close); by default it opens the ZMQ sockets, and
without pyzmq it raises.
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.framing.tdma import BurstTimer
from qradiolink_tpu_torch.io.mmdvm_transport import (
    MmdvmRxPublisher, MmdvmTxPoller, SAMPLES_PER_SLOT, zmq_available)


class MmdvmSession:
    """Transport + timing context for one MMDVM mode instance."""

    def __init__(self, settings, num_channels: int = 1,
                 rx_path_tpl: str = "ipc:///tmp/mmdvm-rx{}.ipc",
                 tx_path_tpl: str = "ipc:///tmp/mmdvm-tx{}.ipc",
                 timeout_ms: int = 5, publisher=None, poller=None):
        if (publisher is None or poller is None) and not zmq_available():
            raise RuntimeError("pyzmq not available for MMDVM transport")
        self.C = int(num_channels)
        self.settings = settings
        self.publisher = publisher if publisher is not None else \
            MmdvmRxPublisher(self.C, path_tpl=rx_path_tpl)
        self.poller = poller if poller is not None else \
            MmdvmTxPoller(self.C, path_tpl=tx_path_tpl,
                          timeout_ms=timeout_ms)
        self.burst_timer = BurstTimer(
            num_channels=self.C,
            burst_delay_ns=int(settings.burst_delay_msec) * 1_000_000)
        self._tx_leftover = [np.zeros(0, np.float32) for _ in range(self.C)]

    # ------------------------------------------------------------------ RX
    def publish_rx(self, audio: np.ndarray, rssi_slots: np.ndarray):
        """Chain RX output -> MMDVMHost. audio: (T,) single / (C, T)
        multi float baseband at 24 ksps; rssi_slots: per-720-sample
        RSSI (dB), forwarded as the per-burst RSSI tags the reference
        attaches (rssi_tag_block + gr_mmdvm_sink)."""
        audio = np.asarray(audio)
        if audio.ndim == 1:
            audio = audio[None, :]
        rs = np.asarray(rssi_slots)
        if rs.ndim == 1:
            rs = rs[None, :]
        for c in range(min(self.C, audio.shape[0])):
            self.burst_timer.increment(c, audio.shape[-1])
            self.publisher.push_samples(
                c, audio[c], rssi=-(rs[c].astype(int)))

    # ------------------------------------------------------------------ TX
    def poll_tx(self, n24: int):
        """Gather n24 samples of TX baseband per channel from MMDVMHost,
        zero-filling idle time (gr_mmdvm_source idle logic). Returns
        (audio (C, n24) float32, mask (C, n24) float32) — mask is the
        zero_idle_bursts gate: 1 where a real burst occupies the
        stream."""
        audio = np.zeros((self.C, n24), np.float32)
        mask = np.zeros((self.C, n24), np.float32)
        for c in range(self.C):
            pos = 0
            lo = self._tx_leftover[c]
            if lo.size:
                n = min(lo.size, n24)
                audio[c, :n] = lo[:n]
                mask[c, :n] = 1.0
                self._tx_leftover[c] = lo[n:]
                pos = n
            while pos < n24:
                got = self.poller.poll(c)
                if got is None:
                    break  # idle: rest stays zero
                samples = got[0].astype(np.float32) / 32767.0
                n = min(samples.size, n24 - pos)
                audio[c, pos:pos + n] = samples[:n]
                mask[c, pos:pos + n] = 1.0
                if n < samples.size:
                    self._tx_leftover[c] = samples[n:]
                pos += n
        if self.C == 1:
            return audio[0], mask[0]
        return audio, mask

    def close(self):
        self.publisher.close()
        self.poller.close()
