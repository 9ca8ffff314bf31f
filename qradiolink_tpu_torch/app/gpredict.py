"""GPredict Doppler control: rigctld-compatible protocol (port of
qradiolink_tpu/app/gpredict.py, host-side).

Reference src/gpredictcontrol.cpp:27-113: GPredict connects with the
Hamlib rigctld net protocol and streams `F <hz>` / `I <hz>` frequency
commands as the satellite Doppler shifts; small deltas become demod
carrier-offset corrections (the rotator front-end), large jumps retune
the radio. `f`/`i` report the current frequencies, `S` (split) is
acknowledged. Responses end with `RPRT 0`. Doppler offsets reach the
radio through RadioController.set_carrier_offset (the rotator on the
controller's device).
"""

from __future__ import annotations

import socketserver
import threading
from dataclasses import dataclass

NO_ACTION, TUNE_RX, TUNE_TX, OFFSET_RX, OFFSET_TX = range(5)
DOPPLER_RETUNE_HZ = 50_000     # beyond this delta, retune instead of offset


@dataclass
class RadioAction:
    action: int = NO_ACTION
    rx_freq: int = 0
    tx_freq: int = 0
    rx_freq_delta: int = 0
    tx_freq_delta: int = 0


class GPredictControl:
    def __init__(self, settings, lnb_lo_freq: int = 0):
        self.settings = settings
        self.lnb_lo = int(lnb_lo_freq)
        self._last_rx = 0
        self._last_tx = 0

    def process_messages(self, message: str) -> tuple[str, RadioAction]:
        """One rigctld message (possibly multiple lines) -> (reply,
        RadioAction) (reference processMessages:27-113)."""
        s = self.settings
        act = RadioAction()
        reply = False
        for msg in message.split("\n"):
            msg = msg.strip("\r")
            if not msg:
                continue
            if msg.startswith("f"):
                return (f"f: {s.rx_frequency + s.demod_offset + self.lnb_lo}\n",
                        act)
            if msg.startswith("i"):
                return (f"i: {s.rx_frequency + s.tx_shift + self.lnb_lo}\n",
                        act)
            if msg.startswith("F "):
                local = s.rx_frequency + s.demod_offset + self.lnb_lo
                new = int(float(msg[1:].strip()))
                new_delta = new - self._last_rx
                local_delta = new - local
                self._last_rx = new
                if abs(local_delta) > DOPPLER_RETUNE_HZ:
                    freq = new - s.demod_offset - self.lnb_lo
                    if freq >= 28_000_000:
                        act.action = TUNE_RX
                        act.rx_freq = freq
                elif abs(new_delta) > DOPPLER_RETUNE_HZ:
                    act.action = OFFSET_RX
                    act.rx_freq_delta = local_delta
                else:
                    act.action = OFFSET_RX
                    act.rx_freq_delta = new_delta
                reply = True
            elif msg.startswith("I "):
                local = s.rx_frequency + s.demod_offset + self.lnb_lo \
                    + s.tx_shift
                new = int(float(msg[1:].strip()))
                new_delta = new - self._last_tx
                local_delta = new - local
                self._last_tx = new
                if abs(local_delta) > DOPPLER_RETUNE_HZ:
                    if new >= 28_000_000:
                        act.action = TUNE_TX
                        act.tx_freq = new
                elif abs(new_delta) > DOPPLER_RETUNE_HZ:
                    act.action = OFFSET_TX
                    act.tx_freq_delta = local_delta
                else:
                    act.action = OFFSET_TX
                    act.tx_freq_delta = new_delta
                reply = True
            elif msg.startswith("S "):
                return ("RPRT 0\n", act)
            if reply:
                return ("RPRT 0\n", act)
        return ("RPRT 0\n", act)


class GPredictServer:
    """TCP server (rigctld port 4532 by default) applying Doppler
    actions to a RadioController."""

    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 4532):
        self.ctl = controller
        self.gp = GPredictControl(controller.settings)
        outer = self

        class _H(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    raw = self.rfile.readline()
                    if not raw:
                        break
                    reply, act = outer.gp.process_messages(
                        raw.decode("ascii", "replace"))
                    outer.apply(act)
                    self.wfile.write(reply.encode())

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self.server = Srv((host, port), _H)
        self.port = self.server.server_address[1]
        self._thread = None

    def apply(self, act: RadioAction):
        s = self.ctl.settings
        if act.action == TUNE_RX:
            s.rx_frequency = act.rx_freq
        elif act.action == TUNE_TX:
            s.tx_shift = act.tx_freq - s.rx_frequency - s.demod_offset
        elif act.action == OFFSET_RX:
            s.demod_offset += act.rx_freq_delta
            self.ctl.set_carrier_offset(s.demod_offset)
        elif act.action == OFFSET_TX:
            s.tx_shift += act.tx_freq_delta

    def start(self):
        self._thread = threading.Thread(
            target=self.server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=2)
