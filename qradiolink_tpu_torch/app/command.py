"""Command processor: the reference's remote-control verb surface (port of
qradiolink_tpu/app/command.py; host-side).

Re-derivation of reference src/commandprocessor.cpp (1212 LoC): the
same verb table (buildCommandProcessor buildCommandList:1127-1212),
help/validation behavior (:51-63), and parameter checking, mapped onto
RadioController + Settings instead of Qt signals. The same processor
backs the telnet server (app/telnet.py) and any text-message control
transport, mirroring the reference's reuse of one parser for telnet
and Mumble text (commandprocessor.h:131).

Verbs whose hardware doesn't exist in this framework (relays, LimeRFE,
Mumble) respond with a clear "not available" instead of silently
succeeding. Every verb answers with the JAX processor's text: the
recorder verbs through audio/recorder.py, the Mumble verbs through
voip/mumble.py.
"""

from __future__ import annotations

import re
from typing import Callable

from qradiolink_tpu_torch.models.registry import MODES


class CommandProcessor:
    def __init__(self, controller, channels=None, voip=None):
        self.ctl = controller
        self.settings = controller.settings
        self.channels = channels
        self.voip = voip
        self.shutdown_requested = False
        self._mode_list = list(MODES.keys())
        self._commands: dict[str, tuple[int, str, Callable]] = {}
        self._build()

    # ------------------------------------------------------------------
    def _add(self, name: str, nargs: int, help_text: str, fn: Callable):
        self._commands[name] = (nargs, help_text, fn)

    def _build(self):
        s = self.settings
        add = self._add
        # status verbs (commandprocessor.cpp:1129-1147)
        add("rxstatus", 0, "Status of receiver (started or not)",
            lambda: "RX active" if self.ctl._rx is not None else "RX inactive")
        add("txstatus", 0, "Status of transmitter (started or not)",
            lambda: "TX active" if self.ctl._tx is not None else "TX inactive")
        add("txactive", 0, "See if the radio is on the air",
            lambda: "transmitting" if self.ctl.transmitting else "not transmitting")
        add("rxmode", 0, "Get RX operating mode",
            lambda: self.ctl._rx_mode or s.rx_mode)
        add("txmode", 0, "Get TX operating mode",
            lambda: self.ctl._tx_mode or s.tx_mode)
        add("rxvolume", 0, "Get RX volume value",
            lambda: str(int(s.rx_volume * 100)))
        add("txvolume", 0, "Get TX volume value",
            lambda: str(int(s.tx_volume * 100)))
        add("squelch", 0, "Get squelch value", lambda: str(s.squelch_db))
        add("rssi", 0, "Get current RSSI value",
            lambda: f"{getattr(self.ctl, 'last_rssi', float('nan'))} dBm")
        add("voxstatus", 0, "Get VOX status",
            lambda: "VOX enabled" if s.vox_level > 0 else "VOX disabled")
        add("rxfreq", 0, "Get current RX frequency",
            lambda: str(s.rx_frequency))
        add("txfreq", 0, "Get current TX frequency",
            lambda: str(s.rx_frequency + s.tx_shift))
        add("voxlevel", 0, "Get VOX level",
            lambda: str(int(s.vox_level * 100)))
        add("voipbitrate", 0, "Get VOIP bitrate",
            lambda: str(s.voip_bitrate))
        add("rxctcss", 0, "Get RX CTCSS", lambda: str(s.rx_ctcss))
        add("txctcss", 0, "Get TX CTCSS", lambda: str(s.tx_ctcss))
        add("rxgain", 0, "Get RX gain value", lambda: str(s.rx_gain))
        add("txgain", 0, "Get TX gain value", lambda: str(s.tx_gain))
        add("voipstatus", 0, "Get VOIP status",
            lambda: "VOIP connected" if self._voip_connected()
            else "VOIP disconnected")
        add("forwardingstatus", 0, "Get radio forwarding status",
            lambda: "Radio forwarding enabled" if s.voip_forwarding
            else "Radio forwarding disabled")
        add("repeaterstatus", 0, "Get repeater status",
            lambda: "Repeater enabled" if s.repeater_enabled
            else "Repeater disabled")
        add("duplexstatus", 0, "Get duplex status",
            lambda: "Duplex enabled" if s.enable_duplex
            else "Duplex disabled")
        add("agcattack", 0, "Get AGC attack value",
            lambda: str(s.agc_attack))
        add("agcdecay", 0, "Get AGC decay value", lambda: str(s.agc_decay))
        add("udpstatus", 0, "Get UDP audio forwarding status",
            lambda: "UDP streaming enabled" if s.udp_enabled
            else "UDP streaming disabled")
        add("voipvolume", 0, "Get VOIP volume value",
            lambda: str(s.voip_volume))
        add("muteforwarding", 0,
            "Get local mute status of VOIP forwarded radio",
            lambda: "Forwarded audio muted" if s.mute_forwarded_audio
            else "Forwarded audio unmuted")

        # action verbs (commandprocessor.cpp:1150-1186)
        add("setrx", 1, "Start/stop receiver, 1 enabled, 0 disabled",
            self._set_rx)
        add("settx", 1, "Start/stop transmitter, 1 enabled, 0 disabled",
            self._set_tx)
        add("setrxmode", 1, "Set RX mode (integer number, see list_modes)",
            lambda v: self._set_mode(v, rx=True))
        add("settxmode", 1, "Set TX mode (integer number, see list_modes)",
            lambda v: self._set_mode(v, rx=False))
        add("setsquelch", 1, "Set squelch (integer number, -150 to 10)",
            lambda v: self._set_num("squelch_db", v, -150, 10,
                                    "squelch"))
        add("setrxvolume", 1, "Set RX volume (integer number, 0 to 100)",
            lambda v: self._set_pct("rx_volume", v, "RX volume"))
        add("settxvolume", 1, "Set TX volume (integer number, 0 to 100)",
            lambda v: self._set_pct("tx_volume", v, "TX volume"))
        add("tunerx", 1, "Tune RX frequency, (integer value in Hertz)",
            self._tune_rx)
        add("tunetx", 1, "Tune TX frequency, (integer value in Hertz)",
            self._tune_tx)
        add("setoffset", 1, "Set demodulator offset, (integer value in Hertz)",
            self._set_offset)
        add("setshift", 1, "Set TX shift, (integer value in Hertz)",
            self._set_shift)
        add("setvox", 1, "Set vox mode, (1 enabled, 0 disabled)",
            lambda v: self._toggle("vox", v))
        add("setcompressor", 1, "Enable audio compressor, (1 enabled, 0 disabled)",
            lambda v: self._toggle("compressor", v))
        add("setrssicalibration", 1, "Set RSSI calibration, (integer value in dBm)",
            lambda v: self._set_num("rssi_calibration_value", v, -200, 100,
                                    "RSSI calibration"))
        add("setvoxlevel", 1, "Set VOX level (integer value level between 0 and 100)",
            lambda v: self._set_pct("vox_level", v, "VOX level"))
        add("setvoipbitrate", 1, "Set VOIP bitrate (bits/sec",
            lambda v: self._set_num("voip_bitrate", v, 2400, 512000,
                                    "VOIP bitrate"))
        add("ptt_on", 0, "Transmit", self._ptt_on)
        add("ptt_off", 0, "Stop transmitting", self._ptt_off)
        add("textmsg", 1, "Send radio text message, (string value text)",
            self._textmsg)
        add("start_trx", 0,
            "Convenience function, requires everything to be preconfigured",
            self._start_trx)
        add("stop_trx", 0,
            "Convenience function, requires everything to be preconfigured",
            self._stop_trx)
        add("list_modes", 0, "List operating modes", self._list_modes)
        add("listradiochan", 0, "List memory channels", self._list_chans)
        add("setradiochan", 1, "Set radio channel (integer value)",
            self._set_chan)
        add("shutdown", 0, "Shutdown and exit", self._shutdown)
        add("gettxlimits", 0, "Get status of TX band limiter",
            lambda: "TX band limits enabled" if s.tx_band_limits
            else "TX band limits disabled")
        add("settxlimits", 1, "Toggle TX band limits, (1 enabled, 0 disabled)",
            self._set_tx_limits)
        add("recordstatus", 0, "Status of audio recorder",
            lambda: "Recording" if getattr(self.ctl, "_recorder", None)
            and self.ctl._recorder.recording else "Not recording")
        add("setaudiorecorder", 1,
            "Toggle audio recording, (1 enabled, 0 disabled)",
            self._set_recorder)
        add("setrxctcss", 1,
            "Set RX CTCSS (floating point number, 0.0 to 200.0)",
            lambda v: self._set_ctcss(v, rx=True))
        add("settxctcss", 1,
            "Set TX CTCSS (floating point number, 0.0 to 200.0)",
            lambda v: self._set_ctcss(v, rx=False))
        add("setrxgain", 1, "Set RX gain (integer number, 0 to 99)",
            lambda v: self._set_num("rx_gain", v, 0, 99, "RX gain"))
        add("settxgain", 1, "Set TX gain (integer number, 0 to 99)",
            lambda v: self._set_num("tx_gain", v, 0, 99, "TX gain"))
        add("setduplex", 1, "Set duplex mode, (1 enabled, 0 disabled)",
            lambda v: self._set_flag("enable_duplex", v, "duplex mode"))
        add("setforwarding", 1,
            "Set radio forwarding mode, (1 enabled, 0 disabled)",
            lambda v: self._set_flag("voip_forwarding", v,
                                     "radio forwarding"))
        add("setrepeater", 1, "Set repeater mode, (1 enabled, 0 disabled)",
            lambda v: self._set_flag("repeater_enabled", v,
                                     "repeater mode"))
        add("setmuteforwarding", 1,
            "Toggle local mute status of VOIP forwarded radio, "
            "(1 enabled, 0 disabled)",
            lambda v: self._set_flag("mute_forwarded_audio", v,
                                     "forwarded audio mute"))
        add("setpttvoip", 1, "Use PTT for VOIP, (1 enabled, 0 disabled)",
            lambda v: self._set_flag("voip_ptt_enabled", v,
                                     "PTT for VOIP"))
        add("setudpenabled", 1,
            "Set UDP streaming mode, (1 enabled, 0 disabled)",
            lambda v: self._set_flag("udp_enabled", v, "UDP streaming"))
        add("autosquelch", 0, "Set autosquelch", self._autosquelch)
        add("setfilterwidth", 1,
            "Set filter width (analog only), (integer value in Hz)",
            self._set_filter_width)
        add("changechannel", 1,
            "Change channel to channel number (integer channel number)",
            self._set_chan)
        add("setagcattack", 1, "Set AGC attack value",
            lambda v: self._set_num("agc_attack", v, 0, 1000,
                                    "AGC attack"))
        add("setagcdecay", 1, "Set AGC decay value",
            lambda v: self._set_num("agc_decay", v, 0, 5000, "AGC decay"))
        add("setvoipvolume", 1,
            "Set VOIP volume value, (integer value level between 0 and 100)",
            lambda v: self._set_num("voip_volume", v, 0, 100,
                                    "VOIP volume"))
        add("setrxsamprate", 1, "Set RX sample rate, (integer value in Msps)",
            self._set_samp_rate)
        # Mumble VOIP verbs operate on the attached client
        add("connectserver", 2,
            "Connect to Mumble server, (string value hostname, integer "
            "value port)", self._connect_server)
        add("disconnectserver", 0, "Disconnect from Mumble server",
            self._disconnect_server)
        add("mumblemsg", 1, "Send Mumble message, (string value text)",
            self._mumble_msg)
        add("mutemumble", 1, "Mute Mumble connection, (1 enabled, 0 disabled)",
            self._mute_mumble)
        # true hardware verbs: FTDI relay board only
        add("setrelays", 1, "Enable relay control, (1 enabled, 0 disabled)",
            lambda *a: "setrelays: FTDI relay hardware not available "
            "in this build")

    # ------------------------------------------------------------ handlers
    def _bool_param(self, v):
        try:
            n = int(v)
        except ValueError:
            return None
        return n if n in (0, 1) else None

    def _toggle(self, what, v):
        b = self._bool_param(v)
        if b is None:
            return None
        if what == "vox":
            self.settings.vox_level = 0.2 if b else 0.0
            return f"Setting VOX to {b}"
        if what == "compressor":
            self.settings.audio_compressor = bool(b)
            return f"Setting audio compressor to {b}"
        return None

    def _set_rx(self, v):
        b = self._bool_param(v)
        if b is None:
            return None
        if b:
            self.ctl.toggle_rx_mode(self.settings.rx_mode)
            return "Starting receiver"
        self.ctl._rx = None
        return "Stopping receiver"

    def _set_tx(self, v):
        b = self._bool_param(v)
        if b is None:
            return None
        if b:
            self.ctl.toggle_tx_mode(self.settings.tx_mode)
            return "Starting transmitter"
        self.ctl._tx = None
        return "Stopping transmitter"

    def _set_mode(self, v, rx: bool):
        try:
            idx = int(v)
            mode = self._mode_list[idx]
        except (ValueError, IndexError):
            if v in MODES:
                mode = v
            else:
                return None
        if rx:
            self.settings.rx_mode = mode
            self.ctl.toggle_rx_mode(mode)
            return f"Setting RX mode to {mode}"
        self.settings.tx_mode = mode
        self.ctl.toggle_tx_mode(mode)
        return f"Setting TX mode to {mode}"

    def _set_num(self, attr, v, lo, hi, label):
        try:
            n = float(v)
        except ValueError:
            return None
        if not lo <= n <= hi:
            return None
        setattr(self.settings, attr,
                type(getattr(self.settings, attr))(n))
        return f"Setting {label} value to {v}"

    def _set_pct(self, attr, v, label):
        try:
            n = int(v)
        except ValueError:
            return None
        if not 0 <= n <= 100:
            return None
        setattr(self.settings, attr, n / 100.0)
        return f"Setting {label} value to {n}"

    def _tune_rx(self, v):
        try:
            f = int(v)
        except ValueError:
            return None
        self.settings.rx_frequency = f
        return f"Tuning receiver to {f} Hz"

    def _tune_tx(self, v):
        try:
            f = int(v)
        except ValueError:
            return None
        self.settings.tx_shift = f - self.settings.rx_frequency
        return f"Tuning transmitter to {f} Hz"

    def _set_offset(self, v):
        try:
            f = int(v)
        except ValueError:
            return None
        self.settings.demod_offset = f
        self.ctl.set_carrier_offset(f)
        return f"Setting demodulator offset to {f} Hz"

    def _set_shift(self, v):
        try:
            f = int(v)
        except ValueError:
            return None
        self.settings.tx_shift = f
        return f"Setting TX shift to {f} Hz"

    def _ptt_on(self):
        self.ctl.start_transmission()
        return "PTT on"

    def _ptt_off(self):
        self.ctl.end_transmission()
        return "PTT off"

    def _textmsg(self, text):
        self.ctl.tx_text(str(text))
        return f"Sending text message: {text}"

    def _start_trx(self):
        self.ctl.toggle_rx_mode(self.settings.rx_mode)
        self.ctl.toggle_tx_mode(self.settings.tx_mode)
        return "Starting transceiver"

    def _stop_trx(self):
        self.ctl._rx = None
        self.ctl._tx = None
        self.ctl.end_transmission()
        return "Stopping transceiver"

    def _list_modes(self):
        return "\n".join(f"{i}: {m}" for i, m in enumerate(self._mode_list))

    def _list_chans(self):
        if not self.channels or not self.channels.channels:
            return "No memory channels"
        return "\n".join(
            f"{i}: {c.name} {c.rx_frequency} {c.rx_mode}"
            for i, c in enumerate(self.channels.channels))

    def _set_chan(self, v):
        if not self.channels:
            return None
        try:
            ch = self.channels.channels[int(v)]
        except (ValueError, IndexError):
            return None
        self.settings.rx_frequency = ch.rx_frequency
        self.settings.tx_shift = ch.tx_shift
        self.settings.rx_mode = ch.rx_mode
        self.settings.tx_mode = ch.tx_mode
        self.ctl.toggle_rx_mode(ch.rx_mode)
        return f"Changing to memory channel {ch.name}"

    def _set_recorder(self, v):
        b = self._bool_param(v)
        if b is None:
            return None
        rec = getattr(self.ctl, "_recorder", None)
        if rec is None:
            from qradiolink_tpu_torch.audio.recorder import AudioRecorder
            rec = AudioRecorder()
            self.ctl.attach_recorder(rec)
        if b:
            rec.start()
        else:
            rec.stop()
        return f"Setting audio recording to {b}"

    def _set_tx_limits(self, v):
        b = self._bool_param(v)
        if b is None:
            return None
        self.settings.tx_band_limits = bool(b)
        return f"Setting TX band limits to {b}"

    def _set_flag(self, attr, v, label):
        b = self._bool_param(v)
        if b is None:
            return None
        setattr(self.settings, attr, bool(b))
        return f"Setting {label} to {b}"

    def _set_ctcss(self, v, rx: bool):
        try:
            hz = float(v)
        except ValueError:
            return None
        if not 0.0 <= hz <= 200.0:
            return None
        if rx:
            self.ctl.set_rx_ctcss(hz)
            return f"Setting RX CTCSS to {hz}"
        self.ctl.set_tx_ctcss(hz)
        return f"Setting TX CTCSS to {hz}"

    def _autosquelch(self):
        sq = self.ctl.auto_squelch()
        return f"Setting squelch value to {int(sq)}"

    def _set_filter_width(self, v):
        try:
            hz = int(v)
        except ValueError:
            return None
        if not 100 <= hz <= 500_000:
            return None
        self.ctl.set_filter_width(hz)
        return f"Setting filter width to {hz} Hz"

    def _set_samp_rate(self, v):
        try:
            msps = int(v)
        except ValueError:
            return None
        if not 1 <= msps <= 100:
            return None
        self.settings.rx_sample_rate = msps * 1_000_000
        return f"Setting RX sample rate to {msps} Msps"

    def _connect_server(self, host, port):
        try:
            port = int(port)
        except ValueError:
            return None
        self.settings.voip_server = str(host)
        self.settings.voip_port = port
        if self.voip is None:
            try:
                from qradiolink_tpu_torch.voip.mumble import MumbleClient
                self.voip = MumbleClient(str(host), port,
                                         password=self.settings.voip_password)
            except Exception as e:
                return f"Command failed: {e}"
        try:
            self.voip.connect()
        except Exception as e:
            return f"Could not connect to server: {e}"
        return f"Connecting to server {host} port {port}"

    def _disconnect_server(self):
        if self.voip is not None:
            try:
                self.voip.close()
            except Exception:
                pass
        return "Disconnected from VOIP server"

    def _voip_connected(self) -> bool:
        return (self.voip is not None
                and getattr(self.voip, "_sock", None) is not None)

    def _mumble_msg(self, text):
        if not self._voip_connected():
            return "Not connected to a VOIP server"
        self.voip.send_text(str(text))
        return f"Sending message: {text}"

    def _mute_mumble(self, v):
        b = self._bool_param(v)
        if b is None:
            return None
        if not self._voip_connected():
            return "Not connected to a VOIP server"
        self.voip.set_self_mute(bool(b))
        return f"Setting Mumble mute to {b}"

    def _shutdown(self):
        self.shutdown_requested = True
        return "Shutting down"

    # ------------------------------------------------------------------
    def help_text(self) -> str:
        lines = ["Available commands:"]
        for name, (nargs, txt, _) in sorted(self._commands.items()):
            lines.append(f"  {name:22s} {txt}")
        return "\n".join(lines)

    def process(self, line: str) -> str:
        """One command line -> response text (reference
        processCommand + validateCommand semantics)."""
        line = line.strip()
        if not line:
            return ""
        if line in ("help", "?"):
            return self.help_text()
        if not re.fullmatch(r"[A-Za-z0-9_\?\./:\- ]+", line):
            return "Command not recognized"
        tokens = line.split()
        verb = tokens[0]
        if verb not in self._commands:
            return "Command not recognized"
        nargs, _txt, fn = self._commands[verb]
        args = tokens[1:]
        if len(args) < nargs:
            return "Command parameters are missing or incorrect"
        try:
            resp = fn(*args[:nargs]) if nargs else fn()
        except Exception as e:  # mirror the reference's failure text
            return f"Command failed: {e}"
        if resp is None:
            return "Parameter value is not supported"
        return str(resp)
