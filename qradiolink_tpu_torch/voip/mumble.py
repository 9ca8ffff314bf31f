"""Mumble VOIP client: control protocol + Opus voice (port of
qradiolink_tpu/voip/mumble.py, host-side: sockets and bytes, the protobuf
fields through the port's framing/layer2.py helpers).

Re-derivation of reference src/mumbleclient.cpp:1-907 +
src/sslclient.cpp: the Mumble control protocol is protobuf messages in
[u16 type BE][u32 length BE] frames over TLS TCP; voice is the legacy
low-latency packet format (header byte with codec type in the top 3
bits, Mumble-varint sequence number, length-prefixed Opus frames),
tunneled through TCP as message type 1 (UDPTunnel) like the reference
does (mumbleclient.cpp:728-733 — plain UDP voice would need OCB2
crypto, which the reference also skips).

The protobuf subset is hand-rolled (the same minimal proto2 wire codec
approach as framing/layer2.py) covering the message types the
reference exchanges: Version(0), UDPTunnel(1), Authenticate(2),
Ping(3), Reject(4), ServerSync(5), ChannelState(7), UserRemove(8),
UserState(9), TextMessage(11), CryptSetup(15). Field numbers are
interface constants of the public Mumble.proto schema.

Voice payloads use the radio Opus profile from audio/codecs.py; text
messages double as the remote-control transport (reference
commandprocessor.h:131 — the same CommandProcessor parses them).
"""

from __future__ import annotations

import socket
import ssl
import struct
import time
from dataclasses import dataclass
from typing import Callable

from qradiolink_tpu_torch.framing.layer2 import _pb_scan, _pb_str, _pb_uint

# message types (Mumble protocol)
MSG_VERSION = 0
MSG_UDPTUNNEL = 1
MSG_AUTHENTICATE = 2
MSG_PING = 3
MSG_REJECT = 4
MSG_SERVERSYNC = 5
MSG_CHANNELREMOVE = 6
MSG_CHANNELSTATE = 7
MSG_USERREMOVE = 8
MSG_USERSTATE = 9
MSG_TEXTMESSAGE = 11
MSG_CRYPTSETUP = 15
MSG_CODECVERSION = 21
MSG_SERVERCONFIG = 24

VOICE_OPUS = 4      # codec type in the voice header (type << 5)


def mumble_varint(value: int) -> bytes:
    """Mumble PacketDataStream varint (NOT protobuf varint)."""
    v = int(value)
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF4]) + struct.pack(">Q", v)


def read_mumble_varint(data: bytes, pos: int) -> tuple[int, int]:
    b = data[pos]
    if (b & 0x80) == 0:
        return b, pos + 1
    if (b & 0xC0) == 0x80:
        return ((b & 0x3F) << 8) | data[pos + 1], pos + 2
    if (b & 0xE0) == 0xC0:
        return ((b & 0x1F) << 16) | (data[pos + 1] << 8) | data[pos + 2], \
            pos + 3
    if (b & 0xF0) == 0xE0:
        return ((b & 0x0F) << 24) | (data[pos + 1] << 16) \
            | (data[pos + 2] << 8) | data[pos + 3], pos + 4
    if (b & 0xFC) == 0xF4:
        return struct.unpack(">Q", data[pos + 1:pos + 9])[0], pos + 9
    raise ValueError("unsupported varint prefix")


@dataclass
class Station:
    """One connected user (reference station.h Station)."""
    id: int = -1
    callsign: str = ""
    channel_id: int = -1
    mute: bool = False
    deaf: bool = False


@dataclass
class Channel:
    id: int = 0
    parent: int = 0
    name: str = ""
    description: str = ""


class MumbleClient:
    """Minimal-but-real Mumble client.

    Callbacks: on_text(message, sender_name, channel: bool),
    on_voice(session, opus_bytes), on_user_joined(Station),
    on_user_left(session), on_connected(session_id).
    """

    PING_INTERVAL = 5.0

    def __init__(self, host: str, port: int = 64738,
                 username: str = "qradiolink", password: str = "",
                 use_ssl: bool = True, timeout: float = 5.0):
        self.host, self.port = host, int(port)
        self.username, self.password = username, password
        self.use_ssl = use_ssl
        self.timeout = timeout
        self.session = -1
        self.synchronized = False
        self.channels: dict[int, Channel] = {}
        self.stations: dict[int, Station] = {}
        self.current_channel = -1
        self._sock = None
        self._buf = b""
        self._seq = 0
        self._last_ping = 0.0
        self.on_text: Callable | None = None
        self.on_voice: Callable | None = None
        self.on_user_joined: Callable | None = None
        self.on_user_left: Callable | None = None
        self.on_connected: Callable | None = None

    # ------------------------------------------------------------ transport
    def connect(self):
        raw = socket.create_connection((self.host, self.port),
                                       timeout=self.timeout)
        if self.use_ssl:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE   # reference accepts self-signed
            self._sock = ctx.wrap_socket(raw, server_hostname=self.host)
        else:
            self._sock = raw
        self._sock.settimeout(0.05)
        self._send_version()
        self._send_authenticate()

    def close(self):
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self.synchronized = False

    def _send(self, mtype: int, payload: bytes):
        if self._sock is None:
            return
        self._sock.sendall(struct.pack(">HI", mtype, len(payload)) + payload)

    # ------------------------------------------------------------- messages
    def _send_version(self):
        # version 1.2.8 like the reference (mumbleclient.cpp:117-126)
        pb = _pb_uint(1, (1 << 16) | (2 << 8) | 8) \
            + _pb_str(2, "1.2.8") + _pb_str(3, "qradiolink-tpu") \
            + _pb_str(4, "unix")
        self._send(MSG_VERSION, pb)

    def _send_authenticate(self):
        pb = _pb_str(1, self.username)
        if self.password:
            pb += _pb_str(2, self.password)
        pb += _pb_uint(5, 1)     # opus = true
        self._send(MSG_AUTHENTICATE, pb)

    def ping(self):
        self._send(MSG_PING, _pb_uint(1, int(time.time())))
        self._last_ping = time.monotonic()

    def join_channel(self, channel_id: int):
        """UserState with our session + channel (mumbleclient.cpp:428)."""
        pb = _pb_uint(1, self.session) + _pb_uint(5, channel_id)
        self._send(MSG_USERSTATE, pb)
        self.current_channel = channel_id

    def set_self_mute(self, mute: bool):
        pb = _pb_uint(1, self.session) + _pb_uint(9, 1 if mute else 0)
        self._send(MSG_USERSTATE, pb)

    def set_self_deaf(self, deaf: bool):
        pb = _pb_uint(1, self.session) + _pb_uint(10, 1 if deaf else 0)
        self._send(MSG_USERSTATE, pb)

    def send_text(self, message: str, channel_id: int | None = None,
                  session: int | None = None):
        pb = b""
        if session is not None:
            pb += _pb_uint(2, session)
        if channel_id is not None:
            pb += _pb_uint(3, channel_id)
        elif session is None:
            pb += _pb_uint(3, max(self.current_channel, 0))
        pb += _pb_str(5, message)
        self._send(MSG_TEXTMESSAGE, pb)

    def send_opus_voice(self, opus_packet: bytes, target: int = 0):
        """One Opus frame as a legacy voice packet through the TCP
        tunnel (mumbleclient.cpp createVoicePacket:703-737)."""
        head = bytes([(VOICE_OPUS << 5) | (target & 0x1F)])
        body = mumble_varint(self._seq) \
            + mumble_varint(len(opus_packet)) + opus_packet
        self._seq += 2
        self._send(MSG_UDPTUNNEL, head + body)

    # ------------------------------------------------------------ receive
    def poll(self):
        """Drain pending messages; send the keepalive ping when due."""
        if self._sock is None:
            return
        if self.synchronized and \
                time.monotonic() - self._last_ping > self.PING_INTERVAL:
            self.ping()
        while True:
            try:
                chunk = self._sock.recv(65536)
            except (TimeoutError, ssl.SSLWantReadError, BlockingIOError,
                    socket.timeout):
                break
            except OSError:
                self.close()
                return
            if not chunk:
                self.close()
                return
            self._buf += chunk
        while len(self._buf) >= 6:
            mtype, ln = struct.unpack(">HI", self._buf[:6])
            if len(self._buf) < 6 + ln:
                break
            payload = self._buf[6:6 + ln]
            self._buf = self._buf[6 + ln:]
            self._handle(mtype, payload)

    def _handle(self, mtype: int, payload: bytes):
        if mtype == MSG_SERVERSYNC:
            f = {k: v for k, _w, v in _pb_scan(payload)}
            self.session = int(f.get(1, 0))
            self.synchronized = True
            self.ping()
            if self.on_connected:
                self.on_connected(self.session)
        elif mtype == MSG_CHANNELSTATE:
            f = {k: v for k, _w, v in _pb_scan(payload)}
            ch = Channel(id=int(f.get(1, 0)), parent=int(f.get(2, 0)),
                         name=(f.get(3, b"") or b"").decode("utf-8",
                                                            "replace"))
            self.channels[ch.id] = ch
        elif mtype == MSG_USERSTATE:
            f = {k: v for k, _w, v in _pb_scan(payload)}
            sid = int(f.get(1, -1))
            st = self.stations.get(sid, Station(id=sid))
            if 3 in f:
                st.callsign = f[3].decode("utf-8", "replace")
            if 5 in f:
                st.channel_id = int(f[5])
            new = sid not in self.stations
            self.stations[sid] = st
            if new and sid != self.session and self.on_user_joined:
                self.on_user_joined(st)
        elif mtype == MSG_USERREMOVE:
            f = {k: v for k, _w, v in _pb_scan(payload)}
            sid = int(f.get(1, -1))
            self.stations.pop(sid, None)
            if self.on_user_left:
                self.on_user_left(sid)
        elif mtype == MSG_TEXTMESSAGE:
            f = {k: v for k, _w, v in _pb_scan(payload)}
            actor = int(f.get(1, -1))
            msg = (f.get(5, b"") or b"").decode("utf-8", "replace")
            sender = self.stations.get(actor, Station()).callsign
            channel_msg = 3 in f
            if self.on_text:
                self.on_text(msg, sender, channel_msg)
        elif mtype == MSG_UDPTUNNEL:
            self._handle_voice(payload)
        elif mtype == MSG_REJECT:
            self.close()

    def _handle_voice(self, data: bytes):
        """Legacy voice packet from the tunnel
        (mumbleclient.cpp processUDPData/processIncomingAudioPacket)."""
        if not data:
            return
        vtype = data[0] >> 5
        if vtype == 1:      # UDP ping
            return
        session = None
        pos = 1
        # server->client packets carry the sender session first
        session, pos = read_mumble_varint(data, pos)
        _seq, pos = read_mumble_varint(data, pos)
        if vtype != VOICE_OPUS:
            return
        ln, pos = read_mumble_varint(data, pos)
        size = ln & 0x1FFF
        opus = data[pos:pos + size]
        if self.on_voice and opus:
            self.on_voice(session, opus)
