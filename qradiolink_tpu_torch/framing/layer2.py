"""Layer-2 radio messages: CRC32-guarded payloads, paging and repeater info
(a copy of qradiolink_tpu/framing/layer2.py on the port's fec.crc).

Mirrors the role of the reference's Layer2 (reference src/layer2.h:34-70:
protobuf PageMessage/RepeaterInfo + CRC32 trailer). The wire format here is
a compact length-prefixed binary encoding rather than protobuf (the
reference's .proto schema is not reproduced); the API surface (build/parse
with CRC check, page messages with callsigns) is equivalent.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from qradiolink_tpu_torch.fec.crc import crc32

MAGIC = 0x4C32  # "L2"


@dataclass
class PageMessage:
    target_callsign: str = ""
    source_callsign: str = ""
    message: str = ""

    def encode(self) -> bytes:
        parts = []
        for s in (self.target_callsign, self.source_callsign, self.message):
            b = s.encode("utf-8")[:255]
            parts.append(struct.pack("B", len(b)) + b)
        return b"".join(parts)

    @classmethod
    def decode(cls, data: bytes) -> "PageMessage":
        fields = []
        pos = 0
        for _ in range(3):
            ln = data[pos]
            fields.append(data[pos + 1: pos + 1 + ln].decode("utf-8",
                                                             "replace"))
            pos += 1 + ln
        return cls(*fields)


MSG_PAGE = 1
MSG_REPEATER_INFO = 2
MSG_RAW = 0


def build_layer2_frame(payload: bytes, msg_type: int = MSG_RAW) -> bytes:
    """[magic u16][type u8][len u16][payload][crc32 u32] big-endian."""
    head = struct.pack(">HBH", MAGIC, msg_type, len(payload))
    body = head + payload
    return body + struct.pack(">I", crc32(body))


def parse_layer2_frame(frame: bytes):
    """Returns (msg_type, payload) or None on CRC/format failure."""
    if len(frame) < 9:
        return None
    magic, msg_type, ln = struct.unpack(">H B H", frame[:5])
    if magic != MAGIC or len(frame) < 5 + ln + 4:
        return None
    body = frame[: 5 + ln]
    (crc,) = struct.unpack(">I", frame[5 + ln: 9 + ln])
    if crc32(body) != crc:
        return None
    return msg_type, frame[5: 5 + ln]


# ---------------------------------------------------------------------------
# protobuf wire compatibility (reference src/ext/QRadioLink.proto +
# src/layer2.cpp serializes PageMessage / RepeaterInfo with protobuf):
# a minimal proto2 wire codec for those messages, so frames interchange
# with the reference byte-for-byte. Field numbers/types are interface
# constants of the schema; the wire format is the public protobuf spec.

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(data: bytes, pos: int):
    n = s = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << s
        if not b & 0x80:
            return n, pos
        s += 7


def _pb_str(field: int, s: str) -> bytes:
    b = s.encode("utf-8")
    return _varint((field << 3) | 2) + _varint(len(b)) + b


def _pb_uint(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(v)


def _pb_scan(data: bytes):
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(data, pos)
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = data[pos:pos + 4]
            pos += 4
        elif wt == 1:
            v = data[pos:pos + 8]
            pos += 8
        else:
            return
        yield field, wt, v


def page_message_to_proto(m: PageMessage, retransmit: bool = False) -> bytes:
    """PageMessage -> proto2 wire bytes (QRadioLink.proto fields 1-4)."""
    out = _pb_str(1, m.source_callsign) + _pb_str(2, m.target_callsign)
    if m.message:
        out += _pb_str(3, m.message)
    if retransmit:
        out += _pb_uint(4, 1)
    return out


def page_message_from_proto(data: bytes) -> PageMessage:
    m = PageMessage()
    for field, wt, v in _pb_scan(data):
        if wt != 2:
            continue
        s = v.decode("utf-8", "replace")
        if field == 1:
            m.source_callsign = s
        elif field == 2:
            m.target_callsign = s
        elif field == 3:
            m.message = s
    return m


def repeater_info_to_proto(channels=(), users=()) -> bytes:
    """channels: [(id, parent_id, name, description)], users:
    [(session, name, user_id, channel_id)] -> RepeaterInfo wire bytes."""
    out = b""
    for cid, pid, name, desc in channels:
        sub = (_pb_uint(1, cid) + _pb_uint(2, pid)
               + _pb_str(3, name) + _pb_str(4, desc))
        out += _varint((1 << 3) | 2) + _varint(len(sub)) + sub
    for session, name, uid, cid in users:
        sub = (_pb_uint(1, session) + _pb_str(2, name)
               + _pb_uint(3, uid) + _pb_uint(4, cid))
        out += _varint((2 << 3) | 2) + _varint(len(sub)) + sub
    return out


def repeater_info_from_proto(data: bytes):
    channels, users = [], []
    for field, wt, v in _pb_scan(data):
        if wt != 2:
            continue
        fields = {f: val for f, _w, val in _pb_scan(v)}
        if field == 1:
            channels.append((fields.get(1, 0), fields.get(2, 0),
                             (fields.get(3, b"") or b"").decode("utf-8",
                                                                "replace"),
                             (fields.get(4, b"") or b"").decode("utf-8",
                                                                "replace")))
        elif field == 2:
            users.append((fields.get(1, 0),
                          (fields.get(2, b"") or b"").decode("utf-8",
                                                             "replace"),
                          fields.get(3, 0), fields.get(4, 0)))
    return channels, users
