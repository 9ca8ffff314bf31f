"""DMR packet-data calls: data header, block reassembly, message CRCs (a
copy of qradiolink_tpu/protocols/dmr_data.py on the port's protocols.dmr).

Re-derivation of reference src/MMDVM/DMRDataHeader.cpp (header field
layouts per data-packet format), src/DMR/dmrmessagehandler.cpp:1-392
(per-source reassembly of UDT and confirmed-data messages with CRC9
block checks and end-to-end CRC32/CCITT16), and src/DMR/crc9.cpp +
crc32.cpp (pycrc bit-by-bit variants with data-augmented finalize).

The FEC layer (BPTC / trellis) lives in qradiolink_tpu_torch.fec;
this module is the frame/byte layer on top of DecodedBurst payloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from qradiolink_tpu_torch.protocols.dmr import (
    DT_RATE_12_DATA, DT_RATE_34_DATA, DT_RATE_1_DATA, _crc_ccitt162,
)

# data packet formats (DMRDefines.h:106-112)
DPF_UDT = 0x00
DPF_RESPONSE = 0x01
DPF_UNCONFIRMED_DATA = 0x02
DPF_CONFIRMED_DATA = 0x03
DPF_DEFINED_SHORT = 0x0D
DPF_DEFINED_RAW = 0x0E
DPF_PROPRIETARY = 0x0F

_DATA_HEADER_CRC_MASK = 0xCCCC   # DMRDefines.h:74


def crc9(data: bytes, init: int = 0) -> int:
    """pycrc bit-by-bit CRC-9, poly 0x059, data-augmented finalize,
    xorout 0x1FF (reference src/DMR/crc9.cpp)."""
    crc = init
    for c in data:
        for i in range(8):
            bit = crc & 0x100
            crc = ((crc << 1) | ((c >> (7 - i)) & 1)) & 0x1FF
            if bit:
                crc ^= 0x059
    for _ in range(9):
        bit = crc & 0x100
        crc = (crc << 1) & 0x1FF
        if bit:
            crc ^= 0x059
    return (crc ^ 0x1FF) & 0x1FF


def crc32_dmr(data: bytes, init: int = 0) -> int:
    """pycrc bit-by-bit CRC-32, poly 0x04C11DB7, init/xorin 0,
    data-augmented finalize, xorout 0xFFFFFFFF
    (reference src/DMR/crc32.cpp)."""
    crc = init
    for c in data:
        for i in range(8):
            bit = crc & 0x80000000
            crc = ((crc << 1) | ((c >> (7 - i)) & 1)) & 0xFFFFFFFF
            if bit:
                crc ^= 0x04C11DB7
    for _ in range(32):
        bit = crc & 0x80000000
        crc = (crc << 1) & 0xFFFFFFFF
        if bit:
            crc ^= 0x04C11DB7
    return (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF


@dataclass
class DataHeader:
    """Decoded 12-byte DMR data header (CDMRDataHeader::put)."""
    gi: bool = False
    a: bool = False
    dpf: int = 0
    dst_id: int = 0
    src_id: int = 0
    blocks: int = 0
    pad_nibble: int = 0
    sap: int = 0
    f: bool = False
    s: bool = False
    ns: int = 0
    udt_format: int = 0
    opcode: int = 0

    @property
    def udt(self) -> bool:
        return self.dpf == DPF_UDT

    @classmethod
    def from_bytes(cls, b) -> "DataHeader | None":
        b = np.asarray(b, np.uint8).copy()
        b[10] ^= (_DATA_HEADER_CRC_MASK >> 8) & 0xFF
        b[11] ^= _DATA_HEADER_CRC_MASK & 0xFF
        if _crc_ccitt162(b[:10]) != ((int(b[10]) << 8) | int(b[11])):
            return None
        h = cls()
        h.gi = bool(b[0] & 0x80)
        h.a = bool(b[0] & 0x40)
        dpf = int(b[0]) & 0x0F
        h.dpf = dpf
        if dpf == DPF_PROPRIETARY:
            return h
        h.dst_id = (int(b[2]) << 16) | (int(b[3]) << 8) | int(b[4])
        h.src_id = (int(b[5]) << 16) | (int(b[6]) << 8) | int(b[7])
        if dpf in (DPF_UNCONFIRMED_DATA, DPF_CONFIRMED_DATA):
            h.f = bool(b[8] & 0x80)
            h.blocks = int(b[8]) & 0x7F
            h.pad_nibble = (((int(b[0]) >> 4) & 1) << 4) | (int(b[1]) & 0x0F)
            if dpf == DPF_CONFIRMED_DATA:
                h.s = bool(b[9] & 0x80)
                h.ns = (int(b[9]) >> 4) & 0x07
                h.sap = (int(b[1]) >> 4) & 0x0F
        elif dpf == DPF_RESPONSE:
            h.blocks = int(b[8]) & 0x7F
        elif dpf in (DPF_DEFINED_RAW, DPF_DEFINED_SHORT):
            h.blocks = (int(b[0]) & 0x30) + (int(b[1]) & 0x0F)
            h.f = bool(b[8] & 0x01)
            h.s = bool(b[8] & 0x02)
        elif dpf == DPF_UDT:
            h.blocks = (int(b[8]) & 0x03) + 1
            h.udt_format = int(b[1]) & 0x0F
            h.opcode = int(b[9]) & 0x3F
            h.sap = int(b[1]) >> 4
            h.pad_nibble = int(b[8]) >> 3
        return h

    def to_bytes(self) -> np.ndarray:
        """TX builder for the header formats the handler consumes."""
        b = np.zeros(12, np.uint8)
        b[0] = (0x80 if self.gi else 0) | (0x40 if self.a else 0) \
            | (self.dpf & 0x0F)
        b[2:5] = [(self.dst_id >> 16) & 0xFF, (self.dst_id >> 8) & 0xFF,
                  self.dst_id & 0xFF]
        b[5:8] = [(self.src_id >> 16) & 0xFF, (self.src_id >> 8) & 0xFF,
                  self.src_id & 0xFF]
        if self.dpf in (DPF_UNCONFIRMED_DATA, DPF_CONFIRMED_DATA):
            b[0] |= ((self.pad_nibble >> 4) & 1) << 4
            b[1] = ((self.sap & 0x0F) << 4) | (self.pad_nibble & 0x0F)
            b[8] = (0x80 if self.f else 0) | (self.blocks & 0x7F)
            if self.dpf == DPF_CONFIRMED_DATA:
                b[9] = (0x80 if self.s else 0) | ((self.ns & 0x07) << 4)
        elif self.dpf == DPF_UDT:
            b[1] = ((self.sap & 0x0F) << 4) | (self.udt_format & 0x0F)
            b[8] = ((self.pad_nibble & 0x1F) << 3) \
                | ((self.blocks - 1) & 0x03)
            b[9] = self.opcode & 0x3F
        crc = _crc_ccitt162(b[:10]) ^ _DATA_HEADER_CRC_MASK
        b[10], b[11] = (crc >> 8) & 0xFF, crc & 0xFF
        return b


@dataclass
class DataMessage:
    dpf: int = 0
    src_id: int = 0
    dst_id: int = 0
    sap: int = 0
    group: bool = False
    udt: bool = False
    udt_format: int = 0
    crc_valid: bool = False
    payload: bytes = b""


def _block_crc_ok(block: bytes) -> tuple[bool, int]:
    """Confirmed-data block CRC9 (dmrmessagehandler.cpp block_crc):
    DBSN in the top 7 bits of byte 0; 9-bit CRC (xored 0x0F0) over the
    payload bits followed by the DBSN, bit-shifted as the reference
    does."""
    bs = len(block)
    dbsn = block[0] >> 1
    crc_sent = (((block[0] & 1) << 8) | block[1]) ^ 0x0F0
    data = bytearray(block[2:]) + bytearray([(dbsn << 1) & 0xFF])
    shifted = bytearray(bs - 1)
    for i in range(bs - 2, -1, -1):
        if i > 0:
            shifted[i] = ((data[i] >> 1) | ((data[i - 1] & 1) << 7)) & 0xFF
        else:
            shifted[i] = data[i] >> 1
    return crc9(bytes(shifted)) == crc_sent, dbsn


class DmrMessageHandler:
    """Per-source reassembly of DMR data calls
    (reference DMRMessageHandler::processData)."""

    BLOCK_SIZE = {DT_RATE_12_DATA: 12, DT_RATE_34_DATA: 18,
                  DT_RATE_1_DATA: 24}

    def __init__(self):
        self._msgs: dict[int, dict] = {}

    def process_header(self, payload12: bytes, src_id: int | None = None):
        hdr = DataHeader.from_bytes(np.frombuffer(bytes(payload12[:12]),
                                                  np.uint8))
        if hdr is None:
            return None
        src = hdr.src_id if src_id is None else src_id
        if hdr.dpf == DPF_CONFIRMED_DATA and hdr.blocks > 64:
            self._msgs.pop(src, None)
            return hdr
        self._msgs[src] = {
            "hdr": hdr, "left": hdr.blocks, "chunks": [],
            "crc_valid": True}
        return hdr

    def process_block(self, data_type: int, payload: bytes,
                      src_id: int) -> DataMessage | None:
        """One rate-1/2 / 3/4 / 1 data block; returns the finished
        DataMessage when the last expected block arrives."""
        st = self._msgs.get(src_id)
        if st is None or st["left"] <= 0:
            return None
        hdr: DataHeader = st["hdr"]
        bs = self.BLOCK_SIZE[data_type]
        block = bytes(payload[:bs]).ljust(bs, b"\x00")
        if hdr.udt and data_type == DT_RATE_12_DATA:
            st["chunks"].append(block)
        elif hdr.dpf == DPF_CONFIRMED_DATA:
            ok, _dbsn = _block_crc_ok(block)
            if not ok and not (hdr.sap == 9 and st["left"] > 1):
                st["crc_valid"] = False
            st["chunks"].append(block[2:])
        else:
            st["chunks"].append(block)
        st["left"] -= 1
        if st["left"] > 0:
            return None
        del self._msgs[src_id]
        message = b"".join(st["chunks"])
        msg = DataMessage(dpf=hdr.dpf, src_id=hdr.src_id,
                          dst_id=hdr.dst_id, sap=hdr.sap, group=hdr.gi,
                          udt=hdr.udt, udt_format=hdr.udt_format)
        if hdr.udt:
            msg.crc_valid = _crc_ccitt162(message[:-2]) == \
                int.from_bytes(message[-2:], "big")
            msg.payload = message[:-2]
            return msg
        if hdr.dpf == DPF_CONFIRMED_DATA:
            if not st["crc_valid"]:
                msg.crc_valid = False
                return msg
            # end-to-end CRC32 over byte-swapped pairs
            # (dmrmessagehandler.cpp message_crc32)
            n = len(message) - 4
            crc_sent = int.from_bytes(message[n:n + 4], "big")
            swapped = bytearray(n)
            for i in range(0, n - 1, 2):
                swapped[i] = message[i + 1]
                swapped[i + 1] = message[i]
            msg.crc_valid = crc32_dmr(bytes(swapped)) == crc_sent
            msg.payload = message[:n]
            return msg
        msg.crc_valid = True
        msg.payload = message
        return msg


def build_confirmed_blocks(payload: bytes, blocks: int | None = None):
    """TX complement: payload -> list of 12-byte confirmed rate-1/2
    blocks (DBSN + CRC9 prefix per block) + trailing CRC32, sized so
    the handler reassembles exactly `payload`."""
    per = 10
    body = bytearray(payload)
    total = len(body) + 4
    n = blocks or -(-total // per)
    body += b"\x00" * (n * per - total)
    # CRC32 over byte-swapped pairs of the first n*10-4 bytes
    m = n * per - 4
    swapped = bytearray(m)
    for i in range(0, m - 1, 2):
        swapped[i] = body[i + 1]
        swapped[i + 1] = body[i]
    crc = crc32_dmr(bytes(swapped))
    full = bytes(body[:m]) + crc.to_bytes(4, "big")
    out = []
    for bi in range(n):
        chunk = full[bi * per:(bi + 1) * per]
        dbsn = bi & 0x7F
        data = bytearray(chunk) + bytearray([(dbsn << 1) & 0xFF])
        shifted = bytearray(11)
        for i in range(10, -1, -1):
            if i > 0:
                shifted[i] = ((data[i] >> 1)
                              | ((data[i - 1] & 1) << 7)) & 0xFF
            else:
                shifted[i] = data[i] >> 1
        c = crc9(bytes(shifted)) ^ 0x0F0
        out.append(bytes([(dbsn << 1) | ((c >> 8) & 1), c & 0xFF]) + chunk)
    return out
