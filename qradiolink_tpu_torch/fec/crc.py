"""CRCs used across the protocol layers (a copy of
qradiolink_tpu/fec/crc.py, pure numpy; the port keeps its own).

  crc32        IEEE 802.3 (reflected, poly 0xEDB88320) — layer2 protobuf
               messages and IP/video frames (reference src/ext/crc32.cpp,
               src/layer2.h:34-70)
  crc16_ccitt  poly 0x1021, init 0xFFFF — DMR headers (reference
               src/MMDVM/CRC.cpp usage)
  crc16_m17    M17 spec CRC: poly 0x5935, init 0xFFFF, non-reflected
  crc9_dmr     DMR rate-3/4 data CRC-9 (poly 0x059)
  crc8         poly 0x07 (MMDVM control)

Byte-wise table implementations over numpy uint8 arrays (host side — CRCs
guard host-side framing, matching the reference's split where CRC checks
happen in the control thread, reference src/radiocontroller.cpp:1595-1613).
"""

from __future__ import annotations

import numpy as np


def _make_table_reflected(poly: int) -> np.ndarray:
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if (c & 1) else 0)
        tab[i] = c
    return tab


def _make_table_msb(poly: int, width: int) -> np.ndarray:
    tab = np.zeros(256, np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        tab[i] = c & mask
    return tab


_CRC32_TAB = _make_table_reflected(0xEDB88320)
_CRC16_CCITT_TAB = _make_table_msb(0x1021, 16)
_CRC16_M17_TAB = _make_table_msb(0x5935, 16)
_CRC8_TAB = _make_table_msb(0x07, 8)


def crc32(data) -> int:
    d = np.frombuffer(bytes(data), np.uint8)
    c = np.uint32(0xFFFFFFFF)
    for b in d:
        c = _CRC32_TAB[(c ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c ^ np.uint32(0xFFFFFFFF))


def crc16_ccitt(data, init: int = 0xFFFF) -> int:
    d = np.frombuffer(bytes(data), np.uint8)
    c = np.uint32(init)
    for b in d:
        c = (_CRC16_CCITT_TAB[((c >> np.uint32(8)) ^ b) & 0xFF]
             ^ ((c << np.uint32(8)) & np.uint32(0xFFFF)))
    return int(c & 0xFFFF)


def crc16_m17(data) -> int:
    d = np.frombuffer(bytes(data), np.uint8)
    c = np.uint32(0xFFFF)
    for b in d:
        c = (_CRC16_M17_TAB[((c >> np.uint32(8)) ^ b) & 0xFF]
             ^ ((c << np.uint32(8)) & np.uint32(0xFFFF)))
    return int(c & 0xFFFF)


def crc8(data) -> int:
    d = np.frombuffer(bytes(data), np.uint8)
    c = np.uint32(0)
    for b in d:
        c = _CRC8_TAB[(c ^ b) & 0xFF]
    return int(c & 0xFF)


def crc9_dmr(bits: np.ndarray) -> int:
    """Bit-serial CRC-9 over a 0/1 bit array (poly x^9+x^6+x^4+x^3+1)."""
    poly = 0x059
    c = 0
    for b in np.asarray(bits, np.uint8):
        fb = ((c >> 8) ^ int(b)) & 1
        c = (c << 1) & 0x1FF
        if fb:
            c ^= poly
    return c & 0x1FF
