"""Minimal native FLAC codec (no external libraries): a copy of
qradiolink_tpu/audio/flac.py (numpy only), kept in the port so that it
imports nothing of the JAX package; the files it writes equal that
module's byte for byte.

The reference records RX audio as FLAC via libsndfile (reference
src/audio/audiorecorder.cpp:24,39). This module needs neither libsndfile
nor libFLAC: it implements the FLAC stream format directly from the
format specification: STREAMINFO + frames with CONSTANT and VERBATIM
subframes, CRC-8 frame headers and CRC-16 frame trailers. CONSTANT
subframes make digital silence nearly free; other content is stored
verbatim (lossless, bit-exact, larger than a predictive encoder would
produce — correctness over ratio).

A matching minimal reader is included for round-trip verification and
for tooling that wants the recorded audio back.
"""

from __future__ import annotations

import struct

import numpy as np

_BLOCK = 4096


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def pad_to_byte(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        return bytes(self.buf)


def _utf8_number(n: int) -> bytes:
    """FLAC's extended-UTF-8 coding of the frame number."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > 5 * nbytes + (6 - nbytes) + 1 and nbytes < 7:
        nbytes += 1
    # leading byte: nbytes ones, a zero, then the top bits
    shift = 6 * (nbytes - 1)
    lead_prefix = (0xFF << (8 - nbytes)) & 0xFF
    out.append(lead_prefix | ((n >> shift) & ((1 << (7 - nbytes)) - 1)))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


_RATE_CODES = {88200: 0b0001, 176400: 0b0010, 192000: 0b0011,
               8000: 0b0100, 16000: 0b0101, 22050: 0b0110, 24000: 0b0111,
               32000: 0b1000, 44100: 0b1001, 48000: 0b1010, 96000: 0b1011}


def write_flac(path, samples: np.ndarray, rate: int = 8000) -> None:
    """Write mono int16 samples as a FLAC file."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(np.asarray(samples, np.float64) * 32767.0,
                          -32768, 32767).astype(np.int16)
    n_total = samples.size

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block, type 0, length 34)
    si = _BitWriter()
    si.write(_BLOCK, 16)               # min block size
    si.write(_BLOCK, 16)               # max block size
    si.write(0, 24)                    # min frame size (unknown)
    si.write(0, 24)                    # max frame size (unknown)
    si.write(rate, 20)
    si.write(0, 3)                     # channels - 1
    si.write(15, 5)                    # bits per sample - 1
    si.write(n_total, 36)
    body = si.bytes() + b"\x00" * 16   # md5 unset
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    for fi in range(0, max(1, -(-n_total // _BLOCK))):
        blk = samples[fi * _BLOCK: (fi + 1) * _BLOCK]
        bs = blk.size
        if bs == 0:
            break
        bw = _BitWriter()
        bw.write(0b11111111111110, 14)  # sync
        bw.write(0, 1)                  # reserved
        bw.write(0, 1)                  # fixed blocking
        if bs == _BLOCK:
            bw.write(0b1100, 4)         # 256 * 2^4 = 4096
            bs_tail = None
        else:
            bw.write(0b0111, 4)         # 16-bit block size at end
            bs_tail = bs - 1
        bw.write(_RATE_CODES.get(rate, 0b0000), 4)
        bw.write(0, 4)                  # mono
        bw.write(0b100, 3)              # 16 bits/sample
        bw.write(0, 1)                  # reserved
        for b in _utf8_number(fi):
            bw.write(b, 8)
        if bs_tail is not None:
            bw.write(bs_tail, 16)
        hdr = bw.bytes()
        assert bw.nbits == 0
        bw.write(_crc8(hdr), 8)
        # subframe
        if bs and np.all(blk == blk[0]):
            bw.write(0, 1)
            bw.write(0b000000, 6)       # CONSTANT
            bw.write(0, 1)
            bw.write(int(blk[0]) & 0xFFFF, 16)
        else:
            bw.write(0, 1)
            bw.write(0b000001, 6)       # VERBATIM
            bw.write(0, 1)
            # mono 16-bit keeps the stream byte-aligned here: the frame
            # header is whole bytes, CRC-8 is one byte, the subframe
            # header is one byte — so the sample payload is written as
            # one big-endian int16 block instead of a per-sample bit loop
            assert bw.nbits == 0
            bw.buf += blk.astype(">i2").tobytes()
        bw.pad_to_byte()
        frame = bw.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame

    with open(path, "wb") as f:
        f.write(bytes(out))


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            v = (v << 1) | b
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


def read_flac(path):
    """Minimal reader for files produced by write_flac (mono, 16-bit,
    CONSTANT/VERBATIM subframes). Returns (samples int16, rate)."""
    data = open(path, "rb").read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    rate = None
    n_total = 0
    while True:
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        if (hdr & 0x7F) == 0:
            br = _BitReader(data, pos + 4)
            br.read(16)
            br.read(16)
            br.read(24)
            br.read(24)
            rate = br.read(20)
            br.read(3)
            br.read(5)
            n_total = br.read(36)
        pos += 4 + length
        if hdr & 0x80:
            break
    out = []
    while pos < len(data) and len(out) < n_total:
        br = _BitReader(data, pos)
        if br.read(14) != 0b11111111111110:
            raise ValueError("lost frame sync")
        br.read(2)
        bs_code = br.read(4)
        br.read(4)
        br.read(4)
        br.read(3)
        br.read(1)
        first = br.read(8)
        extra = 0
        if first >= 0xC0:
            n = 0
            while (first << n) & 0x80:
                n += 1
            extra = n - 1
        for _ in range(extra):
            br.read(8)
        if bs_code == 0b1100:
            bs = 4096
        elif bs_code == 0b0111:
            bs = br.read(16) + 1
        else:
            raise ValueError(f"unsupported block size code {bs_code}")
        br.read(8)  # crc8
        br.read(1)
        stype = br.read(6)
        br.read(1)
        if stype == 0:
            v = br.read(16)
            if v >= 0x8000:
                v -= 0x10000
            out.extend([v] * bs)
        elif stype == 1:
            for _ in range(bs):
                v = br.read(16)
                if v >= 0x8000:
                    v -= 0x10000
                out.append(v)
        else:
            raise ValueError(f"unsupported subframe type {stype}")
        br.align()
        pos = br.byte + 2  # skip crc16
    return np.asarray(out[:n_total], np.int16), rate
