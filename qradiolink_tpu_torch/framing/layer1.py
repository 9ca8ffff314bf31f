"""Layer-1 framing: sync words, frame building, vectorized deframing (a
copy of qradiolink_tpu/framing/layer1.py, pure numpy; the M17 sync hunt
is `Deframer.process`).

Frame-type sync words and per-mode frame lengths mirror the reference
protocol constants (reference src/layer1framing.h:8-24 and the tables in
src/gr_modem.cpp:105-322); TX header construction mirrors
gr_modem::frame() (src/gr_modem.cpp:904-961): voice frames on wideband
modes get a 2-byte sync + 0xAA reserved byte, narrowband ("1K") modes a
1-byte sync, data/text/video frames a 3-byte sync; burst-mode IP frames are
preceded by a 0xAA preamble run.

RX deframing replaces the reference's bit-serial shift-register hunt
(gr_modem::findSync, src/gr_modem.cpp:1183-1283) with a vectorized rolling
32-bit word comparison over whole bit blocks, preserving the same match
priority and resume semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class FrameType(IntEnum):
    NONE = 0x00
    VOICE_1 = 0xB5          # 1-byte sync, narrowband voice
    VOICE_2 = 0xED89        # 2-byte sync, wideband voice
    TEXT = 0x89EDAA
    IP = 0xDE98AA
    VIDEO = 0x98DEAA
    SYNC = 0xCC
    CALLSIGN = 0x8CC8DD
    PROTO = 0xED77AA
    END = 0x4C8A2B
    M17_STREAM = 0xFF5D
    M17_LSF = 0x55F7
    M17_EOT = 0x555D555D


def _word_bits(word: int) -> int:
    n = 8
    while word >> n:
        n += 8
    return n


@dataclass(frozen=True)
class FrameConfig:
    """Per-mode framing parameters (payload bytes, bit buffer length)."""
    frame_length: int     # payload bytes per frame (_rx_frame_length)
    bit_buf_len: int      # bits collected after sync (_bit_buf_len)
    narrowband: bool      # "1K" modes: 1-byte voice sync, no reserved byte
    data_mode: bool = False  # IP/video modes hunt IP/VIDEO/END only
    m17_mode: bool = False   # M17: 16-bit LSF/STREAM syncs, 46-byte frames


# mode name -> framing config (reference src/gr_modem.cpp:105-322)
MODE_FRAME_CONFIG = {
    "BPSK1K": FrameConfig(4, 4 * 8, True),
    "BPSK2K": FrameConfig(7, 8 * 8, False),
    "2FSK1K": FrameConfig(4, 4 * 8, True),
    "2FSK1KFM": FrameConfig(4, 4 * 8, True),
    "2FSK2K": FrameConfig(7, 8 * 8, False),
    "2FSK2KFM": FrameConfig(7, 8 * 8, False),
    "2FSK10KFM": FrameConfig(47, 48 * 8, False),
    "GMSK1K": FrameConfig(4, 4 * 8, True),
    "GMSK2K": FrameConfig(7, 8 * 8, False),
    "GMSK10K": FrameConfig(47, 48 * 8, False),
    "4FSK1KFM": FrameConfig(4, 4 * 8, True),
    "4FSK2K": FrameConfig(7, 8 * 8, False),
    "4FSK2KFM": FrameConfig(7, 8 * 8, False),
    "4FSK10KFM": FrameConfig(47, 48 * 8, False),
    "4FSK100K": FrameConfig(622, 623 * 8, False, data_mode=True),
    "QPSK2K": FrameConfig(7, 8 * 8, False),
    "QPSK20K": FrameConfig(47, 48 * 8, False),
    "QPSK250K": FrameConfig(1516, 1517 * 8, False, data_mode=True),
    "QPSKVideo": FrameConfig(3122, 3123 * 8, False, data_mode=True),
    # reference src/gr_modem.cpp:309-313 (rx_frame_length 46, bit_buf 46*8)
    "M17": FrameConfig(46, 46 * 8, False, m17_mode=True),
}


class Layer1Framer:
    """Builds TX byte frames with sync headers (gr_modem::frame parity)."""

    def __init__(self, mode: str, burst_ip: bool = False):
        self.cfg = MODE_FRAME_CONFIG[mode]
        self.burst_ip = burst_ip

    def header(self, frame_type: FrameType) -> bytes:
        if frame_type in (FrameType.VOICE_1, FrameType.VOICE_2):
            if self.cfg.narrowband:
                return bytes([FrameType.VOICE_1 & 0xFF])
            return bytes([(FrameType.VOICE_2 >> 8) & 0xFF,
                          FrameType.VOICE_2 & 0xFF, 0xAA])
        w = int(frame_type)
        out = [(w >> s) & 0xFF for s in range(24, -8, -8)]
        return bytes(b for b in out if b != 0)

    def frame(self, payload: bytes, frame_type: FrameType) -> bytes:
        head = b""
        if frame_type == FrameType.IP and self.burst_ip:
            head += b"\xAA" * 10
        head += self.header(frame_type)
        body = bytes(payload)
        # pad/truncate to the mode's payload size
        n = self.cfg.frame_length
        body = body[:n] + b"\x00" * max(0, n - len(body))
        return head + body

    def end_frame(self) -> bytes:
        return self.header(FrameType.END) + b"\x00" * 2


def _rolling_words(bits: np.ndarray) -> np.ndarray:
    """bits (T,) 0/1 -> rolling 32-bit words (T,), word[n] = last 32 bits
    ending at n (bit n is LSB)."""
    w = np.zeros(len(bits), np.uint64)
    # w[n] = sum_{k<32} bits[n-k] << k, built from 32 shifted copies
    b = bits.astype(np.uint64)
    shifted = np.zeros(len(bits), np.uint64)
    for k in range(32):
        if k == 0:
            shifted = b.copy()
        else:
            shifted[k:] = b[:-k] << np.uint64(k)
            shifted[:k] = 0
        w |= shifted
    return w


class Deframer:
    """Streaming deframer: bits in, (frame_type, payload bytes) out.

    Hunt priority mirrors gr_modem::findSync: narrowband modes match the
    1-byte VOICE_1 sync; data modes (QPSK250K/Video/4FSK100K) match
    IP/VIDEO/END; all other modes match VOICE_2 (16-bit) then the 24-bit
    TEXT/PROTO/VIDEO/CALLSIGN/END words.
    """

    def __init__(self, mode: str, sync_tolerance: int | None = None):
        self.mode = mode
        self.cfg = MODE_FRAME_CONFIG[mode]
        # M17 syncs are hunted with a Hamming-distance tolerance (the
        # M17 spec's correlator accepts imperfect sync words; the
        # reference's bit-serial findSync is exact, gr_modem.cpp:1190,
        # but its M17 library correlates at symbol level). Tolerance 1
        # on a 16-bit word: false-hit rate 0.026%/offset (tolerance 2
        # misclassified stream data as LSF syncs); syncs that arrive
        # with more errors are recovered by LICH late entry instead.
        if sync_tolerance is None:
            sync_tolerance = 1 if self.cfg.m17_mode else 0
        self.sync_tolerance = int(sync_tolerance)
        if self.cfg.m17_mode:
            # reference gr_modem::findSync M17 branch (gr_modem.cpp:1187-1210)
            self.sync_set = [FrameType.M17_LSF, FrameType.M17_STREAM,
                             FrameType.M17_EOT]
        elif self.cfg.narrowband:
            self.sync_set = [FrameType.VOICE_1]
        elif self.cfg.data_mode:
            self.sync_set = [FrameType.IP, FrameType.VIDEO, FrameType.END]
        else:
            self.sync_set = [FrameType.VOICE_2, FrameType.TEXT,
                             FrameType.PROTO, FrameType.VIDEO,
                             FrameType.CALLSIGN, FrameType.END]
        self._pending = np.zeros(0, np.uint8)
        self.frames_synced = 0
        self.sync_misses = 0

    def reset(self):
        self._pending = np.zeros(0, np.uint8)

    def process(self, bits: np.ndarray):
        """Consume a block of hard bits; return list of (FrameType, bytes)."""
        bits = np.asarray(bits, np.uint8).ravel()
        buf = np.concatenate([self._pending, bits])
        words = _rolling_words(buf)
        frames = []
        pos = 0
        n = len(buf)
        while pos < n:
            # find next sync at or after pos (syncs end at index >= pos+...)
            hit = None
            hit_type = None
            for ft in self.sync_set:
                wbits = _word_bits(int(ft))
                mask = np.uint64((1 << wbits) - 1)
                # the whole sync word must lie at or after pos (the
                # reference clears its shift register after each frame)
                lo = pos + wbits - 1
                tol = self.sync_tolerance if wbits <= 16 else 0
                if tol:
                    d = np.bitwise_count(
                        (words[lo:] & mask) ^ np.uint64(int(ft)))
                    cand = np.nonzero(d <= tol)[0]
                else:
                    cand = np.nonzero(
                        (words[lo:] & mask) == np.uint64(int(ft)))[0]
                if len(cand):
                    c = lo + cand[0]
                    if hit is None or c < hit:
                        hit = c
                        hit_type = ft
            if hit is None:
                break
            if hit_type == FrameType.M17_EOT:
                # EOT marker carries no payload (gr_modem.cpp:1203-1206)
                frames.append((hit_type, b""))
                self.frames_synced += 1
                pos = hit + 1
                continue
            # collect bit_buf_len bits after the sync word
            bb = self.cfg.bit_buf_len
            is_voice = hit_type in (FrameType.VOICE_1, FrameType.VOICE_2)
            if not self.cfg.narrowband and self.mode != "M17":
                if is_voice:
                    pass  # reserved byte already inside bit_buf span
                else:
                    bb = self.cfg.bit_buf_len - 8
            start = hit + 1
            if start + bb > n:
                # not enough bits yet: keep from just before the sync word
                keep_from = max(pos, hit - 31)
                self._pending = buf[keep_from:]
                return frames
            payload_bits = buf[start: start + bb]
            by = np.packbits(payload_bits)
            if is_voice and not self.cfg.narrowband:
                by = by[1:]  # drop reserved byte
            frames.append((hit_type, by.tobytes()[: self.cfg.frame_length]))
            self.frames_synced += 1
            pos = start + bb
        # no more syncs: keep the last 31 bits (but nothing consumed by a
        # frame) so a sync spanning the block boundary is still found
        self._pending = buf[max(pos, n - 31):]
        return frames
