"""M17 digital voice protocol stack (frame layer; a copy of
qradiolink_tpu/protocols/m17.py, pure numpy, host side).

Re-derivation of the vendored M17 stack used by the reference
(reference src/M17/M17/: M17Callsign.cpp, M17ConvolutionalEncoder.hpp,
M17CodePuncturing.hpp, M17Interleaver.hpp, M17Decorrelator.hpp,
M17LinkSetupFrame.cpp, M17FrameEncoder.cpp, M17FrameDecoder.cpp:210,
M17Golay.cpp) as vectorized bit-tensor transforms plus a small host-side
frame state machine. All protocol constants (sync words, puncture
matrices, decorrelator sequence, Golay encode matrix, base-40 alphabet)
are air-interface constants from the M17 specification.

Layout of one over-the-air frame: 16-bit sync word + 368 payload bits
(46 bytes) = 384 bits = 192 4FSK symbols at 4800 sym/s (48 kbit/s gross
over a 9600 bit/s channel -> 40 ms per frame, 25 frames/s).

  LSF frame:    30-byte link setup (dst, src, type, meta, CRC16) ->
                K=5 R=1/2 conv encode + flush (488 bits) -> P1 puncture
                (368 bits) -> interleave -> decorrelate
  stream frame: 12-byte Golay(24,12) LICH chunk (1/6th of the LSF) +
                [16-bit frame number | 16-byte payload] conv encoded,
                P2-punctured to 272 bits -> interleave -> decorrelate

The heavy transforms (conv encode, puncture, interleave, decorrelate,
Golay) operate on (..., nbits) uint8 arrays and are pure numpy: only
reshapes, XORs and constant permutation indexing. The Viterbi decode is
a vectorized 16-state chainback over numpy (frames are 244 steps at 25
fps — host-cheap), with a batched axis for decoding many frames at once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from qradiolink_tpu_torch.fec.crc import crc16_m17

# ---------------------------------------------------------------------------
# protocol constants (M17 spec / reference src/M17/M17/M17Constants.hpp)

SYNC_LSF = 0x55F7
SYNC_STREAM = 0xFF5D
SYNC_PACKET = 0x75FF
SYNC_BERT = 0xDF55
PREAMBLE_BYTE = 0x77
EOT_WORD = 0x555D555D  # reference src/layer1framing.h:23
MAX_SYNC_HAMMING = 4   # reference src/M17/M17/M17FrameDecoder.hpp

FRAME_BITS = 368       # payload bits per frame (46 bytes)
SYMBOL_RATE = 4800

# puncture matrices (reference src/M17/M17/M17CodePuncturing.hpp)
LSF_PUNCTURE = np.array(
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1,
     0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1,
     1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1], np.uint8)

DATA_PUNCTURE = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], np.uint8)

# PRBS decorrelator sequence (reference src/M17/M17/M17Decorrelator.hpp)
DECORRELATOR = np.array(
    [0xd6, 0xb5, 0xe2, 0x30, 0x82, 0xFF, 0x84, 0x62,
     0xba, 0x4e, 0x96, 0x90, 0xd8, 0x98, 0xdd, 0x5d,
     0x0c, 0xc8, 0x52, 0x43, 0x91, 0x1d, 0xf8, 0x6e,
     0x68, 0x2F, 0x35, 0xda, 0x14, 0xea, 0xcd, 0x76,
     0x19, 0x8d, 0xd5, 0x80, 0xd1, 0x33, 0x87, 0x13,
     0x57, 0x18, 0x2d, 0x29, 0x78, 0xc3], np.uint8)
_DECORR_BITS = np.unpackbits(DECORRELATOR)

# Golay(24,12) encode matrix: parity contribution of each data bit
# (reference src/M17/M17/M17Golay.cpp encode_matrix; generator 0xC75)
_GOLAY_ENC = np.array(
    [0x8eb, 0x93e, 0xa97, 0xdc6, 0x367, 0x6cd,
     0xd99, 0x3da, 0x7b4, 0xf68, 0x63b, 0xc75], np.uint32)
_GOLAY_DEC = np.array(
    [0xc75, 0x49f, 0x93e, 0x6e3, 0xdc6, 0xf13,
     0xab9, 0x1ed, 0x3da, 0x7b4, 0xf68, 0xa4f], np.uint32)

# convolutional code K=5, G1=0x19, G2=0x17
# (reference src/M17/M17/M17ConvolutionalEncoder.hpp; bit convention:
# window w = b[t] | b[t-1]<<1 | ... — same as fec.conv.ConvCode)
CONV_K = 5
CONV_POLYS = (0x19, 0x17)

_B40_ALPHABET = "xABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."

# quadratic permutation polynomial interleaver pi(i) = (45 i + 92 i^2)
# mod 368 (reference src/M17/M17/M17Interleaver.hpp)
_I = np.arange(FRAME_BITS, dtype=np.int64)
INTERLEAVE_IDX = ((45 * _I + 92 * _I * _I) % FRAME_BITS).astype(np.int64)
# writing out[pi(i)] = in[i] means reading out[j] = in[pi^-1(j)]
_INV = np.empty(FRAME_BITS, np.int64)
_INV[INTERLEAVE_IDX] = _I
DEINTERLEAVE_IDX = INTERLEAVE_IDX  # deinterleave: out[i] = in[pi(i)]


# ---------------------------------------------------------------------------
# callsign base-40 codec (reference src/M17/M17/M17Callsign.cpp)

def encode_callsign(callsign: str, strict: bool = False) -> bytes:
    """Callsign string -> 6-byte big-endian base-40 address."""
    if len(callsign) > 9:
        raise ValueError("callsign longer than 9 characters")
    encoded = 0
    for ch in reversed(callsign):
        encoded *= 40
        if "A" <= ch <= "Z":
            encoded += ord(ch) - ord("A") + 1
        elif "0" <= ch <= "9":
            encoded += ord(ch) - ord("0") + 27
        elif ch == "-":
            encoded += 37
        elif ch == "/":
            encoded += 38
        elif ch == ".":
            encoded += 39
        elif strict:
            raise ValueError(f"invalid callsign character {ch!r}")
    return encoded.to_bytes(6, "big")


_SPECIAL_DST = {
    b"\xFF\xFF\xFF\xFF\xFF\xFF": "ALL",
    b"\x00\x00\x00\x0E\xD8\x7D": "ECHO",
    b"\x00\x00\x00\x0E\xCD\xB9": "INFO",
    b"\x00\x00\x45\x4F\x77\x45": "UNLINK",
}
SPECIAL_DST_BYTES = {v: k for k, v in _SPECIAL_DST.items()}


def decode_callsign(address: bytes) -> str:
    """6-byte address -> callsign string (special addresses by name)."""
    address = bytes(address)
    if address in _SPECIAL_DST:
        return "BROADCAST" if address == b"\xFF" * 6 else _SPECIAL_DST[address]
    encoded = int.from_bytes(address, "big")
    out = []
    while encoded:
        out.append(_B40_ALPHABET[encoded % 40])
        encoded //= 40
    return "".join(out)


# ---------------------------------------------------------------------------
# bit-tensor transforms (vectorized over leading axes)

def conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """K=5 R=1/2 encode with 4 zero flush bits: (..., T) -> (..., 2T+8).

    Output order per input bit: G1 then G2 (the reference packs
    convolveByte MSB-first, giving exactly this stream order).
    """
    bits = np.asarray(bits, np.uint8)
    T = bits.shape[-1]
    flush = np.zeros(bits.shape[:-1] + (CONV_K - 1,), np.uint8)
    bx = np.concatenate(
        [np.zeros(bits.shape[:-1] + (CONV_K - 1,), np.uint8), bits, flush],
        axis=-1)
    n = T + CONV_K - 1
    outs = []
    for p in CONV_POLYS:
        acc = np.zeros(bits.shape[:-1] + (n,), np.uint8)
        for j in range(CONV_K):
            if (p >> j) & 1:
                acc ^= bx[..., CONV_K - 1 - j: CONV_K - 1 - j + n]
        outs.append(acc)
    return np.stack(outs, axis=-1).reshape(bits.shape[:-1] + (2 * n,))


def puncture_bits(bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Drop bits where the cyclic pattern is 0: (..., T) -> (..., kept)."""
    bits = np.asarray(bits)
    T = bits.shape[-1]
    reps = -(-T // len(pattern))
    mask = np.tile(np.asarray(pattern, bool), reps)[:T]
    return bits[..., mask]


def depuncture_bits(bits: np.ndarray, pattern: np.ndarray, out_len: int,
                    fill=0) -> np.ndarray:
    """Re-insert `fill` at punctured positions: (..., kept) -> (..., out_len)."""
    bits = np.asarray(bits)
    reps = -(-out_len // len(pattern))
    mask = np.tile(np.asarray(pattern, bool), reps)[:out_len]
    out = np.full(bits.shape[:-1] + (out_len,), fill, bits.dtype)
    out[..., mask] = bits[..., : int(mask.sum())]
    return out


def interleave_bits(bits: np.ndarray) -> np.ndarray:
    """QPP interleave 368 bits: out[pi(i)] = in[i]."""
    bits = np.asarray(bits)
    out = np.empty_like(bits)
    out[..., INTERLEAVE_IDX] = bits
    return out


def deinterleave_bits(bits: np.ndarray) -> np.ndarray:
    """QPP deinterleave: out[i] = in[pi(i)]."""
    return np.asarray(bits)[..., DEINTERLEAVE_IDX]


def decorrelate_bits(bits: np.ndarray) -> np.ndarray:
    """XOR with the 368-bit PRBS sequence (involution)."""
    return np.asarray(bits) ^ _DECORR_BITS[: bits.shape[-1]]


# ---------------------------------------------------------------------------
# Golay(24,12), M17 codeword layout: (data12 << 12) | parity12

def golay24_encode(data: np.ndarray) -> np.ndarray:
    """12-bit values (...,) -> 24-bit codewords (...,) uint32."""
    data = np.asarray(data, np.uint32)
    idx = np.arange(12, dtype=np.uint32)
    sel = ((data[..., None] >> idx) & 1).astype(bool)
    parity = np.bitwise_xor.reduce(
        np.where(sel, _GOLAY_ENC, np.uint32(0)), axis=-1)
    return (data << np.uint32(12)) | parity


def golay24_decode(codeword: np.ndarray):
    """24-bit codewords -> (data12, ok) with up to 3-bit error correction.

    Mirrors the reference's detectErrors search order
    (reference src/M17/M17/M17Golay.cpp:70-118). Vectorized over the
    leading axes.
    """
    cw = np.asarray(codeword, np.uint32)
    data = (cw >> np.uint32(12)) & np.uint32(0xFFF)
    parity = cw & np.uint32(0xFFF)
    syndrome = parity ^ (golay24_encode(data) & np.uint32(0xFFF))

    def popcount(x):
        x = np.asarray(x, np.uint32)
        c = np.zeros(x.shape, np.uint32)
        while np.any(x):
            c += x & 1
            x = x >> np.uint32(1)
        return c

    err = np.full(cw.shape, 0xFFFFFFFF, np.uint64)
    found = np.zeros(cw.shape, bool)

    # 1) parity-only errors: popcount(syndrome) <= 3
    ok1 = popcount(syndrome) <= 3
    err = np.where(ok1 & ~found, syndrome.astype(np.uint64), err)
    found |= ok1

    # 2) one data-bit + <=2 parity errors
    for i in range(12):
        cand = syndrome ^ _GOLAY_ENC[i]
        ok = (popcount(cand) <= 2) & ~found
        e = ((np.uint64(1 << i) << np.uint64(12)) | cand.astype(np.uint64))
        err = np.where(ok, e, err)
        found |= ok

    # 3) inverse-syndrome (data-side) errors
    idx = np.arange(12, dtype=np.uint32)
    sel = ((syndrome[..., None] >> idx) & 1).astype(bool)
    inv = np.bitwise_xor.reduce(
        np.where(sel, _GOLAY_DEC, np.uint32(0)), axis=-1)
    ok3 = (popcount(inv) <= 3) & ~found
    err = np.where(ok3, inv.astype(np.uint64) << np.uint64(12), err)
    found |= ok3

    for i in range(12):
        cand = inv ^ _GOLAY_DEC[i]
        ok = (popcount(cand) <= 2) & ~found
        e = ((cand.astype(np.uint64) << np.uint64(12)) | np.uint64(1 << i))
        err = np.where(ok, e, err)
        found |= ok

    corrected = np.where(found, cw ^ err.astype(np.uint32), cw)
    return (corrected >> np.uint32(12)) & np.uint32(0xFFF), found


# ---------------------------------------------------------------------------
# K=5 hard-decision Viterbi (batched numpy; 16 states)

_NS = 1 << (CONV_K - 1)


def _build_trellis():
    s = np.arange(_NS, dtype=np.uint32)
    pred = np.stack([s >> 1, (s >> 1) | (1 << (CONV_K - 2))])  # (2, ns)
    # expected outputs along each predecessor edge into state s:
    # window w = (pred << 1) | (s & 1)
    outs = []
    for hi in (0, 1):
        w = (pred[hi] << 1) | (s & 1)
        o = []
        for p in CONV_POLYS:
            v = w & np.uint32(p)
            pc = np.zeros_like(v)
            while np.any(v):
                pc += v & 1
                v >>= 1
            o.append(pc & 1)
        outs.append(np.stack(o, axis=-1))  # (ns, 2)
    return pred.astype(np.int64), np.stack(outs).astype(np.int64)  # (2,ns,2)


_PRED, _EDGE_OUT = _build_trellis()


def viterbi_decode_bits(coded: np.ndarray, erasures: np.ndarray | None = None
                        ) -> np.ndarray:
    """Hard Viterbi: coded (..., 2T) {0,1} -> decoded (..., T) {0,1}.

    Starts and traces back from state 0 (the encoder is reset + flushed
    per frame). erasures: optional bool mask (..., 2T) of depunctured
    positions to exclude from the metric.
    """
    coded = np.asarray(coded, np.int64)
    lead = coded.shape[:-1]
    T = coded.shape[-1] // 2
    pairs = coded.reshape(lead + (T, 2))
    if erasures is None:
        w = np.ones(lead + (T, 2), np.int64)
    else:
        w = (~np.asarray(erasures, bool)).astype(np.int64).reshape(
            lead + (T, 2))
    big = 1 << 20
    pm = np.full(lead + (_NS,), big, np.int64)
    pm[..., 0] = 0
    decs = np.empty(lead + (T, _NS), np.int8)
    for t in range(T):
        r = pairs[..., t, :]       # (..., 2)
        wt = w[..., t, :]
        # branch metric per edge: weighted hamming distance
        bm = np.sum((_EDGE_OUT ^ r[..., None, None, :]) * wt[..., None, None, :],
                    axis=-1)       # (..., 2, ns)
        cand = pm[..., _PRED] + bm
        dec = np.argmin(cand, axis=-2)       # (..., ns)
        pm = np.min(cand, axis=-2)
        pm -= pm.min(axis=-1, keepdims=True)
        decs[..., t, :] = dec.astype(np.int8)
    # traceback from best end state (flush drives encoder to state 0, but
    # puncturing of flush bits can leave ties; best metric is correct)
    s = np.argmin(pm, axis=-1)
    bits = np.empty(lead + (T,), np.uint8)
    hi_shift = CONV_K - 2
    it = np.ndindex(*lead) if lead else [()]
    for idx in it:
        st = int(s[idx]) if lead else int(s)
        for t in range(T - 1, -1, -1):
            bits[idx + (t,)] = st & 1
            d = int(decs[idx + (t, st)])
            st = (st >> 1) | (d << hi_shift)
    return bits


# ---------------------------------------------------------------------------
# link setup frame

@dataclass
class LinkSetupFrame:
    """30-byte M17 LSF: dst(6) src(6) type(2) meta(14) crc(2).

    Mirrors reference src/M17/M17/M17LinkSetupFrame.cpp (big-endian
    fields, CRC16 poly 0x5935 init 0xFFFF over the first 28 bytes).
    """
    dst: bytes = b"\xFF" * 6
    src: bytes = b"\x00" * 6
    type_: int = 0
    meta: bytes = b"\x00" * 14

    @classmethod
    def for_stream(cls, src_call: str, dst_call: str = "",
                   can: int = 0, dst_type: int | None = None):
        """Voice-stream LSF: type = stream | 3200 voice | CAN."""
        if dst_call:
            dst = encode_callsign(dst_call)
        else:
            name = {1: "ALL", 2: "ECHO", 3: "INFO",
                    4: "UNLINK"}.get(dst_type, "ALL")
            dst = SPECIAL_DST_BYTES[name]
        # type bits: [0]=stream, [1:2]=data/voice (2=voice), [3:4]=enc,
        # [5:6]=enc subtype, [7:10]=CAN
        type_ = 1 | (2 << 1) | ((can & 0xF) << 7)
        return cls(dst=dst, src=encode_callsign(src_call), type_=type_)

    def to_bytes(self) -> bytes:
        body = (bytes(self.dst) + bytes(self.src)
                + int(self.type_).to_bytes(2, "big") + bytes(self.meta))
        crc = crc16_m17(np.frombuffer(body, np.uint8))
        return body + int(crc).to_bytes(2, "big")

    @classmethod
    def from_bytes(cls, data: bytes):
        data = bytes(data)
        if len(data) != 30:
            raise ValueError("LSF must be 30 bytes")
        return cls(dst=data[0:6], src=data[6:12],
                   type_=int.from_bytes(data[12:14], "big"),
                   meta=data[14:28])

    def valid(self, data: bytes | None = None) -> bool:
        data = bytes(data) if data is not None else self.to_bytes()
        crc = crc16_m17(np.frombuffer(data[:28], np.uint8))
        return int.from_bytes(data[28:30], "big") == crc

    @property
    def source(self) -> str:
        return decode_callsign(self.src)

    @property
    def destination(self) -> str:
        return decode_callsign(self.dst)

    @property
    def can(self) -> int:
        return (self.type_ >> 7) & 0xF

    def lich_segment(self, num: int) -> np.ndarray:
        """Golay-encoded 12-byte LICH chunk `num` (0..5) as uint8 array.

        Chunk = 5 LSF bytes + (num << 5) packed into four 12-bit blocks
        (reference src/M17/M17/M17LinkSetupFrame.cpp:generateLichSegment).
        """
        num = num % 6
        d = self.to_bytes()[num * 5: num * 5 + 5]
        blocks = np.array([
            (d[0] << 4) | (d[1] >> 4),
            ((d[1] & 0x0F) << 8) | d[2],
            (d[3] << 4) | (d[4] >> 4),
            ((d[4] & 0x0F) << 8) | (num << 5),
        ], np.uint32)
        enc = golay24_encode(blocks)  # (4,) 24-bit words
        out = np.empty(12, np.uint8)
        for i in range(4):
            out[3 * i] = (enc[i] >> 16) & 0xFF
            out[3 * i + 1] = (enc[i] >> 8) & 0xFF
            out[3 * i + 2] = enc[i] & 0xFF
        return out


def decode_lich(lich: np.ndarray):
    """12 LICH bytes -> (segment 5 bytes, segment number, ok)."""
    lich = np.asarray(lich, np.uint8)
    blocks = (lich[0::3].astype(np.uint32) << 16) | \
             (lich[1::3].astype(np.uint32) << 8) | lich[2::3].astype(np.uint32)
    data, ok = golay24_decode(blocks)
    if not np.all(ok):
        return None, 0, False
    d = data.astype(np.uint32)
    seg = np.array([
        (d[0] >> 4) & 0xFF,
        ((d[0] & 0xF) << 4) | ((d[1] >> 8) & 0xF),
        d[1] & 0xFF,
        (d[2] >> 4) & 0xFF,
        ((d[2] & 0xF) << 4) | ((d[3] >> 8) & 0xF),
    ], np.uint8)
    num = int((d[3] >> 5) & 0x7)
    return seg, num, True


# ---------------------------------------------------------------------------
# frame encoder / decoder

def _bytes_to_bits(b: bytes | np.ndarray) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(b), np.uint8)
                         if isinstance(b, (bytes, bytearray))
                         else np.asarray(b, np.uint8))


def _sync_bits(word: int) -> np.ndarray:
    return np.unpackbits(np.array([(word >> 8) & 0xFF, word & 0xFF], np.uint8))


class FrameEncoder:
    """Builds over-the-air M17 frames (384 bits each incl. sync).

    Mirrors reference src/M17/M17/M17FrameEncoder.cpp plus
    M17Transmitter.cpp: one LSF frame, then stream frames cycling the
    6 LICH segments, frame counter with EOS bit on the last frame.
    """

    def __init__(self, lsf: LinkSetupFrame):
        self.lsf = lsf
        self.lich = [lsf.lich_segment(i) for i in range(6)]
        self.current_lich = 0
        self.frame_number = 0

    def encode_lsf(self) -> np.ndarray:
        """-> 384 frame bits (sync + 368 payload)."""
        bits = _bytes_to_bits(self.lsf.to_bytes())          # 240
        coded = conv_encode_bits(bits)                       # 488
        pb = puncture_bits(coded, LSF_PUNCTURE)              # 368
        pb = interleave_bits(pb)
        pb = decorrelate_bits(pb)
        return np.concatenate([_sync_bits(SYNC_LSF), pb])

    def encode_stream(self, payload: bytes, last: bool = False) -> np.ndarray:
        """16-byte payload -> 384 frame bits."""
        fn = self.frame_number & 0x7FFF
        if last:
            fn |= 0x8000
        self.frame_number = (self.frame_number + 1) & 0x07FF
        data = int(fn).to_bytes(2, "big") + bytes(payload[:16]).ljust(16, b"\0")
        bits = _bytes_to_bits(data)                          # 144
        coded = conv_encode_bits(bits)                       # 296
        pb = puncture_bits(coded, DATA_PUNCTURE)             # 272
        lich_bits = _bytes_to_bits(self.lich[self.current_lich])  # 96
        self.current_lich = (self.current_lich + 1) % 6
        frame = np.concatenate([lich_bits, pb])              # 368
        frame = interleave_bits(frame)
        frame = decorrelate_bits(frame)
        return np.concatenate([_sync_bits(SYNC_STREAM), frame])

    def encode_preamble(self, n_bytes: int = 48) -> np.ndarray:
        return np.tile(_bytes_to_bits(bytes([PREAMBLE_BYTE])), n_bytes)

    def encode_eot(self) -> np.ndarray:
        """EOT marker bits (reference gr_modem.cpp:726 appends 0x555D...)."""
        w = np.array([(EOT_WORD >> s) & 0xFF for s in (24, 16, 8, 0)],
                     np.uint8)
        return np.unpackbits(np.tile(w, 12))


@dataclass
class StreamFrame:
    frame_number: int
    last: bool
    payload: bytes


class FrameDecoder:
    """Host-side frame state machine (reference M17FrameDecoder.cpp:210).

    decode_payload(bits368) classifies nothing — framing/sync hunting is
    the Deframer's job (layer1); this class decodes the 368 payload bits
    of an already-synced frame given its type, reassembles the LSF from
    LICH segments on stream frames, and tracks lock.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.lsf: LinkSetupFrame | None = None
        self.lsf_valid = False
        self._lich_bytes = np.zeros(30, np.uint8)
        self._lich_map = 0

    def decode_lsf(self, payload_bits: np.ndarray) -> LinkSetupFrame | None:
        bits = decorrelate_bits(np.asarray(payload_bits, np.uint8))
        bits = deinterleave_bits(bits)
        coded = depuncture_bits(bits, LSF_PUNCTURE, 488)
        eras = depuncture_bits(np.zeros(368, np.uint8), LSF_PUNCTURE, 488,
                               fill=1).astype(bool)
        dec = viterbi_decode_bits(coded, erasures=eras)[:240]
        data = np.packbits(dec).tobytes()
        lsf = LinkSetupFrame.from_bytes(data)
        if lsf.valid(data):
            self.lsf = lsf
            self.lsf_valid = True
            return lsf
        return None

    def decode_stream(self, payload_bits: np.ndarray) -> StreamFrame:
        bits = decorrelate_bits(np.asarray(payload_bits, np.uint8))
        bits = deinterleave_bits(bits)
        lich_bits, data_bits = bits[:96], bits[96:]
        # LICH -> LSF reassembly
        seg, num, ok = decode_lich(np.packbits(lich_bits))
        if ok:
            self._lich_bytes[num * 5: num * 5 + 5] = seg
            self._lich_map |= 1 << num
            if self._lich_map == 0x3F:
                data = self._lich_bytes.tobytes()
                lsf = LinkSetupFrame.from_bytes(data)
                if lsf.valid(data):
                    self.lsf = lsf
                    self.lsf_valid = True
                self._lich_map = 0
                self._lich_bytes[:] = 0
        coded = depuncture_bits(data_bits, DATA_PUNCTURE, 296)
        eras = depuncture_bits(np.zeros(272, np.uint8), DATA_PUNCTURE, 296,
                               fill=1).astype(bool)
        dec = viterbi_decode_bits(coded, erasures=eras)[:144]
        by = np.packbits(dec).tobytes()
        fn = int.from_bytes(by[0:2], "big")
        return StreamFrame(frame_number=fn & 0x7FFF,
                           last=bool(fn & 0x8000), payload=by[2:18])
