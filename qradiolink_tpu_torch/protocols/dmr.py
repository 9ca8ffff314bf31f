"""DMR Tier II protocol stack (frame layer, ETSI TS 102 361-1; a copy of
qradiolink_tpu/protocols/dmr.py with one change, below).

Re-derivation of the reference's DMR frame machinery (reference
src/DMR/dmrframe.{h,cpp}, src/MMDVM/{DMRSlotType,DMREMB,DMREmbeddedData,
DMRShortLC,DMRFullLC,DMRLC,Sync}.cpp) as vectorized bit-tensor
transforms plus small host-side frame classes. All tables (sync
patterns, bit placements, CRC masks) are air-interface constants of the
ETSI standard.

One DMR burst is 264 bits (27.5 ms at 4800 symbols/s):

  [ 98 info | 10 slot-type | 48 sync-or-EMB+embedded | 10 slot-type | 98 info ]

- data bursts: info = BPTC(196,96) or trellis-3/4 protected payload,
  slot type = Golay(20,8)(color code, data type), center = 48-bit sync
- voice bursts: 216 voice bits (info + center replaced), frame A of each
  superframe carries the voice sync, frames B..F carry an 8+8-bit EMB
  (QR(16,7)) bracketing 32 bits of embedded signalling (the 128-bit
  embedded LC spread over 4 bursts)

Between bursts sits the 24-bit CACH (TDMA access channel): a 7-bit TACT
(Hamming-protected AT/TC/LCSS) interleaved with 17 payload bits that
carry the 68-bit Short LC over 4 bursts.

The FEC primitives live in qradiolink_tpu_torch.fec (bptc, rs129,
trellis34, block_codes); everything here is layout + state machines.
Protocol-rate work is 50 bursts/s/slot — host numpy is the right tool
(mirroring the reference's split: GR blocks on samples, C++ classes on
frames, src/gr_modem.cpp:1019); the sample-rate DSP runs on the card in
qradiolink_tpu_torch.chains.dmr.

The change from the JAX package's copy: the block codes (Golay, QR,
Hamming, BPTC) are torch. Every function that calls them takes a `device`
for them (None: CUDA, see core.resolve_device; pass device="cpu" on a
host without a card), hands them tensors on it and brings their results
back to numpy explicitly, so inputs and outputs stay numpy as in the JAX
package. rs129 and trellis34 are numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from qradiolink_tpu_torch.fec import bptc, rs129, trellis34
from qradiolink_tpu_torch.fec.block_codes import (
    GOLAY_20_8, QR_16_7, HAMMING_16_11, HAMMING_17_12, as_bits,
)
from qradiolink_tpu_torch.fec.crc import crc16_ccitt

# ---------------------------------------------------------------------------
# geometry (reference src/DMR/constants.h)

FRAME_BITS = 264          # one burst
FRAME_SYMBOLS = 132
CACH_BITS = 24
SYMBOL_RATE = 4800
SAMPLES_PER_SYMBOL = 5    # at 24 ksps
FRAME_SAMPLES = FRAME_SYMBOLS * SAMPLES_PER_SYMBOL

# data types (reference src/MMDVM/DMRDefines.h:82-97)
DT_VOICE_PI_HEADER = 0x00
DT_VOICE_LC_HEADER = 0x01
DT_TERMINATOR_WITH_LC = 0x02
DT_CSBK = 0x03
DT_MBC_HEADER = 0x04
DT_MBC_CONTINUATION = 0x05
DT_DATA_HEADER = 0x06
DT_RATE_12_DATA = 0x07
DT_RATE_34_DATA = 0x08
DT_IDLE = 0x09
DT_RATE_1_DATA = 0x0A
DT_VOICE_SYNC = 0xF0
DT_VOICE = 0xF1

# RS(12,9) parity XOR masks per data type (DMRDefines.h:71-72)
VOICE_LC_HEADER_CRC_MASK = 0x96
TERMINATOR_WITH_LC_CRC_MASK = 0x99
CSBK_CRC_MASK = 0xA5          # 16-bit CCITT mask, per byte

# FLCOs (DMRLC.h)
FLCO_GROUP = 0
FLCO_USER_USER = 3


def _hex_sync_bits(words) -> np.ndarray:
    """7 masked bytes (DMRDefines.h:42-52, 4-bit aligned) -> 48 sync bits."""
    bits = np.unpackbits(np.asarray(words, np.uint8))
    return bits[4:52].copy()


# 48-bit sync patterns (reference src/MMDVM/DMRDefines.h:42-52)
SYNC_BS_AUDIO = _hex_sync_bits([0x07, 0x55, 0xFD, 0x7D, 0xF7, 0x5F, 0x70])
SYNC_BS_DATA = _hex_sync_bits([0x0D, 0xFF, 0x57, 0xD7, 0x5D, 0xF5, 0xD0])
SYNC_MS_AUDIO = _hex_sync_bits([0x07, 0xF7, 0xD5, 0xDD, 0x57, 0xDF, 0xD0])
SYNC_MS_DATA = _hex_sync_bits([0x0D, 0x5D, 0x7F, 0x77, 0xFD, 0x75, 0x70])
SYNC_DMO1_AUDIO = _hex_sync_bits([0x05, 0xD5, 0x77, 0xF7, 0x75, 0x7F, 0xF0])
SYNC_DMO1_DATA = _hex_sync_bits([0x0F, 0x7F, 0xDD, 0x5D, 0xDF, 0xD5, 0x50])
SYNC_DMO2_AUDIO = _hex_sync_bits([0x07, 0xDF, 0xFD, 0x5F, 0x55, 0xD5, 0xF0])
SYNC_DMO2_DATA = _hex_sync_bits([0x0D, 0x75, 0x57, 0xF5, 0xFF, 0x7F, 0x50])

SYNC_PATTERNS = {
    "bs_audio": SYNC_BS_AUDIO, "bs_data": SYNC_BS_DATA,
    "ms_audio": SYNC_MS_AUDIO, "ms_data": SYNC_MS_DATA,
    "dmo1_audio": SYNC_DMO1_AUDIO, "dmo1_data": SYNC_DMO1_DATA,
    "dmo2_audio": SYNC_DMO2_AUDIO, "dmo2_data": SYNC_DMO2_DATA,
}

# bit-position tables inside the 264-bit burst
_INFO_IDX = np.concatenate([np.arange(0, 98), np.arange(166, 264)])
_SLOT_TYPE_IDX = np.concatenate([np.arange(98, 108), np.arange(156, 166)])
_SYNC_IDX = np.arange(108, 156)
_EMB_IDX = np.concatenate([np.arange(108, 116), np.arange(148, 156)])
_EMBSIG_IDX = np.arange(116, 148)
_VOICE_IDX = np.concatenate([np.arange(0, 108), np.arange(156, 264)])

# dibit -> normalized symbol level (reference src/DMR/dmrframe.cpp:25-33:
# translation {2,3,1,0} into {-1,-1/3,+1/3,+1})
DIBIT_TO_LEVEL = np.array([1.0 / 3.0, 1.0, -1.0 / 3.0, -1.0], np.float32)


def bits_to_symbols(bits) -> np.ndarray:
    """(..., 2k) bits -> (..., k) normalized 4FSK levels (MSB first)."""
    bits = np.asarray(bits, np.int64)
    pairs = bits.reshape(*bits.shape[:-1], -1, 2)
    return DIBIT_TO_LEVEL[pairs[..., 0] * 2 + pairs[..., 1]]


def symbols_to_bits(levels) -> np.ndarray:
    """(..., k) levels -> (..., 2k) bits by nearest-level slicing."""
    levels = np.asarray(levels, np.float32)
    idx = np.argmin(
        np.abs(levels[..., None] - DIBIT_TO_LEVEL[None, :]), axis=-1)
    b0 = (idx >> 1) & 1
    b1 = idx & 1
    return np.stack([b0, b1], axis=-1).reshape(
        *levels.shape[:-1], levels.shape[-1] * 2).astype(np.uint8)


def _host(t) -> np.ndarray:
    """A block code's result (a tensor on any device) as numpy."""
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# field codecs

def slot_type_encode(color_code: int, data_type: int,
                     device=None) -> np.ndarray:
    """-> (20,) Golay(20,8)-protected slot type bits (DMRSlotType.cpp)."""
    code = ((color_code & 0x0F) << 4) | (data_type & 0x0F)
    u = np.array([(code >> (7 - i)) & 1 for i in range(8)], np.uint8)
    return _host(GOLAY_20_8.encode(as_bits(u, device)))


def slot_type_decode(bits, device=None):
    """(..., 20) bits -> (color_code, data_type, ok)."""
    data, ok = GOLAY_20_8.decode(as_bits(bits, device))
    data = _host(data)
    w = 1 << np.arange(7, -1, -1)
    code = (data * w).sum(-1)
    return (code >> 4) & 0x0F, code & 0x0F, _host(ok)


def emb_encode(color_code: int, pi: bool, lcss: int,
               device=None) -> np.ndarray:
    """-> (16,) QR(16,7)-protected EMB bits (DMREMB.cpp)."""
    code = ((color_code & 0x0F) << 4) | (0x08 if pi else 0) | ((lcss & 3) << 1)
    u = np.array([(code >> (7 - i)) & 1 for i in range(7)], np.uint8)
    return _host(QR_16_7.encode(as_bits(u, device)))


def emb_decode(bits, device=None):
    """(..., 16) bits -> (color_code, pi, lcss, ok)."""
    data, ok = QR_16_7.decode(as_bits(bits, device))
    data = _host(data)
    w = 1 << np.arange(7, 0, -1)
    code = (data * w).sum(-1)
    return (code >> 4) & 0x0F, (code & 0x08) != 0, (code >> 1) & 3, _host(ok)


# ---------------------------------------------------------------------------
# link control (9 LC bytes; reference src/MMDVM/DMRLC.cpp:114-137)

@dataclass
class LinkControl:
    flco: int = FLCO_GROUP
    fid: int = 0
    options: int = 0
    dst_id: int = 0
    src_id: int = 0
    pf: bool = False
    r: bool = False

    def to_bytes(self) -> np.ndarray:
        b = np.zeros(9, np.uint8)
        b[0] = (self.flco & 0x3F) | (0x80 if self.pf else 0) | (0x40 if self.r else 0)
        b[1] = self.fid
        b[2] = self.options
        b[3:6] = [(self.dst_id >> 16) & 0xFF, (self.dst_id >> 8) & 0xFF, self.dst_id & 0xFF]
        b[6:9] = [(self.src_id >> 16) & 0xFF, (self.src_id >> 8) & 0xFF, self.src_id & 0xFF]
        return b

    @classmethod
    def from_bytes(cls, b) -> "LinkControl":
        b = np.asarray(b, np.uint8)
        return cls(
            flco=int(b[0]) & 0x3F, pf=bool(b[0] & 0x80), r=bool(b[0] & 0x40),
            fid=int(b[1]), options=int(b[2]),
            dst_id=(int(b[3]) << 16) | (int(b[4]) << 8) | int(b[5]),
            src_id=(int(b[6]) << 16) | (int(b[7]) << 8) | int(b[8]))


_LC_MASKS = {DT_VOICE_LC_HEADER: VOICE_LC_HEADER_CRC_MASK,
             DT_TERMINATOR_WITH_LC: TERMINATOR_WITH_LC_CRC_MASK}


def full_lc_encode(lc_bytes, data_type: int, device=None) -> np.ndarray:
    """(..., 9) LC bytes -> (..., 196) BPTC info bits (DMRFullLC.cpp:70)."""
    lc_bytes = np.asarray(lc_bytes, np.uint8)
    parity = rs129.encode(lc_bytes) ^ _LC_MASKS[data_type]
    bits = np.unpackbits(
        np.concatenate([lc_bytes, parity], axis=-1), axis=-1)
    return _host(bptc.encode(as_bits(bits, device)))


def full_lc_decode(info_bits, data_type: int, device=None):
    """(..., 196) info bits -> ((..., 9) LC bytes, (...,) ok)."""
    data, ok_bptc = bptc.decode(as_bits(info_bits, device))
    lc12 = np.packbits(_host(data), axis=-1)
    lc12 = lc12.copy()
    lc12[..., 9:12] ^= _LC_MASKS[data_type]
    ok = _host(ok_bptc) & rs129.check(lc12)
    return lc12[..., :9], ok


# ---------------------------------------------------------------------------
# embedded LC: 9 LC bytes + 5-bit checksum -> 128-bit matrix over 4 bursts
# (reference src/MMDVM/DMREmbeddedData.cpp:121-166)

# row layout: 7 rows of Hamming(16,11,4) + 1 parity row; data occupies
# 11,11,10,10,10,10,10 leading columns of rows 0..6 (checksum bits sit at
# column 10 of rows 2..6)
_EMB_DATA_POS = np.concatenate([
    np.arange(0, 11), np.arange(16, 27), np.arange(32, 42),
    np.arange(48, 58), np.arange(64, 74), np.arange(80, 90),
    np.arange(96, 106)])
_EMB_CRC_POS = np.array([42, 58, 74, 90, 106])  # MSB..LSB of the 5-bit sum
# column-major packing: raw[a] = data[(a*16) mod 127] (with the 127-wrap)
_EMB_PACK = np.zeros(128, np.int64)
_b = 0
for _a in range(128):
    _EMB_PACK[_a] = _b
    _b += 16
    if _b > 127:
        _b -= 127

# LCSS tag per fragment 1..4 (DMREmbeddedData::getData)
EMBEDDED_LCSS = [1, 3, 3, 2]


def _five_bit_checksum(lc_bytes) -> int:
    """sum of the 9 LC bytes mod 31 (reference CRC.cpp:132-146)."""
    return int(np.asarray(lc_bytes, np.uint64).sum() % 31)


def embedded_lc_encode(lc_bytes, device=None) -> np.ndarray:
    """(9,) LC bytes -> (4, 32) embedded signalling fragments."""
    lc_bytes = np.asarray(lc_bytes, np.uint8)
    data = np.zeros(128, np.uint8)
    data[_EMB_DATA_POS] = np.unpackbits(lc_bytes)[:77]
    crc = _five_bit_checksum(lc_bytes)
    data[_EMB_CRC_POS] = [(crc >> s) & 1 for s in (4, 3, 2, 1, 0)]
    rows = data[:112].reshape(7, 16)
    rows = _host(HAMMING_16_11.encode(as_bits(rows[:, :11], device)))
    data[:112] = rows.reshape(-1)
    data[112:] = np.bitwise_xor.reduce(rows, axis=0)
    raw = data[_EMB_PACK]
    return raw.reshape(4, 32)


def embedded_lc_decode(fragments, device=None):
    """(4, 32) fragments -> ((9,) LC bytes, ok)."""
    raw = np.asarray(fragments, np.uint8).reshape(128)
    data = np.zeros(128, np.uint8)
    data[_EMB_PACK] = raw
    rows, ok_rows = HAMMING_16_11.decode_codeword(
        as_bits(data[:112].reshape(7, 16), device))
    rows, ok_rows = _host(rows), _host(ok_rows)
    parity_ok = np.array_equal(
        np.bitwise_xor.reduce(rows, axis=0), data[112:])
    data[:112] = rows.reshape(-1)
    lc_bits = data[_EMB_DATA_POS]
    lc_bytes = np.packbits(np.concatenate([lc_bits, np.zeros(3, np.uint8)]))[:9]
    crc = int(sum(int(data[p]) << s for p, s in zip(_EMB_CRC_POS, (4, 3, 2, 1, 0))))
    ok = bool(np.all(ok_rows)) and parity_ok and \
        crc == _five_bit_checksum(lc_bytes)
    return lc_bytes, ok


# ---------------------------------------------------------------------------
# Short LC (over the CACH payload; reference src/MMDVM/DMRShortLC.cpp)

_SLC_DATA_POS = np.concatenate(
    [np.arange(0, 12), np.arange(17, 29), np.arange(34, 46)])
_SLC_INTERLEAVE = np.zeros(68, np.int64)
for _a in range(67):
    _SLC_INTERLEAVE[_a] = (_a * 4) % 67
_SLC_INTERLEAVE[67] = 67


def short_lc_encode(payload_bits, device=None) -> np.ndarray:
    """(36,) Short LC payload bits -> (68,) protected+interleaved bits."""
    deinter = np.zeros(68, np.uint8)
    deinter[_SLC_DATA_POS] = np.asarray(payload_bits, np.uint8)
    rows = deinter[:51].reshape(3, 17)
    rows = _host(HAMMING_17_12.encode(as_bits(rows[:, :12], device)))
    deinter[:51] = rows.reshape(-1)
    deinter[51:] = np.bitwise_xor.reduce(rows, axis=0)
    raw = np.zeros(68, np.uint8)
    raw[_SLC_INTERLEAVE] = deinter
    return raw


def short_lc_decode(raw_bits, device=None):
    """(68,) bits -> ((36,) payload bits, ok)."""
    raw = np.asarray(raw_bits, np.uint8)
    deinter = raw[_SLC_INTERLEAVE]
    rows, ok_rows = HAMMING_17_12.decode_codeword(
        as_bits(deinter[:51].reshape(3, 17), device))
    rows, ok_rows = _host(rows), _host(ok_rows)
    parity_ok = np.array_equal(np.bitwise_xor.reduce(rows, axis=0), deinter[51:])
    deinter = deinter.copy()
    deinter[:51] = rows.reshape(-1)
    return deinter[_SLC_DATA_POS], bool(np.all(ok_rows)) and parity_ok


# ---------------------------------------------------------------------------
# CACH (24 bits: 7-bit TACT + 17 Short-LC payload bits;
# reference src/DMR/dmrframe.cpp:255-287 setDownlink)

_TACT_POS = np.array([0, 4, 8, 12, 14, 18, 22])  # at, tc, ls1, ls0, h0, h1, h2
_CACH_PAYLOAD_POS = np.setdiff1d(np.arange(24), _TACT_POS)


def cach_encode(at: int, tc: int, lcss: int, payload17=None) -> np.ndarray:
    """-> (24,) CACH bits. tc: 0 = slot 1, 1 = slot 2."""
    ls1, ls0 = (lcss >> 1) & 1, lcss & 1
    h0 = at ^ tc ^ ls1
    h1 = tc ^ ls1 ^ ls0
    h2 = at ^ tc ^ ls0
    cach = np.zeros(24, np.uint8)
    cach[_TACT_POS] = [at, tc, ls1, ls0, h0, h1, h2]
    if payload17 is not None:
        cach[_CACH_PAYLOAD_POS] = np.asarray(payload17, np.uint8)
    return cach


def cach_decode(bits):
    """(24,) bits -> (at, slot_no (1|2), lcss, payload17, ok)."""
    b = np.asarray(bits, np.uint8)
    at, tc, ls1, ls0, h0, h1, h2 = (int(b[p]) for p in _TACT_POS)
    ok = (h0 == at ^ tc ^ ls1) and (h1 == tc ^ ls1 ^ ls0) and (h2 == at ^ tc ^ ls0)
    return at, tc + 1, (ls1 << 1) | ls0, b[_CACH_PAYLOAD_POS], ok


# ---------------------------------------------------------------------------
# burst composition

def make_data_burst(info_bits, color_code: int, data_type: int,
                    sync: np.ndarray = SYNC_BS_DATA,
                    device=None) -> np.ndarray:
    """(196,) info bits -> (264,) data burst with slot type + sync."""
    frame = np.zeros(FRAME_BITS, np.uint8)
    frame[_INFO_IDX] = np.asarray(info_bits, np.uint8)
    frame[_SLOT_TYPE_IDX] = slot_type_encode(color_code, data_type, device)
    frame[_SYNC_IDX] = sync
    return frame


def make_voice_burst(voice_bits, color_code: int, fn: int,
                     embedded: np.ndarray | None = None,
                     sync: np.ndarray = SYNC_BS_AUDIO,
                     device=None) -> np.ndarray:
    """(216,) voice bits + frame number -> (264,) voice burst.

    fn 0 (frame A) carries the audio sync; fn 1..5 carry EMB + embedded
    signalling fragment (fragments 1..4 in frames B..E, null in F).
    """
    frame = np.zeros(FRAME_BITS, np.uint8)
    frame[_VOICE_IDX] = np.asarray(voice_bits, np.uint8)
    if fn == 0:
        frame[_SYNC_IDX] = sync
    else:
        if embedded is not None:
            lcss = EMBEDDED_LCSS[fn - 1] if fn <= 4 else 0
            frame[_EMBSIG_IDX] = embedded
        else:
            lcss = 0
        frame[_EMB_IDX] = emb_encode(color_code, False, lcss, device)
    return frame


def make_voice_superframe(voice_frames, lc: LinkControl,
                          color_code: int, device=None) -> np.ndarray:
    """(6, 216) voice bits -> (6, 264) bursts A..F with embedded LC."""
    voice_frames = np.asarray(voice_frames, np.uint8)
    assert voice_frames.shape == (6, 216)
    frags = embedded_lc_encode(lc.to_bytes(), device)
    out = np.zeros((6, FRAME_BITS), np.uint8)
    for fn in range(6):
        emb_frag = frags[fn - 1] if 1 <= fn <= 4 else None
        out[fn] = make_voice_burst(voice_frames[fn], color_code, fn,
                                   emb_frag, device=device)
    return out


def extract_info(frame_bits) -> np.ndarray:
    return np.asarray(frame_bits, np.uint8)[..., _INFO_IDX]


def extract_voice(frame_bits) -> np.ndarray:
    return np.asarray(frame_bits, np.uint8)[..., _VOICE_IDX]


def extract_slot_type(frame_bits) -> np.ndarray:
    return np.asarray(frame_bits, np.uint8)[..., _SLOT_TYPE_IDX]


def extract_emb(frame_bits) -> np.ndarray:
    return np.asarray(frame_bits, np.uint8)[..., _EMB_IDX]


def extract_embedded_signalling(frame_bits) -> np.ndarray:
    return np.asarray(frame_bits, np.uint8)[..., _EMBSIG_IDX]


def classify_sync(center_bits, max_errors: int = 4):
    """(..., 48) center-field bits -> (name | None) per the sync patterns.

    Mirrors gr_dmr_sink.cpp's correlation thresholding: a pattern matches
    when its Hamming distance is <= max_errors.
    """
    center = np.asarray(center_bits, np.uint8)
    best_name, best_d = None, max_errors + 1
    for name, pat in SYNC_PATTERNS.items():
        d = int(np.sum(center != pat, axis=-1))
        if d < best_d:
            best_name, best_d = name, d
    return best_name if best_d <= max_errors else None


# ---------------------------------------------------------------------------
# payload data bursts

def make_rate12_burst(payload_bytes, color_code: int,
                      sync: np.ndarray = SYNC_BS_DATA,
                      device=None) -> np.ndarray:
    """(12,) bytes -> rate-1/2 data burst (BPTC protected)."""
    bits = np.unpackbits(np.asarray(payload_bytes, np.uint8))
    info = _host(bptc.encode(as_bits(bits, device)))
    return make_data_burst(info, color_code, DT_RATE_12_DATA, sync, device)


def make_rate34_burst(payload_bytes, color_code: int,
                      sync: np.ndarray = SYNC_BS_DATA,
                      device=None) -> np.ndarray:
    """(18,) bytes -> rate-3/4 data burst (trellis protected)."""
    bits = np.unpackbits(np.asarray(payload_bytes, np.uint8))
    info = trellis34.encode(bits)
    return make_data_burst(info, color_code, DT_RATE_34_DATA, sync, device)


def make_lc_burst(lc: LinkControl, color_code: int, data_type: int,
                  sync: np.ndarray = SYNC_BS_DATA,
                  device=None) -> np.ndarray:
    """voice LC header / terminator burst (reference constructLCFrame)."""
    info = full_lc_encode(lc.to_bytes(), data_type, device)
    return make_data_burst(info, color_code, data_type, sync, device)


@dataclass
class DecodedBurst:
    """One received burst after host-side decode."""
    kind: str                     # 'data' | 'voice' | 'voice_sync' | 'unknown'
    data_type: int | None = None
    color_code: int | None = None
    lc: LinkControl | None = None
    payload: np.ndarray | None = None    # decoded data bytes
    voice_bits: np.ndarray | None = None  # (216,) AMBE bits
    emb_lcss: int | None = None
    embedded_fragment: np.ndarray | None = None
    ok: bool = False


def decode_burst(frame_bits, device=None) -> DecodedBurst:
    """Decode one 264-bit burst (reference DMRFrame::validate +
    getDataPayload, host-side state-machine food); the block codes run on
    `device`."""
    frame_bits = np.asarray(frame_bits, np.uint8)
    sync_name = classify_sync(frame_bits[_SYNC_IDX])
    if sync_name is not None and sync_name.endswith("audio"):
        return DecodedBurst(kind="voice_sync",
                            voice_bits=extract_voice(frame_bits), ok=True)
    if sync_name is not None:  # data sync
        cc, dt, st_ok = slot_type_decode(extract_slot_type(frame_bits),
                                         device)
        cc, dt = int(cc), int(dt)
        info = extract_info(frame_bits)
        if dt in (DT_VOICE_LC_HEADER, DT_TERMINATOR_WITH_LC):
            lc9, ok = full_lc_decode(info, dt, device)
            lc9, ok = np.asarray(lc9).reshape(-1)[:9], bool(np.asarray(ok).reshape(-1)[0])
            return DecodedBurst(kind="data", data_type=dt, color_code=cc,
                                lc=LinkControl.from_bytes(lc9), ok=ok and bool(st_ok))
        if dt == DT_RATE_34_DATA:
            payload, ok = trellis34.decode(info)
            return DecodedBurst(kind="data", data_type=dt, color_code=cc,
                                payload=np.packbits(payload), ok=bool(ok))
        # BPTC-protected types (rate 1/2, CSBK, data header, idle, PI)
        data, ok = bptc.decode(as_bits(info, device))
        return DecodedBurst(kind="data", data_type=dt, color_code=cc,
                            payload=np.packbits(_host(data)),
                            ok=bool(_host(ok)) and bool(st_ok))
    # no sync: EMB voice burst (B..F) — decode the EMB field
    cc, pi, lcss, emb_ok = emb_decode(extract_emb(frame_bits), device)
    if bool(np.asarray(emb_ok)):
        return DecodedBurst(
            kind="voice", color_code=int(cc), emb_lcss=int(lcss),
            voice_bits=extract_voice(frame_bits),
            embedded_fragment=extract_embedded_signalling(frame_bits), ok=True)
    return DecodedBurst(kind="unknown")


def find_bursts(bits, max_errors: int = 4):
    """Vectorized sync hunt over a hard-bit stream.

    Replaces the reference's bit-serial shift-register compare
    (gr_dmr_sink.cpp:78-120) with one correlation per pattern: an
    (offsets, 48) sliding window against all 8 patterns at once.
    Returns [(frame_start_bit, sync_name)] for every position whose
    best pattern has Hamming distance <= max_errors, where frame_start
    points at the burst's bit 0 (sync sits at bits 108..155).
    """
    bits = np.asarray(bits, np.uint8).ravel()
    if bits.size < 48:
        return []
    win = np.lib.stride_tricks.sliding_window_view(bits, 48)
    pats = np.stack(list(SYNC_PATTERNS.values()))          # (8, 48)
    names = list(SYNC_PATTERNS.keys())
    # Hamming distance via matmul: d = 48 - matches
    dists = (win[:, None, :] != pats[None, :, :]).sum(-1)  # (offsets, 8)
    best = dists.argmin(-1)
    best_d = dists.min(-1)
    hits = np.nonzero(best_d <= max_errors)[0]
    out = []
    last = -FRAME_BITS
    for pos in hits:
        start = int(pos) - 108
        if start < 0 or start + FRAME_BITS > bits.size:
            continue
        if start - last < FRAME_BITS // 2:  # suppress adjacent dupes
            continue
        out.append((start, names[int(best[pos])]))
        last = start
    return out


class EmbeddedLCAssembler:
    """Reassembles the 4-fragment embedded LC across a voice superframe
    (reference DMREmbeddedData::addData state machine); the Hamming code
    runs on `device`."""

    def __init__(self, device=None):
        self._frags: list[np.ndarray] = []
        self._state = 0
        self.device = device

    def add(self, fragment, lcss: int):
        want = EMBEDDED_LCSS[self._state] if self._state < 4 else None
        if lcss == 1:  # first fragment always (re)starts assembly
            self._frags = [np.asarray(fragment, np.uint8)]
            self._state = 1
            return None
        if want is not None and lcss == want and self._state >= 1:
            self._frags.append(np.asarray(fragment, np.uint8))
            self._state += 1
            if self._state == 4:
                self._state = 0
                lc9, ok = embedded_lc_decode(np.stack(self._frags),
                                             self.device)
                self._frags = []
                if ok:
                    return LinkControl.from_bytes(lc9)
        return None


# ---------------------------------------------------------------------------
# CSBK (control signalling block; reference src/MMDVM/DMRCSBK.cpp)

# CSBK opcodes (DMRCSBK.h enum CSBKO)
CSBKO_NONE = 0x00
CSBKO_UUVREQ = 0x04
CSBKO_UUANSRSP = 0x05
CSBKO_CTCSBK = 0x07
CSBKO_AHOY = 0x1C
CSBKO_RAND = 0x1F
CSBKO_ACKD = 0x20
CSBKO_ACKU = 0x21
CSBKO_RADIO_CHECK = 0x24
CSBKO_NACKRSP = 0x26
CSBKO_C_BCAST = 0x28
CSBKO_MAINT = 0x2A
CSBKO_P_CLEAR = 0x2E
CSBKO_PV_GRANT = 0x30
CSBKO_TV_GRANT = 0x31
CSBKO_BTV_GRANT = 0x32
CSBKO_PD_GRANT = 0x33
CSBKO_TD_GRANT = 0x34
CSBKO_PV_GRANT_DX = 0x35
CSBKO_PD_GRANT_DX = 0x36
CSBKO_BSDWNACT = 0x38
CSBKO_PRECCSBK = 0x3D

_CSBK_CRC_MASK = 0xA5A5   # DMRDefines.h:76, per-byte 0xA5


def _crc_ccitt162(payload10: np.ndarray) -> int:
    """DMR CCITT-16.2: CRC-16/CCITT init 0, complemented (CRC.cpp
    checkCCITT162). Returns the 16-bit value stored high byte first."""
    return crc16_ccitt(bytes(np.asarray(payload10, np.uint8)),
                       init=0x0000) ^ 0xFFFF


@dataclass
class Csbk:
    """Decoded CSBK fields (generic layout: byte0 = LB|PF|CSBKO,
    byte1 = FID, bytes2-3 = data1/CBF (or service fields), bytes 4-6 and
    7-9 = 24-bit ids whose src/dst order is opcode-specific)."""
    csbko: int = CSBKO_NONE
    fid: int = 0
    lb: bool = True
    pf: bool = False
    data1: int = 0
    cbf: int = 0
    dst_id: int = 0            # or BS id for BSDWNACT
    src_id: int = 0

    @property
    def service_kind(self) -> int:
        return self.cbf & 0x0F

    @property
    def service_options(self) -> int:
        return self.data1 >> 1

    def to_bytes(self) -> np.ndarray:
        b = np.zeros(12, np.uint8)
        b[0] = (self.csbko & 0x3F) | (0x80 if self.lb else 0) \
            | (0x40 if self.pf else 0)
        b[1] = self.fid
        b[2] = self.data1
        b[3] = self.cbf
        # BSDWNACT keeps (bs_id, src_id) in the same slots the generic
        # layout calls (dst, src); NACKRSP swaps src/dst (DMRCSBK.cpp put)
        hi, lo = (self.src_id, self.dst_id) \
            if self.csbko == CSBKO_NACKRSP else (self.dst_id, self.src_id)
        b[4:7] = [(hi >> 16) & 0xFF, (hi >> 8) & 0xFF, hi & 0xFF]
        b[7:10] = [(lo >> 16) & 0xFF, (lo >> 8) & 0xFF, lo & 0xFF]
        crc = _crc_ccitt162(b[:10]) ^ _CSBK_CRC_MASK
        b[10], b[11] = (crc >> 8) & 0xFF, crc & 0xFF
        return b

    @classmethod
    def from_bytes(cls, b) -> "Csbk | None":
        b = np.asarray(b, np.uint8)
        crc = (int(b[10]) << 8 | int(b[11])) ^ _CSBK_CRC_MASK
        if crc != _crc_ccitt162(b[:10]):
            return None
        csbko = int(b[0]) & 0x3F
        id_a = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
        id_b = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
        dst, src = (id_b, id_a) if csbko == CSBKO_NACKRSP else (id_a, id_b)
        return cls(csbko=csbko, fid=int(b[1]), lb=bool(b[0] & 0x80),
                   pf=bool(b[0] & 0x40), data1=int(b[2]), cbf=int(b[3]),
                   dst_id=dst, src_id=src)


def make_csbk_burst(csbk: Csbk, color_code: int,
                    sync: np.ndarray = SYNC_BS_DATA,
                    device=None) -> np.ndarray:
    """CSBK -> (264,) data burst (BPTC-protected, DT_CSBK slot type)."""
    bits = np.unpackbits(csbk.to_bytes())
    info = _host(bptc.encode(as_bits(bits, device)))
    return make_data_burst(info, color_code, DT_CSBK, sync, device)


def bs_downlink_activate(src_id: int, dst_id: int) -> Csbk:
    """The BSDWNACT wake-up CSBK the reference transmits 3x before a
    repeater call (dmrcontrol.cpp getStartCSBK:99-116)."""
    return Csbk(csbko=CSBKO_BSDWNACT, data1=0x00, cbf=0x00,
                src_id=src_id, dst_id=dst_id)


# ---------------------------------------------------------------------------
# talker alias (embedded LC FLCOs 4..7; reference dmrcontrol.cpp:183-219
# TX rotation, :497-555 RX assembly)

FLCO_TALKER_ALIAS_HEADER = 4
FLCO_TALKER_ALIAS_BLOCK1 = 5
FLCO_TALKER_ALIAS_BLOCK2 = 6
FLCO_TALKER_ALIAS_BLOCK3 = 7
FLCO_GPS_INFO = 8


def talker_alias_tx_lcs(alias: str) -> list[LinkControl]:
    """alias -> the 4 embedded LCs (header + blocks 1-3) the TX rotates
    through superframes 1..4 (dmrcontrol.cpp:183-219). Format 2
    (ISO-8 chars), 27-byte buffer zero-padded."""
    ta = np.zeros(27, np.uint8)
    raw = alias.encode("utf-8")[:27]
    ta[:len(raw)] = np.frombuffer(raw, np.uint8)
    out = []
    # header: options = format<<6 | length<<1 with format=1? The
    # reference sends options = (1 << 6) | (0x1B << 1) — format 1
    # (ISO 7-bit flagged as 8-bit payload), fixed claimed length 27.
    # the reference builds CDMRLC(flco, a2, a1) whose ctor order is
    # (src, dst) — so LC dst bytes carry a1 (first chars), src bytes a2
    opts = (1 << 6) | (0x1B << 1)
    a1 = (int(ta[0]) << 16) | (int(ta[1]) << 8) | int(ta[2])
    a2 = (int(ta[3]) << 16) | (int(ta[4]) << 8) | int(ta[5])
    out.append(LinkControl(flco=FLCO_TALKER_ALIAS_HEADER, options=opts,
                           dst_id=a1, src_id=a2))
    for blk, flco in enumerate((FLCO_TALKER_ALIAS_BLOCK1,
                                FLCO_TALKER_ALIAS_BLOCK2,
                                FLCO_TALKER_ALIAS_BLOCK3)):
        i = (blk + 1) * 6
        opts = int(ta[i])
        a1 = (int(ta[i + 1]) << 16) | (int(ta[i + 2]) << 8) | int(ta[i + 3])
        a2 = (int(ta[i + 4]) << 16) | (int(ta[i + 5]) << 8) | int(ta[i + 6])
        out.append(LinkControl(flco=flco, options=opts,
                               dst_id=a1, src_id=a2))
    return out


class TalkerAliasAssembler:
    """RX-side talker alias accumulation across the TA header/block LCs
    (reference dmrcontrol.cpp:497-555,578-623). Returns the decoded
    alias string once enough blocks arrived, else None."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._df = 0
        self._dl = 0
        self._data = bytearray()
        self._done = False

    def add(self, lc: LinkControl) -> str | None:
        if self._done:
            return None
        raw = np.asarray(lc.to_bytes(), np.uint8)
        if lc.flco == FLCO_TALKER_ALIAS_HEADER:
            self._df = (int(raw[2]) >> 6) & 0x03
            self._dl = (int(raw[2]) >> 1) & 0x1F
            self._data = bytearray()
            if self._df == 0:
                self._data.append(int(raw[2]) & 0x01)
            self._data.extend(raw[3:9].tobytes())
        elif lc.flco in (FLCO_TALKER_ALIAS_BLOCK1, FLCO_TALKER_ALIAS_BLOCK2,
                         FLCO_TALKER_ALIAS_BLOCK3):
            if self._dl == 0:
                return None
            self._data.extend(raw[2:9].tobytes())
        else:
            return None
        return self._try_decode()

    def _try_decode(self) -> str | None:
        size = len(self._data)
        if size < 1:
            return None
        bit7_size = 8 * size // 7
        df, dl = self._df, self._dl
        ready = ((df in (1, 2) and size >= dl)
                 or (df == 3 and size >= dl * 2)
                 or (df == 0 and bit7_size >= dl))
        if not ready:
            return None
        self._done = True
        data = bytes(self._data)
        if df in (1, 2):
            txt = data[:dl].decode("utf-8", errors="replace")
        elif df == 0:
            # ISO 7-bit packing: dl 7-bit chars across the byte stream
            bits = np.unpackbits(np.frombuffer(data, np.uint8))
            chars = [int(c) for c in
                     (bits[1:][: (len(bits) - 1) // 7 * 7]
                      .reshape(-1, 7) * (1 << np.arange(6, -1, -1))).sum(1)]
            txt = "".join(chr(c) for c in chars[:dl] if c)
        else:  # UTF-16 BE
            txt = data[:dl * 2].decode("utf-16-be", errors="replace")
        return txt.rstrip("\x00").strip()
