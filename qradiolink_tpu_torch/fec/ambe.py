"""AMBE voice-frame FEC for DMR, 72-bit AMBE 3600x2450 frames (port of
qradiolink_tpu/fec/ambe.py).

Semantics of the reference's CAMBEFEC::regenerateDMR (reference
src/MMDVM/AMBEFEC.cpp:476-576,828-868): each DMR voice burst carries
three 72-bit AMBE frames; inside a frame the 49 payload bits are
protected as

  a: 24 bits = Golay(24,12) over the 12 most significant payload bits
  b: 23 bits = Golay(23,12) over the next 12 bits, whitened by a
     PRNG keyed on a's data word
  c: 25 bits unprotected

with a/b/c bits interleaved through the frame by fixed position tables
(AMBE spec interleave, AMBEFEC.cpp:445-449). "Regeneration" decodes and
re-encodes a and b, substituting a fixed silence frame when the error
count crosses the reference's thresholds (a undecodable -> 10 errors;
errsA >= 4; errsA+errsB >= 6 with errsA >= 2).

Regeneration is bit-exact with the reference (golden vectors from the
compiled reference library, tests/fixtures/ambe_golden.json), including
the a-block decode asymmetry: only the 23-bit prefix of a is decoded and
the appended parity bit is never corrected (Golay24128::decode24128), but
a is re-encoded from the decoded data so outputs are always valid
codewords. The reference's `encode23127` returns the (23,12) codeword
left-aligned in 24 bits, so its `encode23127(datb) >> 1` in the b path is
plain alignment.

The whitening PRNG is the standard AMBE LCG p_{i+1} = (173 p_i + 13849)
mod 65536 seeded with 16*data, emitting bit (p >= 32768), regenerated at
import time.

Inputs and outputs are numpy, vectorized over any leading axes (bursts x
slots), as in the JAX package. The Golay codes are the port's torch block
codes: every function takes a `device` for them (None: CUDA, see
core.resolve_device; pass device="cpu" on a host without a card), hands
them tensors there and brings their results back; the interleave, the
PRNG and the thresholds are numpy on the host.
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.fec.block_codes import (GOLAY_23_12, GOLAY_24_12,
                                                  as_bits)

# bit positions of the a/b/c words inside one 72-bit AMBE frame
# (reference AMBEFEC.cpp:445-449 — AMBE air-interface interleave tables)
A_TABLE = np.array([0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44,
                    48, 52, 56, 60, 64, 68, 1, 5, 9, 13, 17, 21], np.int64)
B_TABLE = np.array([25, 29, 33, 37, 41, 45, 49, 53, 57, 61, 65, 69,
                    2, 6, 10, 14, 18, 22, 26, 30, 34, 38, 42], np.int64)
C_TABLE = np.array([46, 50, 54, 58, 62, 66, 70, 3, 7, 11, 15, 19,
                    23, 27, 31, 35, 39, 43, 47, 51, 55, 59, 63, 67, 71],
                   np.int64)

# silence substitution words (AMBEFEC.cpp:836-838,860-862)
SILENCE_A = 0xF00292
SILENCE_B = 0x0E0B20


def _prng_table() -> np.ndarray:
    """(4096,) uint32: 24 whitening bits per 12-bit a-data word via the
    AMBE LCG (the recurrence the reference spells out for IMBE at
    AMBEFEC.cpp:718-722; its DMR PRNG_TABLE is this, precomputed)."""
    out = np.zeros(4096, np.int64)
    p = 16 * np.arange(4096, dtype=np.int64)
    for _ in range(24):
        p = (173 * p + 13849) % 65536
        out = (out << 1) | (p >= 32768)
    return out.astype(np.uint32)


PRNG_TABLE = _prng_table()


def _bits_to_int(bits) -> np.ndarray:
    """(..., n) bits MSB-first -> int."""
    bits = np.asarray(bits, np.int64)
    w = 1 << np.arange(bits.shape[-1] - 1, -1, -1, dtype=np.int64)
    return (bits * w).sum(-1)


def _int_to_bits(v, n) -> np.ndarray:
    v = np.asarray(v, np.int64)
    sh = np.arange(n - 1, -1, -1, dtype=np.int64)
    return ((v[..., None] >> sh) & 1).astype(np.uint8)


def _encode(code, u, device) -> np.ndarray:
    return code.encode(as_bits(u, device)).cpu().numpy()


def _decode_codeword(code, r, device) -> np.ndarray:
    c, _ok = code.decode_codeword(as_bits(r, device))
    return c.cpu().numpy()


def golay24_encode_word(data, device=None) -> np.ndarray:
    """12-bit data word(s) -> 24-bit Golay(24,12) codeword int
    (== reference CGolay24128::encode24128)."""
    u = _int_to_bits(np.asarray(data, np.int64), 12)
    return _bits_to_int(_encode(GOLAY_24_12, u, device))


def golay23_encode_word(data, device=None) -> np.ndarray:
    """12-bit data word(s) -> 23-bit Golay(23,12) codeword int,
    right-aligned (the reference CGolay24128::encode23127 returns the
    same codeword left-aligned in 24 bits, i.e. this value << 1)."""
    u = _int_to_bits(np.asarray(data, np.int64), 12)
    return _bits_to_int(_encode(GOLAY_23_12, u, device))


def ambe49_encode(payload49, device=None) -> np.ndarray:
    """(..., 49) payload bits -> (..., 72) FEC-protected AMBE frame.

    payload = [12 a-data | 12 b-data | 25 c]. b is the full whitened
    Golay(23,12) codeword."""
    p = np.asarray(payload49, np.uint8)
    a_data = _bits_to_int(p[..., :12])
    b_data = _bits_to_int(p[..., 12:24])
    a = golay24_encode_word(a_data, device)
    prn = (PRNG_TABLE[a_data] >> 1).astype(np.int64)
    b = golay23_encode_word(b_data, device) ^ prn
    frame = np.zeros(p.shape[:-1] + (72,), np.uint8)
    frame[..., A_TABLE] = _int_to_bits(a, 24)
    frame[..., B_TABLE] = _int_to_bits(b, 23)
    frame[..., C_TABLE] = p[..., 24:]
    return frame


def ambe49_decode(frame72, device=None):
    """(..., 72) frame bits -> ((..., 49) payload bits, (...,) errors).

    FEC-correcting inverse of ambe49_encode (corrects up to 3 errors in
    each of a and b)."""
    f = np.asarray(frame72, np.uint8)
    a_bits = f[..., A_TABLE]
    a_cw = _decode_codeword(GOLAY_24_12, a_bits, device)
    a_data = _bits_to_int(a_cw[..., :12])
    errs_a = (a_cw != a_bits).sum(-1)
    prn = (PRNG_TABLE[a_data] >> 1).astype(np.int64)
    b_bits = _int_to_bits(_bits_to_int(f[..., B_TABLE]) ^ prn, 23)
    b_cw = _decode_codeword(GOLAY_23_12, b_bits, device)
    errs_b = (b_cw != b_bits).sum(-1)
    payload = np.concatenate(
        [a_cw[..., :12], b_cw[..., :12], f[..., C_TABLE]], axis=-1)
    return payload, errs_a + errs_b


def _decode_a_ref(a_bits, device=None):
    """Reference a-block decode (Golay24128::decode24128): decode only
    the 23-bit prefix, never correcting the appended parity bit.

    Returns (data12 int, corrected24 bits, valid) where valid mirrors
    `popcount(syndrome) < 3 or popcount(corrected) even`."""
    a23 = a_bits[..., :23]
    s_bits = (a23.astype(np.int64) @ GOLAY_23_12.Ht) % 2
    spop = s_bits.sum(-1)
    c23 = _decode_codeword(GOLAY_23_12, a23, device)
    corrected = np.concatenate([c23, a_bits[..., 23:]], axis=-1)
    even = corrected.sum(-1) % 2 == 0
    valid = (spop < 3) | even
    return _bits_to_int(c23[..., :12]), corrected, valid


def regenerate_frame(frame72, device=None):
    """(..., 72) AMBE frame bits -> (regenerated, errors), bit-exact
    with the reference's per-frame regeneration (AMBEFEC.cpp:828-868):
    decode+re-encode a and b; silence substitution on an undecodable a
    (10 errors) or when errsA >= 4 or errsA+errsB >= 6 with
    errsA >= 2."""
    f = np.asarray(frame72, np.uint8)
    a_bits = f[..., A_TABLE]
    b_bits_raw = f[..., B_TABLE]

    a_data, _, a_ok = _decode_a_ref(a_bits, device)
    # re-encode from decoded data (reference re-encodes after decoding,
    # so the parity bit of the output is always consistent)
    a_out = golay24_encode_word(a_data, device)
    errs_a = (_int_to_bits(a_out, 24) != a_bits).sum(-1)

    prn = (PRNG_TABLE[a_data] >> 1).astype(np.int64)
    b_int = _bits_to_int(b_bits_raw) ^ prn
    b_cw = _decode_codeword(GOLAY_23_12, _int_to_bits(b_int, 23), device)
    b_out = _bits_to_int(b_cw) ^ prn
    errs_b = (_int_to_bits(b_out, 23) != b_bits_raw).sum(-1)

    errors = errs_a + errs_b
    silence = (~a_ok) | (errs_a >= 4) | ((errors >= 6) & (errs_a >= 2))
    errors = np.where(~a_ok, 10, errors)

    a_fin = np.where(silence, SILENCE_A, a_out)
    b_fin = np.where(silence, SILENCE_B, b_out)
    out = f.copy()
    out[..., A_TABLE] = _int_to_bits(a_fin, 24)
    out[..., B_TABLE] = _int_to_bits(b_fin, 23)
    out[..., C_TABLE] = np.where(silence[..., None], 0, f[..., C_TABLE])
    return out, errors


def regenerate_voice(voice216, device=None):
    """(..., 216) DMR voice-field bits -> (regenerated, total errors),
    reference-exact. The three AMBE frames sit at voice bits [0:72],
    [72:144], [144:216] (the reference's burst position arithmetic at
    AMBEFEC.cpp:480-494 collapses to this in extracted-voice
    coordinates)."""
    v = np.asarray(voice216, np.uint8)
    frames = v.reshape(*v.shape[:-1], 3, 72)
    out, errs = regenerate_frame(frames, device)
    return out.reshape(v.shape), errs.sum(-1)


def voice_encode(payloads, device=None) -> np.ndarray:
    """(..., 3, 49) payload bits -> (..., 216) voice-field bits."""
    p = np.asarray(payloads, np.uint8)
    return ambe49_encode(p, device).reshape(*p.shape[:-2], 216)


def voice_decode(voice216, device=None):
    """(..., 216) voice bits -> ((..., 3, 49) payloads, (...,) errors)."""
    v = np.asarray(voice216, np.uint8)
    frames = v.reshape(*v.shape[:-1], 3, 72)
    payloads, errs = ambe49_decode(frames, device)
    return payloads, errs.sum(-1)
