"""Reed-Solomon (12,9) over GF(2^8) — DMR full link control protection
(a copy of qradiolink_tpu/fec/rs129.py, pure numpy).

Equivalent of reference src/MMDVM/RS129.cpp: DMR voice LC headers and
terminators protect their 9 LC bytes with 3 RS parity bytes (ETSI TS
102 361-1 B.3.6). Field GF(256) with primitive polynomial
x^8+x^4+x^3+x^2+1 (0x11D); generator g(x) = (x-a)(x-a^2)(x-a^3) =
x^3 + a^6 x^2 + (a^3+a^4+a^5) x + a^6... expanded below from the roots
rather than copied as magic bytes.

Array formulation: GF(256) multiplication is a log/antilog table
lookup; the 3-tap LFSR encode over 9 input bytes unrolls to 9 static
steps of batched table gathers, so any number of LC words encode as one
vectorized pass (the reference encodes one frame at a time). Like the
reference, `check` verifies parity (the DMR LC decode path discards
frames that fail rather than attempting RS error correction).
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D
NPAR = 3

# log/antilog tables generated from the primitive polynomial
_EXP = np.zeros(512, np.uint8)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= GF_POLY
_EXP[255:510] = _EXP[:255]


def _gmult(a, b):
    """Batched GF(256) multiply (0 absorbing)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = _EXP[_LOG[a] + _LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def _gen_poly() -> np.ndarray:
    """g(x) = (x - a)(x - a^2)(x - a^3), low-order coefficient first.

    Expanding reproduces the reference's POLY table {64, 56, 14, 1}
    (RS129.cpp:30) — asserted in tests/test_dmr_fec.py.
    """
    g = np.array([1], np.uint8)  # start with 1
    for i in (1, 2, 3):
        root = _EXP[i]
        # multiply g(x) by (x + root)  (— == + in GF(2^m))
        g2 = np.zeros(len(g) + 1, np.uint8)
        g2[1:] ^= g                       # x * g(x)
        g2[:-1] ^= _gmult(g, root)        # root * g(x)
        g = g2
    return g  # length 4, g[3] == 1


POLY = _gen_poly()[:NPAR]  # LFSR feedback taps, low-order first


def encode(msg: np.ndarray) -> np.ndarray:
    """(..., 9) message bytes -> (..., 3) parity bytes.

    Parity is returned in the on-air order lc[9..11] = parity[2], [1],
    [0] of the reference's LFSR registers (RS129.cpp encode + FullLC
    placement DMRFullLC.cpp:64-66) — i.e. ready to append to the 9 LC
    bytes directly.
    """
    msg = np.asarray(msg, np.uint8)
    lead = msg.shape[:-1]
    par = np.zeros(lead + (NPAR,), np.uint8)
    for i in range(msg.shape[-1]):
        dbyte = msg[..., i] ^ par[..., NPAR - 1]
        for j in range(NPAR - 1, 0, -1):
            par[..., j] = par[..., j - 1] ^ _gmult(POLY[j], dbyte)
        par[..., 0] = _gmult(POLY[0], dbyte)
    return par[..., ::-1]


def check(codeword: np.ndarray) -> np.ndarray:
    """(..., 12) bytes -> (...,) bool parity-valid flags."""
    codeword = np.asarray(codeword, np.uint8)
    par = encode(codeword[..., :9])
    return np.all(codeword[..., 9:12] == par, axis=-1)
