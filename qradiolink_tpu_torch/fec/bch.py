"""BCH(63,16) encoder, the reference's P25-style NID protection (port of
qradiolink_tpu/fec/bch.py).

Reference: src/MMDVM/BCH.cpp:86-139 (bch3.c-derived systematic encoder:
parity = x^47 * data(x) mod g(x) with the fixed degree-47 generator). The
code is linear over GF(2), so the 16 x 47 parity matrix is built once on
the host from unit-vector encodings of the reference's bit-serial LFSR,
and a batch of NIDs encodes as one (..., 16) x (16, 47) product mod 2 on
the input's device, an integer sum of 0/1 products (exact on every device,
as the block codes' products are); the matrix is kept per device.
Bit-exact with the compiled reference (tests/fixtures/bch_golden.json).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qradiolink_tpu_torch.fec.block_codes import as_bits

# generator polynomial coefficients g[0..47] (BCH.cpp:88-89)
_G = np.array(
    [1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1,
     1, 1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1],
    dtype=np.int64)

N, K = 63, 16
_NPAR = N - K  # 47


def _lfsr_parity(data16: np.ndarray) -> np.ndarray:
    """Bit-exact port of CBCH::encode(const int*, int*) (BCH.cpp:98-122)."""
    bb = np.zeros(_NPAR, np.int64)
    for i in range(K - 1, -1, -1):
        feedback = data16[i] ^ bb[_NPAR - 1]
        if feedback:
            for j in range(_NPAR - 1, 0, -1):
                bb[j] = bb[j - 1] ^ feedback if _G[j] else bb[j - 1]
            bb[0] = _G[0] & feedback
        else:
            bb[1:] = bb[:-1]
            bb[0] = 0
    return bb


@functools.lru_cache(maxsize=1)
def parity_matrix() -> np.ndarray:
    """P (16, 47): parity of unit data vectors; parity(d) = d @ P mod 2."""
    P = np.zeros((K, _NPAR), np.float32)
    for i in range(K):
        unit = np.zeros(K, np.int64)
        unit[i] = 1
        P[i] = _lfsr_parity(unit)
    return P


_P_ON: dict = {}


def _p_on(device: torch.device) -> torch.Tensor:
    if device not in _P_ON:
        _P_ON[device] = torch.from_numpy(
            parity_matrix().astype(np.int32)).to(device)
    return _P_ON[device]


def bch_encode(data_bits, device=None) -> torch.Tensor:
    """(..., 16) data bits -> (..., 63) systematic codewords, uint8, on the
    input's device (a tensor) or on `device` (None: CUDA).

    Output bit order matches CBCH::encode(unsigned char*): data bits
    first (positions 0..15), then parity bb[0..46] (positions 16..62)
    — the reference writes bb[] in ascending index order
    (BCH.cpp:135-138)."""
    d = as_bits(data_bits, device).to(torch.int32)
    par = (d[..., :, None] * _p_on(d.device)).sum(dim=-2) % 2
    return torch.cat([d, par], dim=-1).to(torch.uint8)


def encode_nid(nid: bytes | bytearray, device=None) -> bytes:
    """Byte-level equivalent of CBCH::encode(unsigned char*): reads the
    first 16 bits, writes the 47 parity bits at bit positions 16..62
    (bit 63 untouched). Host-side helper for packed NID buffers; the
    product runs on `device` (None: CUDA)."""
    buf = np.unpackbits(np.frombuffer(bytes(nid), np.uint8))
    cw = bch_encode(buf[:K], device).cpu().numpy()
    buf = buf.copy()
    buf[K:N] = cw[K:N]
    return np.packbits(buf).tobytes()
