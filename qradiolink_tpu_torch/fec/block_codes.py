"""Short linear block codes used by the DMR/M17 protocol stacks (port of
qradiolink_tpu/fec/block_codes.py).

Equivalents of the reference's MMDVM FEC library (reference
src/MMDVM/Hamming.cpp, Golay24128.cpp, Golay2087.cpp, QR1676.cpp): the
DMR/M17 air interfaces protect header fields with short Hamming / Golay /
quadratic-residue codes (ETSI TS 102 361-1 annex B; M17 spec).

Every code here is a linear code over GF(2), so

  encode:  c = u G mod 2
  decode:  s = r H^T mod 2 -> error pattern from a syndrome table built at
           import time (2^(n-k) entries, covering all correctable
           patterns) -> c ^ e

both batched over any leading axes. The tables are numpy, built on the
host at import (no device is touched then); each code copies them to an
input's device at its first call there and keeps them per device. The
products are integer sums of 0/1 products, exact on every device (CUDA has
no integer matmul). Plain PyTorch: no kernel, the codes run at protocol
rate (tens of codewords a burst).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from qradiolink_tpu_torch.core import resolve_device


def _poly_mod(value: int, deg_in: int, g: int, deg_g: int) -> int:
    """(value(x) * x^deg_g) mod g(x) over GF(2) — cyclic-code parity."""
    v = value << deg_g
    for i in range(deg_in + deg_g - 1, deg_g - 1, -1):
        if v & (1 << i):
            v ^= g << (i - deg_g)
    return v


class BlockCode:
    """Systematic linear block code [data bits | parity bits].

    Built either from explicit parity equations (`parity_sets[j]` = data
    indices XORed into parity j) or from a cyclic generator polynomial.
    Decode corrects every error pattern of weight <= t via syndrome table.
    Encode and decode take uint8 bit tensors and return tensors on the
    input's device.
    """

    def __init__(self, n: int, k: int, parity_sets, t: int,
                 extra_parity: bool = False):
        self.n, self.k, self.t = n, k, t
        self.extra_parity = extra_parity
        m = n - k - (1 if extra_parity else 0)
        # H (without overall parity): [m, n_core] with identity on parity
        n_core = k + m
        H = np.zeros((m, n_core), np.uint8)
        for j, s in enumerate(parity_sets):
            for i in s:
                H[j, i] = 1
            H[j, k + j] = 1
        self._H_core = H
        # G: [k, n_core] systematic
        G = np.zeros((k, n_core), np.uint8)
        G[:, :k] = np.eye(k, dtype=np.uint8)
        G[:, k:] = H[:, :k].T
        self._G_core = G

        # syndrome -> error pattern table over the FULL n bits
        n_syn = 1 << (n - k)
        self._err_table = np.zeros((n_syn, n), np.uint8)
        self._ok_table = np.zeros(n_syn, bool)
        for w in range(t, -1, -1):  # low weight written last (wins ties)
            for pos in combinations(range(n), w):
                e = np.zeros(n, np.uint8)
                e[list(pos)] = 1
                s = self._syndrome_np(e[None, :])[0]
                self._err_table[s] = e
                self._ok_table[s] = True
        self._Ht = self._full_H().T.astype(np.int32)
        self._on = {}

    @classmethod
    def from_cyclic(cls, n: int, k: int, g: int, deg_g: int, t: int,
                    extra_parity: bool = False):
        """Systematic cyclic code: parity of unit vectors gives H."""
        m = n - k - (1 if extra_parity else 0)
        assert m == deg_g, f"parity bits {m} != generator degree {deg_g}"
        sets = [[] for _ in range(m)]
        for i in range(k):
            rem = _poly_mod(1 << (k - 1 - i), k, g, deg_g)
            for j in range(m):
                if rem & (1 << (m - 1 - j)):
                    sets[j].append(i)
        return cls(n, k, sets, t, extra_parity=extra_parity)

    @classmethod
    def from_parity_basis(cls, n: int, k: int, basis, t: int):
        """Code given per-data-bit parity words: basis[i] = the (n-k)-bit
        parity contribution (MSB-first) of data bit u[i]."""
        m = n - k
        sets = [[] for _ in range(m)]
        for i, b in enumerate(basis):
            for j in range(m):
                if b & (1 << (m - 1 - j)):
                    sets[j].append(i)
        return cls(n, k, sets, t)

    def _full_H(self) -> np.ndarray:
        """Parity check over all n bits (incl. overall parity if present)."""
        m, n_core = self._H_core.shape
        if not self.extra_parity:
            return self._H_core
        H = np.zeros((m + 1, self.n), np.uint8)
        H[:m, :n_core] = self._H_core
        H[m, :] = 1  # overall even parity row
        return H

    def _syndrome_np(self, r: np.ndarray) -> np.ndarray:
        H = self._full_H()
        s_bits = (r @ H.T) & 1
        w = 1 << np.arange(H.shape[0], dtype=np.uint32)
        return (s_bits.astype(np.uint32) @ w).astype(np.int64)

    @property
    def Ht(self) -> np.ndarray:
        """H^T over all n bits, (n, n - k) int32, as numpy (read-only)."""
        v = self._Ht.view()
        v.flags.writeable = False
        return v

    def tables(self, device) -> dict:
        """G, H^T, the syndrome weights and the error and ok tables as
        tensors on `device`, made at the first call for that device."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {
                "G": torch.from_numpy(self._G_core.astype(np.int32)).to(
                    device),
                "Ht": torch.from_numpy(self._Ht).to(device),
                "w": (1 << torch.arange(self._Ht.shape[-1],
                                        dtype=torch.int64)).to(device),
                "err": torch.from_numpy(self._err_table).to(device),
                "ok": torch.from_numpy(self._ok_table).to(device)}
        return self._on[device]

    @staticmethod
    def _bit_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(..., p) x (p, q) over the integers: the sum of 0/1 products."""
        return (a.to(torch.int32)[..., :, None] * b).sum(dim=-2)

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """u: (..., k) bits -> (..., n) codeword bits."""
        tab = self.tables(u.device)
        c = self._bit_product(u, tab["G"]) % 2
        if self.extra_parity:
            p = torch.sum(c, dim=-1, keepdim=True) % 2
            c = torch.cat([c, p], dim=-1)
        return c.to(torch.uint8)

    def decode(self, r: torch.Tensor):
        """r: (..., n) bits -> (corrected data (..., k), ok (...,) bool)."""
        c, ok = self.decode_codeword(r)
        return c[..., : self.k], ok

    def decode_codeword(self, r: torch.Tensor):
        """r: (..., n) bits -> (corrected codeword (..., n), ok (...,) bool).

        Used by product codes (BPTC) that iterate row/column corrections
        over the full codeword rather than extracting data immediately.
        """
        tab = self.tables(r.device)
        s_bits = self._bit_product(r, tab["Ht"]) % 2
        s = torch.sum(s_bits.to(torch.int64) * tab["w"], dim=-1)
        e = tab["err"][s]
        ok = tab["ok"][s]
        c = torch.bitwise_xor(r.to(torch.uint8), e)
        return c, ok


# ---------------------------------------------------------------------------
# Hamming family (parity equations from ETSI TS 102 361-1 annex B.3, as
# implemented in reference src/MMDVM/Hamming.cpp)
# ---------------------------------------------------------------------------

# Hamming (15,11,3): reference Hamming.cpp:30-33 (encode :72-75)
HAMMING_15_11 = BlockCode(15, 11, [
    [0, 1, 2, 3, 4, 5, 6],
    [0, 1, 2, 3, 7, 8, 9],
    [0, 1, 4, 5, 7, 8, 10],
    [0, 2, 4, 6, 7, 9, 10],
], t=1)

# Hamming (15,11,3) variant 2: reference Hamming.cpp:84-87 (encode :125-128)
HAMMING_15_11_2 = BlockCode(15, 11, [
    [0, 1, 2, 3, 5, 7, 8],
    [1, 2, 3, 4, 6, 8, 9],
    [2, 3, 4, 5, 7, 9, 10],
    [0, 1, 2, 4, 6, 7, 10],
], t=1)

# Hamming (13,9,3): reference Hamming.cpp:137-140 (encode :177-180)
HAMMING_13_9 = BlockCode(13, 9, [
    [0, 1, 3, 5, 6],
    [0, 1, 2, 4, 6, 7],
    [0, 1, 2, 3, 5, 7, 8],
    [0, 2, 4, 5, 8],
], t=1)

# Hamming (10,6,3): reference Hamming.cpp:188-191 (encode :224-227)
HAMMING_10_6 = BlockCode(10, 6, [
    [0, 1, 2, 5],
    [0, 1, 3, 5],
    [0, 2, 3, 4],
    [1, 2, 3, 4],
], t=1)

# Hamming (16,11,4): reference Hamming.cpp:236-240 — (15,11) + 5th parity
HAMMING_16_11 = BlockCode(16, 11, [
    [0, 1, 2, 3, 5, 7, 8],
    [1, 2, 3, 4, 6, 8, 9],
    [2, 3, 4, 5, 7, 9, 10],
    [0, 1, 2, 4, 6, 7, 10],
    [0, 2, 5, 6, 8, 9, 10],
], t=1)

# Hamming (17,12,3): reference Hamming.cpp:296-300 (encode :345-349)
HAMMING_17_12 = BlockCode(17, 12, [
    [0, 1, 2, 3, 6, 7, 9],
    [0, 1, 2, 3, 4, 7, 8, 10],
    [1, 2, 3, 4, 5, 8, 9, 11],
    [0, 1, 4, 5, 7, 10],
    [0, 1, 2, 5, 6, 8, 11],
], t=1)


# ---------------------------------------------------------------------------
# Golay codes
# ---------------------------------------------------------------------------

# Perfect binary Golay (23,12,7), generator x^11+x^10+x^6+x^5+x^4+x^2+1.
# The reference's 24-bit "Golay24128" table (src/MMDVM/Golay24128.cpp:12)
# is this codeword left-aligned in 3 bytes (LSB always 0).
GOLAY_23_12 = BlockCode.from_cyclic(23, 12, 0xC75, 11, t=3)

# Extended Golay (24,12,8): (23,12) + overall even parity. Corrects 3.
GOLAY_24_12 = BlockCode.from_cyclic(24, 12, 0xC75, 11, t=3,
                                    extra_parity=True)

# Golay (20,8): the extended Golay shortened by 4 data bits — 8 data +
# 11 cyclic parity + overall parity (reference src/MMDVM/Golay2087.cpp,
# used for the DMR CACH / AMBE FEC)
GOLAY_20_8 = BlockCode.from_cyclic(20, 8, 0xC75, 11, t=3, extra_parity=True)

# Quadratic residue (16,7,6): 7 data + 9 parity, corrects 2 errors
# (DMR EMB; reference src/MMDVM/QR1676.cpp). Parity basis extracted from
# the reference ENCODING_TABLE_1676 single-bit entries (the table is not
# plain systematic cyclic encoding, so the basis is taken as data):
# T[2^i] & 0x1FF for i = 6..0 -> parity word of data bit u[0..6].
QR_16_7 = BlockCode.from_parity_basis(16, 7, [
    0x04F, 0x11E, 0x1B7, 0x1E2, 0x1C9, 0x0E5, 0x073], t=2)


def as_bits(u, device=None) -> torch.Tensor:
    """Bits as a uint8 tensor: a tensor keeps its device; anything else
    (numpy, lists) goes to `device` (None: CUDA, see core.resolve_device)."""
    if isinstance(u, torch.Tensor):
        return u.to(torch.uint8)
    return torch.from_numpy(np.array(u, dtype=np.uint8)).to(
        resolve_device(device))


def encode_bits(code: BlockCode, u, device=None):
    return code.encode(as_bits(u, device))


def decode_bits(code: BlockCode, r, device=None):
    return code.decode(as_bits(r, device))
