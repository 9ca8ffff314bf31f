"""BPTC(196,96) — the DMR block product turbo code (port of
qradiolink_tpu/fec/bptc.py).

Equivalent of reference src/MMDVM/BPTC19696.cpp (347 LoC): DMR protects
every 96-bit data payload (full LC, CSBK, rate-1/2 data...) with a
product code over a 13x15 bit matrix — rows Hamming(15,11,3) variant 2,
columns Hamming(13,9,3) — interleaved over the burst's 196 info-bit
positions with the quadratic permutation (a*181) mod 196 (ETSI TS
102 361-1 B.1.1).

A batch of frames is a (..., 196) uint8 tensor; (de)interleave is a
constant gather; each repair round decodes ALL 15 columns and ALL 9 rows
of every frame at once through the syndrome-table BlockCodes; the
reference's bounded repair loop (max 5 rounds) is 5 rounds. Plain
PyTorch on the input's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qradiolink_tpu_torch.fec.block_codes import (HAMMING_13_9,
                                                  HAMMING_15_11_2, as_bits)

N_BITS = 196
K_BITS = 96

# deinterleave: deinter[a] = raw[(a * 181) % 196]  (BPTC19696.cpp:129)
_A = np.arange(N_BITS, dtype=np.int64)
DEINTERLEAVE_IDX = (_A * 181) % 196
INTERLEAVE_IDX = np.empty(N_BITS, np.int64)
INTERLEAVE_IDX[DEINTERLEAVE_IDX] = _A  # raw[idx[a]] = deinter[a]

# data bit positions inside the deinterleaved 196 (BPTC19696.cpp:172-204):
# bit 0 is the unused R(3); grid[r, c] = deinter[1 + r*15 + c], rows 0..8
# carry data (row 0 cols 3..10 after three zero pad bits, rows 1..8 cols
# 0..10), cols 11..14 row parity, rows 9..12 column parity.
DATA_IDX = np.concatenate([
    np.arange(4, 12),
    *[np.arange(16 + 15 * r, 27 + 15 * r) for r in range(8)],
]).astype(np.int64)
assert DATA_IDX.shape == (K_BITS,)

# grid index helpers (into the deinterleaved vector, skipping bit 0)
_ROWS = 1 + 15 * np.arange(13)[:, None] + np.arange(15)[None, :]  # (13, 15)
_INDEX = {"rows": _ROWS.reshape(-1), "inter": INTERLEAVE_IDX,
          "deinter": DEINTERLEAVE_IDX, "data": DATA_IDX}


@functools.lru_cache(maxsize=None)
def _idx(name: str, device: torch.device) -> torch.Tensor:
    """An index table as a tensor on `device`, made once per device."""
    return torch.from_numpy(_INDEX[name]).to(device)


def _to_grid(deinter):
    """(..., 196) -> (..., 13, 15) plus the spare R(3) bit."""
    g = deinter[..., _idx("rows", deinter.device)]
    return g.reshape(tuple(deinter.shape[:-1]) + (13, 15))


def _from_grid(grid, r3):
    flat = grid.reshape(tuple(grid.shape[:-2]) + (195,))
    return torch.cat([r3[..., None], flat], dim=-1)


def encode(data_bits, device=None) -> torch.Tensor:
    """(..., 96) payload bits -> (..., 196) interleaved BPTC bits, on the
    input tensor's device (numpy input goes to `device`, None: CUDA)."""
    data_bits = as_bits(data_bits, device)
    lead = tuple(data_bits.shape[:-1])
    dev = data_bits.device
    # rows 0..8: [3 zero pad + 96 data] reshaped to 9 rows x 11 cols
    rows_data = torch.cat(
        [torch.zeros(lead + (3,), dtype=torch.uint8, device=dev), data_bits],
        dim=-1).reshape(lead + (9, 11))
    rows = HAMMING_15_11_2.encode(rows_data)                   # (..., 9, 15)
    cols = HAMMING_13_9.encode(rows.transpose(-1, -2))         # (..., 15, 13)
    grid = cols.transpose(-1, -2)                              # (..., 13, 15)
    deinter = _from_grid(grid, torch.zeros(lead, dtype=torch.uint8,
                                           device=dev))
    # raw[(a*181)%196] = deinter[a]  <=>  raw = deinter[INTERLEAVE_IDX]
    return deinter[..., _idx("inter", dev)]


def decode(raw_bits, rounds: int = 5, device=None):
    """(..., 196) received bits -> ((..., 96) data, (...,) ok), on the
    input tensor's device (numpy input goes to `device`, None: CUDA).

    `rounds` mirrors the reference's bounded repair loop
    (BPTC19696.cpp:141-170, count < 5).
    """
    raw_bits = as_bits(raw_bits, device)
    dev = raw_bits.device
    deinter = raw_bits[..., _idx("deinter", dev)]
    r3 = deinter[..., 0]
    grid = _to_grid(deinter)
    for _ in range(rounds):
        # columns: Hamming(13,9) down each of the 15 columns
        cols, _ = HAMMING_13_9.decode_codeword(grid.transpose(-1, -2))
        grid = cols.transpose(-1, -2)
        # rows: Hamming(15,11) variant 2 across the 9 data rows
        rows, _ = HAMMING_15_11_2.decode_codeword(grid[..., :9, :])
        grid = torch.cat([rows, grid[..., 9:, :]], dim=-2)
    # final parity verdict
    _, ok_c = HAMMING_13_9.decode_codeword(grid.transpose(-1, -2))
    _, ok_r = HAMMING_15_11_2.decode_codeword(grid[..., :9, :])
    ok = torch.all(ok_c, dim=-1) & torch.all(ok_r, dim=-1)
    deinter = _from_grid(grid, r3)
    return deinter[..., _idx("data", dev)], ok
