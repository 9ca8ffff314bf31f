"""Shared pieces of the digital chains (port of bytes_to_bits,
bits_to_bytes, pack_dibits and RxFecTailFF in
qradiolink_tpu/chains/digital_common.py).

RX tail: soft bits in [0, 255] -> tiled Viterbi (CCSDS K=7 r=1/2) ->
descrambler (0x8A/0x7F/7) -> bits.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.fec.conv import CCSDS_K7
from qradiolink_tpu_torch.fec.conv_ff import TiledViterbi
from qradiolink_tpu_torch.fec.scrambler import Descrambler


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes (..., N) -> bits (..., 8N), MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(tuple(data.shape[:-1]) + (data.shape[-1] * 8,))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., 8N) -> uint8 bytes (..., N), MSB first."""
    b = bits.reshape(tuple(bits.shape[:-1]) + (bits.shape[-1] // 8, 8)).long()
    weights = 1 << torch.arange(7, -1, -1, device=bits.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def pack_dibits(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., 2N) -> dibit values (..., N) int32, first bit is MSB."""
    b = bits.reshape(tuple(bits.shape[:-1])
                     + (bits.shape[-1] // 2, 2)).to(torch.int32)
    return b[..., 0] * 2 + b[..., 1]


class RxFecTailFF(Block):
    """Block-parallel RX FEC tail: tiled Viterbi + feedforward descrambler.
    Soft (..., 2T) in [0, 255] -> bits (..., T) uint8 for this block's
    symbols, the `overlap` symbols of decode delay absorbed in the tiles."""

    def __init__(self, chunk: int = 128, overlap: int = 32,
                 lead_shape: tuple = (), device=None):
        device = resolve_device(device)
        self.viterbi = TiledViterbi(CCSDS_K7, chunk=chunk, overlap=overlap,
                                    lead_shape=lead_shape, device=device)
        self.descrambler = Descrambler(lead_shape=lead_shape, device=device)

    def init_state(self):
        return (self.viterbi.init_state(), self.descrambler.init_state())

    def __call__(self, state, soft):
        vstate, dstate = state
        pairs = soft.reshape(tuple(soft.shape[:-1])
                             + (soft.shape[-1] // 2, 2))
        vstate, bits = self.viterbi(vstate, pairs)
        dstate, out = self.descrambler(dstate, bits)
        return (vstate, dstate), out
