"""Shared pieces of the digital chains (port of
qradiolink_tpu/chains/digital_common.py).

TX head: bits -> multiplicative scrambler (0x8A/0x7F/7) -> CCSDS K=7 r=1/2
conv encode. RX tails: soft bits in [0, 255] -> Viterbi (streaming, or
tiled for the feedforward chains) -> descrambler -> bits.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.fec.conv import (CCSDS_K7, StreamingViterbi,
                                          encode_after)
from qradiolink_tpu_torch.fec.conv_ff import TiledViterbi
from qradiolink_tpu_torch.fec.scrambler import UINT32, Descrambler, Scrambler


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


class TxFecHead(Block):
    """bits -> scramble -> conv encode (coded bits, 2 per input bit).
    State: (the scrambler's register, the encoder's register: the last
    K-1 scrambled bits, the newest at bit 0), both uint32."""

    def __init__(self, lead_shape: tuple = (), device=None):
        self.device = resolve_device(device)
        self.scrambler = Scrambler(lead_shape=lead_shape, device=self.device)
        self.code = CCSDS_K7
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return (self.scrambler.init_state(),
                torch.zeros(self.lead_shape, dtype=UINT32,
                            device=self.device))

    def __call__(self, state, bits):
        sstate, enc_reg = state
        sstate, sbits = self.scrambler(sstate, bits)
        K = self.code.K
        coded = _conv_encode_with_reg(self.code, sbits, enc_reg)
        rev = torch.flip(sbits[..., -(K - 1):].to(torch.int64), dims=(-1,))
        w = 1 << torch.arange(K - 1, device=bits.device)
        new_reg = (rev * w).sum(-1).to(UINT32)
        return (sstate, new_reg), coded


def _conv_encode_with_reg(code, bits, reg):
    """conv_encode from a per-stream register (...) uint32: the K-1
    previous bits, the newest at bit 0."""
    idx = torch.arange(code.K - 1, device=bits.device)
    hist = ((reg.to(torch.int64)[..., None] >> idx) & 1).to(bits.dtype)
    return encode_after(code, bits, torch.flip(hist, dims=(-1,)))


class RxFecTail(Block):
    """Soft coded values (..., 2T) in [0, 255] -> decoded, descrambled bits
    (..., T), through the streaming Viterbi (`viterbi_stream_k7` on CUDA)
    and the descrambler."""

    def __init__(self, lag: int = 64, lead_shape: tuple = (), device=None):
        device = resolve_device(device)
        self.viterbi = StreamingViterbi(CCSDS_K7, lag=lag,
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
