"""Tiled (block-parallel) Viterbi decoder (port of
qradiolink_tpu/fec/conv_ff.py).

The stream is cut into C chunks of L symbols, each extended W symbols left
and right (W >= 5K is the usual truncation depth); every chunk runs
add-compare-select from uniform metrics and traces back from its right
edge, and only the middle L decisions are kept. All chunks of all channels
decode in parallel, as tile rows of one `decode_windows` call (the
`viterbi_tiled_k7` kernel on CUDA, fec/viterbi_cuda.py).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.fec.conv import CCSDS_K7, ConvCode
from qradiolink_tpu_torch.fec.viterbi_cuda import decode_windows


def _overlap_windows(x: torch.Tensor, L: int, W: int) -> torch.Tensor:
    """(..., T, n) -> (..., C, W+L+W, n) overlapped chunk windows; T must be
    a multiple of L, and warm-up samples outside the stream are 128."""
    if L < W:
        raise ValueError("chunk length must be >= overlap")
    lead = tuple(x.shape[:-2])
    n = x.shape[-1]
    pad = torch.full(lead + (W, n), 128.0, dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x, pad], dim=-2)
    # window c covers padded [c*L, c*L + L + 2W): x[c*L - W, (c+1)*L + W)
    win = xp.unfold(-2, L + 2 * W, L)           # (..., C, n, W+L+W)
    return win.transpose(-1, -2)


def viterbi_decode_tiled(code: ConvCode, soft: torch.Tensor,
                         chunk: int = 128, overlap: int = 32) -> torch.Tensor:
    """soft: (..., T, n) in [0,255] -> bits (..., T) uint8. T must be a
    multiple of `chunk`."""
    L, W = int(chunk), int(overlap)
    lead = tuple(soft.shape[:-2])
    T = soft.shape[-2]
    if T % L:
        raise ValueError(f"{T} symbols not a multiple of chunk {L}")
    win = _overlap_windows(soft.float(), L, W)
    C = T // L
    steps = W + L + W
    R = C
    for d in lead:
        R *= d
    bits = decode_windows(code, win.reshape(R, steps, code.n).contiguous(),
                          keep_from=W)                 # (R, L + W)
    return bits[:, :L].reshape(lead + (T,))


class TiledViterbi(Block):
    """Streaming wrapper: carries W trailing soft pairs so consecutive blocks
    decode as one long stream (up to tile truncation).

    The chunk is 128 on every device, the length the JAX package uses off
    the TPU, so the port decodes the same tiles as the CPU reference."""

    def __init__(self, code: ConvCode = None, chunk: int = 128,
                 overlap: int = 32, lead_shape: tuple = (), device=None):
        self.code = code or CCSDS_K7
        self.chunk = int(chunk)
        self.overlap = int(overlap)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.full(self.lead_shape + (self.overlap, self.code.n),
                          128.0, dtype=torch.float32, device=self.device)

    def __call__(self, state, soft):
        """soft (..., T, n) -> bits (..., T): this block's decisions, each
        decoded with `overlap` symbols of left context from the previous
        block."""
        W = self.overlap
        T = soft.shape[-2]
        parts = [state, soft.float()]
        pad = (-(T + W)) % self.chunk
        if pad:
            parts.append(torch.full(tuple(soft.shape[:-2])
                                    + (pad, self.code.n), 128.0,
                                    dtype=torch.float32, device=soft.device))
        x = torch.cat(parts, dim=-2)
        bits = viterbi_decode_tiled(self.code, x, self.chunk, W)
        new_tail = x[..., T: W + T, :]
        return new_tail, bits[..., W: W + T]
