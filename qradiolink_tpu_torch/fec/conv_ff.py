"""Tiled (block-parallel) Viterbi decoder (port of
qradiolink_tpu/fec/conv_ff.py).

The stream is cut into C chunks of L symbols, each extended W symbols left
and right (W >= 5K is the usual truncation depth); every chunk runs
add-compare-select from uniform metrics and traces back from its right
edge, and only the middle L decisions are kept. All chunks of all channels
decode in parallel. `viterbi_decode_tiled` builds the windows and decodes
them as tile rows of one `decode_windows` call (the `viterbi_tiled_k7`
kernel on CUDA); `TiledViterbi` decodes each streamed block through
`decode_stream`, whose kernel `viterbi_bfly_k7` reads the windows in place
(fec/viterbi_cuda.py).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device
from qradiolink_tpu_torch.fec.conv import CCSDS_K7, ConvCode
from qradiolink_tpu_torch.fec.viterbi_cuda import decode_stream, decode_tiled


def viterbi_decode_tiled(code: ConvCode, soft: torch.Tensor,
                         chunk: int = 128, overlap: int = 32) -> torch.Tensor:
    """soft: (..., T, n) in [0,255] -> bits (..., T) uint8. T must be a
    multiple of `chunk`."""
    return decode_tiled(code, soft, int(chunk), int(overlap))


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
        return decode_stream(self.code, state, soft.float(), self.chunk,
                             self.overlap)
