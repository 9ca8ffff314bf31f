"""Hard and soft decision slicers and the 4FSK filter-bank discriminator
(port of qradiolink_tpu/sync/slicer.py).

binary_slicer: gr::digital::binary_slicer_fb. Fsk4Discriminator: the
reference's gr_4fsk_discriminator (src/gr/gr_4fsk_discriminator.cpp:10-44),
the argmax over 4 band magnitudes mapped to a QPSK-like point.
fsk4_slice_soft and psk_soft_bits: symbols -> soft bits in [0, 255], the
x128+128 convention of the reference's FEC tail.
"""

from __future__ import annotations

import numpy as np
import torch

from qradiolink_tpu_torch.core import resolve_device


def binary_slicer(x: torch.Tensor) -> torch.Tensor:
    """float -> {0,1} bits: 1 when x >= 0."""
    return (x >= 0).to(torch.uint8)


# band index (ascending tone frequency) -> point, the reference's in1..in4
# branch order and literal constants (gr_4fsk_discriminator.cpp:30-38)
_FSK4_POINTS = np.array(
    [-0.707107 - 0.707107j, -0.707107 + 0.707107j,
     0.707107 + 0.707107j, 0.707107 - 0.707107j], dtype=np.complex64)


class Fsk4Discriminator:
    """(..., 4, T) branch magnitudes -> (..., T) complex64 points. A branch
    wins only when strictly greater than the others; ties give 0+0j, as
    the reference's if/else-if chain does."""

    def __init__(self, device=None):
        self.points = torch.from_numpy(_FSK4_POINTS).to(
            resolve_device(device))

    def __call__(self, mags: torch.Tensor) -> torch.Tensor:
        maxv = torch.amax(mags, dim=-2, keepdim=True)
        strict = (mags == maxv).sum(dim=-2) == 1
        idx = torch.argmax(mags, dim=-2)
        return torch.where(strict, self.points[idx],
                           torch.zeros((), dtype=torch.complex64,
                                       device=mags.device))


def fsk4_slice_soft(sym: torch.Tensor, levels=(-1.5, -0.5, 0.5, 1.5)):
    """4-level symbols -> 2 soft bytes a symbol (MSB-first dibits): the
    high bit from the sign, the low bit from |sym| against 1."""
    hi = torch.clamp(sym / 1.5, -1.0, 1.0)
    lo = torch.clamp(torch.abs(sym) - 1.0, -1.0, 1.0)
    soft = torch.stack([hi, lo], dim=-1).reshape(
        tuple(sym.shape[:-1]) + (-1,))
    return torch.clamp(soft * 128.0 + 128.0, 0.0, 255.0)


def psk_soft_bits(y: torch.Tensor, scale: float = 128.0) -> torch.Tensor:
    """Complex symbols -> interleaved I/Q soft bytes in [0, 255]."""
    soft = torch.stack([y.real, y.imag], dim=-1).reshape(
        tuple(y.shape[:-1]) + (-1,))
    return torch.clamp(soft * scale + 128.0, 0.0, 255.0)
