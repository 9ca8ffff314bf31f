"""Block RSSI estimate (port of rssi_dbm in qradiolink_tpu/ops/spectrum.py).
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import IqPair


def rssi_dbm(x, cal_offset_db: float = 0.0) -> torch.Tensor:
    """Mean power of the block in dB(m), over the last axis. Accepts complex
    tensors or IqPair."""
    if isinstance(x, IqPair):
        p = torch.mean(x.re * x.re + x.im * x.im, dim=-1)
    else:
        p = torch.mean(x.real ** 2 + x.imag ** 2, dim=-1)
    return 10.0 * torch.log10(p + 1e-20) + cal_offset_db
