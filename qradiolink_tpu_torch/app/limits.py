"""TX band-limit check (reference src/limits.cpp:19-94; a copy of
qradiolink_tpu/app/limits.py).

IARU region 1 / CEPT amateur allocation: TX is permitted only when the
carrier center falls inside one of these bands (the reference notes it
checks the carrier only, not the occupied bandwidth). The LimeRFE band
table is retained for API parity even though the RFE hardware itself
is out of scope.
"""

from __future__ import annotations

ALLOCATION_NAME = "IARU region 1 / CEPT allocation"

# (low, high) Hz, exclusive bounds like the reference's > / < checks
TX_LIMITS = (
    (1_810_000, 2_000_000),
    (3_500_000, 3_800_000),
    (7_000_000, 7_200_000),
    (10_100_000, 10_150_000),
    (14_000_000, 14_350_000),
    (18_068_000, 18_168_000),
    (21_000_000, 21_450_000),
    (24_890_000, 24_990_000),
    (28_000_000, 29_700_000),
    (50_000_000, 52_000_000),
    (70_000_000, 70_300_000),
    (144_000_000, 146_000_000),
    (430_000_000, 440_000_000),
    (1_240_000_000, 1_300_000_000),
    (2_300_000_000, 2_450_000_000),
    (3_400_000_000, 3_410_000_000),
    (5_660_000_000, 5_670_000_000),
    (5_725_000_000, 5_850_000_000),
    (10_000_000_000, 10_300_000_000),
)

# LimeRFE band windows (limits.cpp:49-58)
RFE_LIMITS = (
    (0, 45_000_000), (45_000_000, 80_000_000),
    (136_000_000, 155_000_000), (200_000_000, 250_000_000),
    (390_000_000, 500_000_000), (900_000_000, 930_000_000),
    (1_200_000_000, 1_500_000_000), (2_200_000_000, 2_500_000_000),
    (3_200_000_000, 3_500_000_000),
)


def check_limit(tx_freq_hz: int) -> bool:
    """True when TX at this carrier frequency is inside an amateur
    band (reference Limits::checkLimit)."""
    return any(lo < tx_freq_hz < hi for lo, hi in TX_LIMITS)


def get_rfe_band(freq_hz: int) -> int:
    """LimeRFE band index for a frequency, -1 outside all windows
    (reference Limits::getRFEBand)."""
    for i, (lo, hi) in enumerate(RFE_LIMITS):
        if lo <= freq_hz <= hi:
            return i
    return -1
