"""TDMA slot clock + burst gating masks (port of
qradiolink_tpu/framing/tdma.py; numpy, host-side).

Equivalent of reference src/bursttimer.{h,cpp}: a nanosecond timebase
derived from RX sample counters (set by rx_time tags in the reference,
by block sample counts here), per-channel 30 ms / 720-sample slot
bookkeeping (2 slots per DMR frame), slot allocation for timed TX
bursts, and the zero-idle gating decision.

Host/device split (SURVEY §2.8 "TDMA time-slot interleave"): this clock
is pure host logic; the device kernels stay timing-free and consume the
per-sample masks produced by `slot_mask`, mirroring
gr_zero_idle_bursts + the tx_time tag machinery
(gr_mmdvm_source.cpp:117-130).
"""

from __future__ import annotations

import numpy as np

# reference constants (bursttimer.h:27-41), 24 ksps baseband
BURST_DELAY_NS = 100_000_000
SLOT_TIME_NS = 30_000_000
SAMPLES_PER_SLOT = 720
TIME_PER_SAMPLE_NS = 41_667
NUMBER_OF_SLOTS = 2
MAX_MMDVM_CHANNELS = 7


class BurstTimer:
    """Per-channel nanosecond slot clock driven by sample counts."""

    def __init__(self, num_channels: int = MAX_MMDVM_CHANNELS,
                 burst_delay_ns: int = BURST_DELAY_NS,
                 samples_per_slot: int = SAMPLES_PER_SLOT,
                 time_per_sample_ns: int = TIME_PER_SAMPLE_NS,
                 slot_time_ns: int = SLOT_TIME_NS):
        self.C = int(num_channels)
        self.burst_delay = int(burst_delay_ns)
        self.samples_per_slot = int(samples_per_slot)
        self.time_per_sample = int(time_per_sample_ns)
        self.slot_time = int(slot_time_ns)
        self.enabled = True
        self._time_base = [0] * self.C
        self._sample_counter = [0] * self.C
        self._initialized = [False] * self.C
        self._last_slot = [0] * self.C
        # pending TX slots: per channel list of [slot_no, slot_time_ns,
        # samples_emitted]
        self._slots: list[list] = [[] for _ in range(self.C)]

    # -- timebase -----------------------------------------------------------
    def set_timer(self, time_ns: int, chan: int = 0):
        """RX time reference received (reference set_timer:174-182)."""
        self._time_base[chan] = int(time_ns)
        self._sample_counter[chan] = 0
        self._initialized[chan] = True

    def reset_timer(self, chan: int = 0):
        self._time_base[chan] = 0
        self._sample_counter[chan] = 0

    def increment(self, chan: int = 0, n: int = 1):
        self._sample_counter[chan] += int(n)

    def time_delta(self, chan: int = 0) -> int:
        """Current stream time (reference get_time_delta:156-163)."""
        return self._time_base[chan] + \
            self._sample_counter[chan] * self.time_per_sample

    def timing_initialized(self, chan: int = 0) -> bool:
        return self._initialized[chan]

    # -- TX slot allocation --------------------------------------------------
    def allocate_slot(self, slot_no: int, chan: int = 0) -> int:
        """Reserve the next TDMA slot for TX; returns its absolute start
        time in ns (reference allocate_slot:240-271: next 30 ms grid
        point + 100 ms burst delay)."""
        if not self.enabled:
            return 0
        elapsed = self.time_delta(chan)
        last = self._last_slot[chan]
        if elapsed <= last:
            self._last_slot[chan] = last + self.slot_time
        elif last == 0 or (elapsed - last) >= self.slot_time:
            self._last_slot[chan] = elapsed
        else:
            self._last_slot[chan] = last + self.slot_time
        t = self._last_slot[chan] + self.burst_delay
        self._slots[chan].append([int(slot_no), t, 0])
        return t

    def check_time(self, chan: int = 0) -> int:
        """Advance one sample; returns the slot number when a reserved
        slot's start time is crossed, else 0 (reference
        check_time:204-238)."""
        self.increment(chan)
        if not self._slots[chan]:
            return 0
        s = self._slots[chan][0]
        sample_time = self.time_delta(chan)
        if sample_time >= s[1]:
            if s[2] == 0:
                s[2] = 1
                return s[0]
            s[2] += 1
            if s[2] >= self.samples_per_slot:
                self._slots[chan].pop(0)
        return 0

    # -- vectorized mask production -------------------------------------------
    def tx_mask(self, n_samples: int, chan: int = 0) -> np.ndarray:
        """(n_samples,) float mask for the next n baseband samples:
        1 inside reserved slots, 0 elsewhere — the whole-block
        vectorization of check_time for the zero-idle TX path."""
        t0 = self.time_delta(chan)
        t = t0 + np.arange(1, n_samples + 1, dtype=np.int64) \
            * self.time_per_sample
        mask = np.zeros(n_samples, np.float32)
        span = self.samples_per_slot * self.time_per_sample
        for slot_no, st, _ in self._slots[chan]:
            mask[(t >= st) & (t < st + span)] = 1.0
        self.increment(chan, n_samples)
        # drop fully elapsed slots
        t_end = self.time_delta(chan)
        self._slots[chan] = [s for s in self._slots[chan]
                             if s[1] + span > t_end]
        return mask


def slot_mask(n_samples: int, active_slot: int, first_slot: int = 1,
              samples_per_slot: int = SAMPLES_PER_SLOT,
              phase: int = 0) -> np.ndarray:
    """Free-running 2-slot TDMA mask: 1 where `active_slot` (1|2) owns
    the sample. `phase` is the sample offset of the slot grid."""
    idx = (np.arange(n_samples, dtype=np.int64) + int(phase)) \
        // int(samples_per_slot)
    slot = (idx % NUMBER_OF_SLOTS) + first_slot
    return (slot == active_slot).astype(np.float32)
