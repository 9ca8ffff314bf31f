"""DMR stream glue: demod bit stream <-> call layer <-> mod bit stream (port
of qradiolink_tpu/protocols/dmr_stream.py; the block codes behind burst
decoding run on the control layer's device, DmrControl.device, and
build_bs_stream and find_bursts_dmo take a `device` for theirs).

RX (DmrRxStream): consumes hard-bit blocks from chains.dmr.DmrDemod
(9600 bit/s, 2 bits/symbol, 5 samples/symbol at 24 ksps), hunts burst
syncs with the vectorized correlator (protocols.dmr.find_bursts),
decodes the 24-bit CACH preceding each burst on downlink (BS) streams
for the timeslot, advances the DmrTiming stream clock with
sample-accurate per-burst timestamps, and feeds DecodedBursts to
DmrControl — the vectorized equivalent of the reference's bit-serial
gr_dmr_sink (reference src/gr/gr_dmr_sink.cpp:78-133) + DMRControl
addFrames split.

TX (DmrTxStream): turns the call layer's (264,) burst bit-vectors into
a continuous 24 ksps-aligned dibit stream plus a per-sample burst mask
for chains.dmr.DmrMod, launching each burst at the DmrTiming-derived
slot time — the mask-based equivalent of gr_dmr_source's zero padding
plus tx_time burst tags (reference src/gr/gr_dmr_source.cpp:35-149,
gr_zero_idle_bursts.cpp:27-84; SURVEY §2.8 "burst scheduling on host,
sample-accurate gating as masks"). MS bursts occupy the first 660
samples (132 symbols) of their 720-sample slot, leaving the standard
guard time; BS (duplex) streams prepend the 24-bit CACH for a full
720-sample slot.
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.protocols import dmr
from qradiolink_tpu_torch.protocols.dmr import (
    CACH_BITS, FRAME_BITS, cach_decode, cach_encode, decode_burst,
    find_bursts,
)
from qradiolink_tpu_torch.protocols.dmr_control import (
    DmrControl, SAMPLES_PER_SLOT,
)

BITS_PER_SYMBOL = 2
SAMPLES_PER_SYMBOL = 5
# one slot = CACH + burst = 24 + 264 bits = 144 symbols = 720 samples
SLOT_BITS = CACH_BITS + FRAME_BITS
BURST_SAMPLES = (FRAME_BITS // BITS_PER_SYMBOL) * SAMPLES_PER_SYMBOL  # 660


def _bits_to_samples(n_bits: int) -> int:
    return (n_bits // BITS_PER_SYMBOL) * SAMPLES_PER_SYMBOL


class DmrRxStream:
    """Bit-stream front end for DmrControl."""

    def __init__(self, control: DmrControl, downlink: bool = True):
        self.control = control
        self.downlink = bool(downlink)
        self._buf = np.zeros(0, np.uint8)
        self._buf_start = 0          # absolute bit index of _buf[0]
        self._last_burst = -10**9    # absolute start of last emitted burst
        # voice superframe tracking: voice bursts B..F carry an EMB
        # instead of a sync word, so after a voice sync on a slot the
        # next 5 bursts are taken at fixed 2-slot offsets (the
        # reference's RECV_VOICE state, gr_dmr_sink.cpp:113-133):
        # {abs_start_of_next_expected: (slot_no, frames_left)}
        self._expect: dict[int, tuple[int | None, int]] = {}

    def _slot_of(self, start: int) -> int | None:
        """CACH-derived timeslot of the burst at buffer offset start."""
        if not self.downlink or start < CACH_BITS:
            return None
        _at, sn, _lcss, _payload, ok = cach_decode(
            self._buf[start - CACH_BITS:start])
        return sn if ok else None

    def _emit(self, bursts_out, abs_start: int, slot_no):
        start = abs_start - self._buf_start
        decoded = decode_burst(self._buf[start:start + FRAME_BITS],
                               self.control.device)
        # sample-accurate slot timestamp: the burst END, matching the
        # reference's set_slot_times at full-frame reception
        # (gr_dmr_sink.cpp:100-125)
        if slot_no is not None:
            t_ns = self.control.timing._time_base \
                + _bits_to_samples(abs_start + FRAME_BITS) \
                * self.control.timing.time_per_sample
            self.control.timing._slot_times[slot_no - 1] = t_ns
            self.control.timing._last_update[slot_no - 1] = t_ns
            if (not self.control.timing._tx
                    and not self.control.timing.dmo
                    and self.control.timing.on_timing_ready):
                self.control.timing.on_timing_ready(slot_no)
        bursts_out.append((decoded, slot_no))
        self._last_burst = abs_start
        if decoded.kind == "voice_sync":
            self._expect[abs_start + 2 * SLOT_BITS] = (slot_no, 5)
        return decoded

    def push_bits(self, bits) -> int:
        """Feed a block of hard bits; decodes every complete burst found
        (sync hunt + voice-superframe position tracking) and forwards
        them to the control layer. Returns the number of bursts
        processed."""
        import heapq
        bits = np.asarray(bits, np.uint8).ravel()
        self._buf = np.concatenate([self._buf, bits])
        hits = {self._buf_start + s: name
                for s, name in find_bursts(self._buf)}
        # worklist: sync hits + tracked voice expectations, in stream
        # order; expectations registered while processing (superframe
        # chains) are absorbed within the same push
        heap = sorted(set(hits) | set(self._expect))
        heapq.heapify(heap)
        seen = set(heap)
        bursts = []
        while heap:
            abs_start = heapq.heappop(heap)
            start = abs_start - self._buf_start
            expected = self._expect.get(abs_start)
            if start < 0:
                self._expect.pop(abs_start, None)   # unrecoverable
                continue
            if start + FRAME_BITS > len(self._buf):
                continue             # retry next push (expectation kept)
            self._expect.pop(abs_start, None)
            if abs_start in hits:
                if abs_start <= self._last_burst:
                    continue
                self._emit(bursts, abs_start, self._slot_of(start))
            elif expected is not None:
                slot_no, left = expected
                d = self._emit(bursts, abs_start,
                               self._slot_of(start) or slot_no)
                if left > 1 and d.kind != "voice_sync":
                    self._expect[abs_start + 2 * SLOT_BITS] = \
                        (slot_no, left - 1)
            # absorb expectations created by _emit into this pass
            for pos in self._expect:
                if pos not in seen:
                    heapq.heappush(heap, pos)
                    seen.add(pos)
        self.control.add_bursts(bursts)
        # advance the stream clock by the whole block
        self.control.timing.increment_sample_counter(
            _bits_to_samples(len(bits)))
        # keep a tail long enough to re-find a burst straddling the edge
        # and to serve the next tracked voice position
        keep = 3 * SLOT_BITS + FRAME_BITS
        if len(self._buf) > keep:
            drop = len(self._buf) - keep
            self._buf = self._buf[drop:]
            self._buf_start += drop
        return len(bursts)


class DmrTxStream:
    """Slot-aligned burst scheduler for DmrMod."""

    def __init__(self, control: DmrControl, duplex: bool = False,
                 color_code: int | None = None):
        self.control = control
        self.duplex = bool(duplex)
        self.color_code = (control.config.color_code
                           if color_code is None else int(color_code))
        self._abs_sample = 0             # TX stream clock (samples @24k)
        self._queue: list[tuple[int, np.ndarray]] = []  # (launch, bits)

    def _launch_sample(self, t_ns: int) -> int:
        base = self.control.timing._time_base
        s = max(0, (t_ns - base)) // self.control.timing.time_per_sample
        return int(s) // SAMPLES_PER_SYMBOL * SAMPLES_PER_SYMBOL

    def send_bursts(self, bursts, slot_no: int | None = None):
        """Queue bursts at consecutive DmrTiming slot times (or back to
        back from 'now' when timing is not armed)."""
        sn = self.control.config.timeslot if slot_no is None else slot_no
        for b in bursts:
            b = np.asarray(b, np.uint8)
            t = self.control.timing.get_slot_times(sn)
            if t > 0:
                launch = self._launch_sample(t)
            elif self._queue:
                launch = self._queue[-1][0] + 2 * SAMPLES_PER_SLOT
            else:
                launch = (self._abs_sample // SAMPLES_PER_SLOT + 2) \
                    * SAMPLES_PER_SLOT
            if self.duplex:
                cach = cach_encode(1, sn - 1, 0)
                bits = np.concatenate([cach, b])
                launch -= _bits_to_samples(CACH_BITS)
            else:
                bits = b
            self._queue.append((launch, bits))

    def pending(self) -> int:
        return len(self._queue)

    def next_block(self, n_samples: int):
        """Produce (bits, mask) for the next n_samples of TX stream:
        bits is (n_samples//5*2,) dibit-bits (idle zeros outside
        bursts), mask is (n_samples,) float 0/1 burst gating."""
        assert n_samples % SAMPLES_PER_SYMBOL == 0
        n_bits = n_samples // SAMPLES_PER_SYMBOL * BITS_PER_SYMBOL
        bits = np.zeros(n_bits, np.uint8)
        mask = np.zeros(n_samples, np.float32)
        t0 = self._abs_sample
        t1 = t0 + n_samples
        remaining = []
        for launch, b in self._queue:
            span = _bits_to_samples(len(b))
            if launch >= t1:
                remaining.append((launch, b))
                continue
            if launch + span <= t0:
                continue             # missed entirely (shouldn't happen)
            # overlap region in samples
            lo = max(launch, t0)
            hi = min(launch + span, t1)
            mask[lo - t0:hi - t0] = 1.0
            # bit placement
            b_lo = (lo - launch) // SAMPLES_PER_SYMBOL * BITS_PER_SYMBOL
            b_hi = (hi - launch) // SAMPLES_PER_SYMBOL * BITS_PER_SYMBOL
            o_lo = (lo - t0) // SAMPLES_PER_SYMBOL * BITS_PER_SYMBOL
            bits[o_lo:o_lo + (b_hi - b_lo)] = b[b_lo:b_hi]
            if launch + span > t1:
                remaining.append((launch, b))
        self._queue = remaining
        self._abs_sample = t1
        return bits, mask


def build_bs_stream(slot1_bursts, slot2_bursts, lead_idle: int = 0,
                    device=None):
    """Interleave two slots' burst lists into one BS downlink bit
    stream: [CACH | slot1 burst | CACH | slot2 burst | ...]. Shorter
    lists are padded with idle (null-info) bursts, whose block codes run
    on `device` (None: CUDA). Returns (bits,).

    This is the test/bench stand-in for a repeater's continuous
    downlink (the reference receives this shape from an actual BS)."""
    n = max(len(slot1_bursts), len(slot2_bursts))
    idle = dmr.make_data_burst(np.zeros(196, np.uint8), 1, dmr.DT_IDLE,
                               device=device)
    out = []
    for _ in range(lead_idle):
        out.append(np.zeros(SLOT_BITS, np.uint8))
    for i in range(n):
        for sn, lst in ((1, slot1_bursts), (2, slot2_bursts)):
            b = lst[i] if i < len(lst) else idle
            cach = cach_encode(1, sn - 1, 0)
            out.append(np.concatenate([cach, np.asarray(b, np.uint8)]))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# DMO soft-correlation sink (reference src/gr/gr_dmr_dmo_sink.cpp,
# 396 LoC): direct-mode reception correlates the raw RRC-filtered FM
# discriminator (24 ksps float, the chain's "soft" tap) against the
# DMO sync SYMBOL waveforms, then slices the burst with an adaptive
# centre/threshold derived from the sync's min/max — robust to DC
# offset and level error, unlike the hard-bit path.

_DMO_LEVELS = np.array([3.0, 1.0, -1.0, -3.0], np.float32)


def _sync_symbol_values(sync_bits: np.ndarray) -> np.ndarray:
    """48 sync bits -> 24 nominal 4FSK symbol values {+-1, +-3}."""
    b = np.asarray(sync_bits, np.uint8).reshape(24, 2)
    idx = b[:, 0] * 2 + b[:, 1]
    return _DMO_LEVELS[idx]


def find_bursts_dmo(soft: np.ndarray, sps: int = SAMPLES_PER_SYMBOL,
                    syncs: dict | None = None,
                    min_corr_ratio: float = 0.55, device=None):
    """Correlate a 24 ksps soft stream against DMO/MS sync waveforms.

    Returns [(burst_start_sample, DecodedBurst, sync_name)] for each
    detected burst. Correlation is the vectorized form of the
    reference's per-sample symbol-spaced multiply-accumulate
    (gr_dmr_dmo_sink.cpp correlateSync): corr[n] = sum_i v[i] *
    soft[n + i*sps]; a peak is accepted when it exceeds
    min_corr_ratio * (|v| * local RMS) and the adaptively-sliced sync
    matches within the reference's byte-error budget. The burst
    decoder's block codes run on `device` (None: CUDA).
    """
    from qradiolink_tpu_torch.protocols import dmr as _dmr
    soft = np.asarray(soft, np.float32).ravel()
    if syncs is None:
        syncs = {"dmo1_audio": _dmr.SYNC_DMO1_AUDIO,
                 "dmo1_data": _dmr.SYNC_DMO1_DATA,
                 "ms_audio": _dmr.SYNC_MS_AUDIO,
                 "ms_data": _dmr.SYNC_MS_DATA}
    n_sym = 24
    span = (n_sym - 1) * sps + 1
    if soft.size < span:
        return []
    # (offsets, 24) symbol-spaced windows
    win = np.lib.stride_tricks.sliding_window_view(soft, span)[:, ::sps]
    results = []
    hits_mask = np.zeros(soft.size, bool)
    for name, bits in syncs.items():
        v = _sync_symbol_values(bits)
        corr = win @ v
        # normalized against the windowed energy (scale-invariant)
        energy = np.sqrt((win ** 2).sum(-1) * (v ** 2).sum()) + 1e-9
        score = corr / energy
        cand = np.nonzero(score > min_corr_ratio)[0]
        for pos in cand:
            # local maximum within +-sps
            lo, hi = max(0, pos - sps), min(len(score), pos + sps + 1)
            if score[pos] < score[lo:hi].max():
                continue
            # sync starts at symbol 54 of the burst
            burst_start = int(pos) - 54 * sps
            if burst_start < 0 or \
                    burst_start + 132 * sps > soft.size:
                continue
            if hits_mask[pos]:
                continue
            # adaptive slicer from the sync window (reference
            # centre/threshold computation)
            sync_samples = win[pos]
            centre = (sync_samples.max() + sync_samples.min()) / 2.0
            threshold = (sync_samples.max() - centre) / 2.0
            syms = soft[burst_start: burst_start + 132 * sps: sps]
            b_hi = (syms < centre).astype(np.uint8)
            b_lo = (np.abs(syms - centre) > threshold).astype(np.uint8)
            burst_bits = np.stack([b_hi, b_lo], -1).reshape(-1)
            decoded = decode_burst(burst_bits, device)
            if decoded.kind == "unknown":
                continue
            hits_mask[max(0, pos - 60 * sps):pos + 60 * sps] = True
            results.append((burst_start, decoded, name))
    results.sort(key=lambda r: r[0])
    return results
