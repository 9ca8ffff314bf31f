"""DMR Tier II call layer: RX/TX session state machines + slot timing (port
of qradiolink_tpu/protocols/dmr_control.py).

Host-side re-derivation of the reference's call control (reference
src/DMR/dmrcontrol.cpp:1-665, src/DMR/dmrtiming.cpp:1-140,
src/gr_modem.cpp:650-800 TX drive): the sample-rate DSP runs on the card
(chains/dmr.py), burst en/decode is numpy around the port's torch block
codes (protocols/dmr.py, fec/ambe.py), and this module runs the
50-bursts-per-second-per-slot session logic. The one change from the JAX
module: DmrControl carries a `device` for those block codes (None: CUDA,
see core.resolve_device; the controller passes its own) and hands it to
every burst builder, decoder and assembler it calls.

RX (DmrControl.add_bursts):
  IDLE -> LATE_ENTRY on a voice sync or a reassembled embedded LC
  IDLE -> AUDIO on a voice LC header (src/dst/FLCO captured)
  AUDIO/LATE_ENTRY: voice payloads emitted (AMBE FEC regenerated when
  the AMBE vocoder is in use, dmrcontrol.cpp:231-234), embedded LC
  reassembled for late entry, talker alias and GPS decoded from the
  TA/GPS FLCOs, terminator returns to IDLE.

TX (reference sequence, gr_modem.cpp:656-683,747-800):
  start -> BSDWNACT CSBK x3 (repeater wake-up) unless RX slot timing is
  recent -> on timing_ready: voice LC header x2 + init -> per 3 encoded
  9-byte frames one voice burst (FN 0..5; frame A carries voice sync,
  B..E the embedded LC fragments; superframes rotate the embedded LC
  through the talker alias blocks) -> stop -> terminator.

DmrTiming mirrors src/DMR/dmrtiming.cpp: RX-burst arrival times define
the slot grid; the first TX burst goes out 3 slot periods + CACH
compensation after the last RX slot boundary, subsequent bursts every
2 slots (the other slot belongs to the second TDMA channel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from qradiolink_tpu_torch.core import resolve_device
from qradiolink_tpu_torch.fec import ambe
from qradiolink_tpu_torch.protocols import dmr
from qradiolink_tpu_torch.protocols.dmr import (
    Csbk, DecodedBurst, EmbeddedLCAssembler, LinkControl,
    TalkerAliasAssembler, DT_CSBK, DT_TERMINATOR_WITH_LC,
    DT_VOICE_LC_HEADER, FLCO_GPS_INFO, FLCO_GROUP, FLCO_USER_USER,
    FLCO_TALKER_ALIAS_HEADER, FLCO_TALKER_ALIAS_BLOCK3,
    bs_downlink_activate, make_csbk_burst, make_lc_burst,
    make_voice_burst, talker_alias_tx_lcs, embedded_lc_encode,
    SYNC_MS_AUDIO, SYNC_MS_DATA,
)

# receiver / transmitter states (dmrcontrol.h:36-54)
RX_IDLE, RX_LATE_ENTRY, RX_AUDIO, RX_DATA = 0, 1, 2, 3
TX_IDLE, TX_ACTIVE, TX_ENDING = 0, 1, 2

# modes (dmrcontrol.h:56-64)
MODE_REPEATER, MODE_DMO, MODE_TRUNKED = 0, 1, 2
GROUP_CALL, PRIVATE_CALL = 0, 1

# timing constants (reference src/DMR/constants.h, bursttimer.h:27-41)
SLOT_TIME_NS = 30_000_000
TIME_PER_SAMPLE_NS = 41_667
SAMPLES_PER_SLOT = 720
CACH_LENGTH_BITS = 24
SYMBOL_LENGTH_SAMPLES = 5


def extract_gps(raw9) -> tuple[float, float, str]:
    """9 raw LC bytes of an FLCO_GPS_INFO embedded LC -> (lon, lat,
    error class) (reference src/MMDVM/Utils.cpp extractGPSPosition)."""
    d = np.asarray(raw9, np.uint8).astype(np.int64)
    errs = ["< 2m", "< 20m", "< 200m", "< 2km", "< 20km", "< 200km",
            "> 200km", "not known"]
    error = errs[int((d[2] & 0x0E) >> 1)]
    lon_i = (int(d[2] & 0x01) << 31) | (int(d[3]) << 23) \
        | (int(d[4]) << 15) | (int(d[5]) << 7)
    if lon_i >= 1 << 31:                    # sign extend int32
        lon_i -= 1 << 32
    lon_i >>= 7                             # arithmetic shift
    lat_i = (int(d[6]) << 24) | (int(d[7]) << 16) | (int(d[8]) << 8)
    if lat_i >= 1 << 31:
        lat_i -= 1 << 32
    lat_i >>= 8
    return (float(lon_i) * 360.0 / 2**25, float(lat_i) * 180.0 / 2**24,
            error)


class DmrTiming:
    """RX-derived TDMA slot clock (reference src/DMR/dmrtiming.cpp).

    Stream time is time_base + samples * time_per_sample (ns). The RX
    path records each observed burst's slot boundary via
    set_slot_times(sn); the TX path, once armed with set_tx_time(True),
    gets burst launch times on the RX grid: first = slot time + 3 slot
    periods + CACH filter compensation + correction, then +2 slots per
    burst (dmrtiming.cpp:100-125)."""

    def __init__(self, timeslot: int = 1, dmo: bool = False,
                 timing_correction_samples: int = 0,
                 samples_per_slot: int = SAMPLES_PER_SLOT,
                 time_per_sample: int = TIME_PER_SAMPLE_NS,
                 slot_time: int = SLOT_TIME_NS):
        self.timeslot = int(timeslot)
        self.dmo = bool(dmo)
        self.correction = int(timing_correction_samples)
        self.samples_per_slot = int(samples_per_slot)
        self.time_per_sample = int(time_per_sample)
        self.slot_time = int(slot_time)
        self._time_base = 0
        self._sample_counter = 0
        self._slot_times = [0, 0]
        self._last_update = [-10**18, -10**18]
        self._next_tx_time = 0
        self._tx = False
        self._first = False
        self.on_timing_ready: Callable[[int], None] | None = None

    # -- stream clock -------------------------------------------------------
    def set_timer(self, value_ns: int):
        self._sample_counter = 0
        self._time_base = int(value_ns)

    def reset_timer(self):
        self._sample_counter = 0
        self._time_base = 0

    def increment_sample_counter(self, n: int):
        self._sample_counter += int(n)

    def stream_time(self) -> int:
        return self._time_base + self._sample_counter * self.time_per_sample

    # -- RX side ------------------------------------------------------------
    def set_slot_times(self, sn: int):
        """Record 'now' as the grid reference for slot sn (1|2)."""
        self._slot_times[sn - 1] = self.stream_time()
        self._last_update[sn - 1] = self.stream_time()
        if not self._tx and not self.dmo and self.on_timing_ready:
            self.on_timing_ready(sn)

    def timing_recent(self, sn: int) -> bool:
        """True if slot timing was updated within 12 slot periods of
        stream time (dmrtiming.cpp:85-98 uses wall clock for the same
        purpose; stream time is the deterministic equivalent)."""
        return (self.stream_time() - self._last_update[sn - 1]
                < 12 * self.slot_time)

    # -- TX side ------------------------------------------------------------
    def set_tx_time(self, value: bool):
        self._tx = value
        self._first = value

    def get_tx_time(self) -> bool:
        return self._tx

    def get_slot_times(self, sn: int) -> int:
        """Next burst launch time (ns) on the RX-derived grid; 0 resets
        (dmrtiming.cpp:100-125)."""
        if not self._tx or sn == 0:
            self._tx = False
            self._first = False
            return 0
        if self._first:
            self._next_tx_time = (
                self._slot_times[sn - 1] + 3 * self.slot_time
                + (CACH_LENGTH_BITS // 2) * SYMBOL_LENGTH_SAMPLES
                * self.time_per_sample
                + self.correction * self.time_per_sample)
            self._first = False
        else:
            self._next_tx_time += 2 * self.slot_time
        return self._next_tx_time


@dataclass
class DmrConfig:
    """The DMR-relevant settings subset (reference src/settings.h)."""
    color_code: int = 1
    timeslot: int = 1
    source_id: int = 1234567
    destination_id: int = 91
    call_type: int = GROUP_CALL
    mode: int = MODE_REPEATER
    talker_alias: str = ""
    promiscuous: bool = False
    vocoder: bool = False          # True: AMBE plugin (voice FEC applied)


@dataclass
class CallInfo:
    src_id: int = 0
    dst_id: int = 0
    flco: int = FLCO_GROUP
    fid: int = 0
    slot: int = 0


class DmrControl:
    """DMR call state machines (reference src/DMR/dmrcontrol.cpp).

    RX events are delivered through optional callbacks:
      on_digital_audio(bytes27)   — one burst's 216 voice bits packed
      on_header(CallInfo)         — voice/data call start
      on_terminator(CallInfo)     — call end
      on_talker_alias(str), on_gps((lon, lat, err)), on_csbk(Csbk)
    """

    def __init__(self, config: DmrConfig | None = None,
                 timing: DmrTiming | None = None, device=None):
        self.config = config or DmrConfig()
        self.device = resolve_device(device)
        self.timing = timing or DmrTiming(
            timeslot=self.config.timeslot,
            dmo=self.config.mode == MODE_DMO)
        self.timing.on_timing_ready = self._timing_ready

        self.rx_state = RX_IDLE
        self.tx_state = TX_IDLE
        self._rx_call = CallInfo()
        self._color_code_rx = 0
        self._timeslot_rx = 0
        self._emb_rx = EmbeddedLCAssembler(self.device)
        self._ta_rx = TalkerAliasAssembler()

        self._fn_tx = 0
        self._superframe_tx = 0
        self._tx_audio: list[np.ndarray] = []   # 9-byte encoded frames
        self._tx_lc = self._make_tx_lc()
        self._emb_frags_tx = self._fragments_for_superframe(0)
        self._tx_header_pending = False

        from qradiolink_tpu_torch.protocols.dmr_data import DmrMessageHandler
        self._data_handler = DmrMessageHandler()

        # callbacks
        self.on_digital_audio: Callable | None = None
        self.on_header: Callable | None = None
        self.on_terminator: Callable | None = None
        self.on_talker_alias: Callable | None = None
        self.on_gps: Callable | None = None
        self.on_csbk: Callable | None = None
        self.on_data_message: Callable | None = None

    # ------------------------------------------------------------------ TX
    def _make_tx_lc(self) -> LinkControl:
        flco = FLCO_GROUP if self.config.call_type == GROUP_CALL \
            else FLCO_USER_USER
        lc = LinkControl(flco=flco, src_id=self.config.source_id,
                         dst_id=self.config.destination_id)
        if not self.config.vocoder:
            lc.fid = 0xC2           # Codec2 voice marker (dmrcontrol.cpp:32)
        return lc

    def _fragments_for_superframe(self, sf: int) -> np.ndarray:
        """Embedded-LC fragments for TX superframe sf: 0 carries the
        call LC, 1..4 rotate through the talker alias blocks
        (dmrcontrol.cpp:177-220)."""
        if sf == 0 or not self.config.talker_alias:
            lc = self._tx_lc
        else:
            lc = talker_alias_tx_lcs(self.config.talker_alias)[sf - 1]
        return embedded_lc_encode(lc.to_bytes(), self.device)

    def start_transmission(self) -> list[np.ndarray]:
        """PTT press (gr_modem.cpp startTransmission DMR branch).
        Returns bursts to send immediately (CSBK wake-up x3 in repeater
        mode when timing is stale; header directly in DMO)."""
        self.timing.set_tx_time(False)
        self._tx_header_pending = True
        if self.config.mode == MODE_DMO:
            self.timing.set_slot_times(self.config.timeslot)
            return self._voice_header_bursts()
        if self.timing.timing_recent(self.config.timeslot):
            # timing_ready fires on the next RX burst; skip the CSBK
            return []
        csbk = bs_downlink_activate(self.config.source_id,
                                    self.config.destination_id)
        burst = make_csbk_burst(csbk, self.config.color_code,
                                sync=SYNC_MS_DATA, device=self.device)
        return [burst] * 3          # dmrcontrol.cpp getStartCSBK x3

    def _timing_ready(self, sn: int):
        if sn != self.config.timeslot or not self._tx_header_pending:
            return
        self._pending_header = self._voice_header_bursts()

    def _voice_header_bursts(self) -> list[np.ndarray]:
        """Voice LC header x2 + TX init (gr_modem.cpp:747-763)."""
        self._tx_header_pending = False
        self.timing.set_tx_time(True)
        self._tx_lc = self._make_tx_lc()
        self._emb_frags_tx = self._fragments_for_superframe(0)
        burst = make_lc_burst(self._tx_lc, self.config.color_code,
                              DT_VOICE_LC_HEADER, sync=SYNC_MS_DATA,
                              device=self.device)
        self.init_voice_tx()
        return [burst, burst]

    def poll_header(self) -> list[np.ndarray]:
        """Fetch header bursts produced by a timing_ready event."""
        out = getattr(self, "_pending_header", None)
        self._pending_header = None
        return out or []

    def init_voice_tx(self):
        self._fn_tx = 0
        self._superframe_tx = 0
        self.tx_state = TX_ACTIVE

    def stop_voice_tx(self):
        if self.tx_state == TX_ACTIVE:
            self.tx_state = TX_ENDING

    @property
    def transmitting(self) -> bool:
        return self.tx_state != TX_IDLE

    def add_tx_audio(self, encoded9: bytes | np.ndarray) -> int:
        """Queue one 9-byte encoded voice frame; returns queue depth
        (dmrcontrol.cpp addTxAudio)."""
        self._tx_audio.append(np.frombuffer(bytes(encoded9), np.uint8).copy())
        return len(self._tx_audio)

    def clear_tx_audio(self):
        self._tx_audio.clear()

    def get_tx_bursts(self) -> list[np.ndarray]:
        """Drain queued audio into voice bursts; appends the terminator
        when ending (gr_modem.cpp transmitDMR + dmrcontrol.cpp
        getTxAudio). Each burst is (264,) bits."""
        out = []
        while True:
            if self.tx_state == TX_ENDING and self._fn_tx == 0:
                lc = LinkControl(flco=self._tx_lc.flco,
                                 fid=self._tx_lc.fid,
                                 src_id=self.config.source_id,
                                 dst_id=self.config.destination_id)
                out.append(make_lc_burst(lc, self.config.color_code,
                                         DT_TERMINATOR_WITH_LC,
                                         sync=SYNC_MS_DATA,
                                         device=self.device))
                self.clear_tx_audio()
                self.tx_state = TX_IDLE
                self._superframe_tx = 0
                break
            if len(self._tx_audio) < 3:
                break
            audio27 = np.concatenate(self._tx_audio[:3])
            del self._tx_audio[:3]
            voice_bits = np.unpackbits(audio27)
            if self.config.vocoder:
                # AMBE frames already carry FEC from the vocoder; ours
                # come FEC-protected from ambe.voice_encode upstream.
                pass
            if self._fn_tx == 0:
                out.append(make_voice_burst(voice_bits,
                                            self.config.color_code, 0,
                                            sync=SYNC_MS_AUDIO,
                                            device=self.device))
            else:
                frag = self._emb_frags_tx[self._fn_tx - 1] \
                    if self._fn_tx <= 4 else None
                out.append(make_voice_burst(voice_bits,
                                            self.config.color_code,
                                            self._fn_tx, frag,
                                            device=self.device))
            self._fn_tx += 1
            if self._fn_tx > 5:
                self._fn_tx = 0
                self._superframe_tx = (self._superframe_tx + 1) % 5
                self._emb_frags_tx = self._fragments_for_superframe(
                    self._superframe_tx)
        return out

    # ------------------------------------------------------------------ RX
    def _check_color_code(self, cc: int | None, is_voice: bool) -> bool:
        """dmrcontrol.cpp processColorCode:415-442 semantics: strict CC
        match unless promiscuous; promiscuous locks onto the first CC."""
        if cc is None:
            return True
        if not self.config.promiscuous:
            # (the reference's or-of-!= chain is always true, so a
            # mismatched CC fails for every data type)
            return cc == self.config.color_code or is_voice is None
        if self._color_code_rx == 0:
            self._color_code_rx = cc
            return True
        return cc == self._color_code_rx

    def _check_timeslot(self, slot_no: int | None) -> bool:
        """dmrcontrol.cpp processTimeslot:444-462."""
        if self.config.mode == MODE_DMO or slot_no is None:
            return True
        if not self.config.promiscuous:
            return slot_no == self.config.timeslot
        if self._timeslot_rx == 0:
            self._timeslot_rx = slot_no
            return True
        return slot_no == self._timeslot_rx

    def add_bursts(self, bursts):
        """Process decoded RX bursts (dmrcontrol.cpp addFrames:625-665).

        `bursts` is a list of (DecodedBurst, slot_no) where slot_no is
        the CACH-derived timeslot (1|2) or None when the CACH did not
        decode (required except in DMO mode)."""
        for burst, slot_no in bursts:
            if burst.kind == "unknown":
                continue
            if slot_no is None and self.config.mode != MODE_DMO:
                continue
            if not self._check_timeslot(slot_no):
                continue
            if burst.kind in ("voice_sync", "voice"):
                self._process_audio(burst, slot_no)
            elif burst.data_type == DT_VOICE_LC_HEADER:
                self._process_voice_header(burst, slot_no)
            elif burst.data_type == DT_TERMINATOR_WITH_LC:
                self._process_terminator(burst, slot_no)
            elif burst.data_type == DT_CSBK:
                self._process_csbk(burst, slot_no)
            elif burst.data_type == dmr.DT_DATA_HEADER:
                self._process_data_header(burst, slot_no)
            elif burst.data_type in (dmr.DT_RATE_12_DATA,
                                     dmr.DT_RATE_34_DATA,
                                     dmr.DT_RATE_1_DATA):
                self._process_data_block(burst, slot_no)

    def _process_audio(self, burst: DecodedBurst, slot_no):
        if not self._check_color_code(burst.color_code, True):
            return
        voice = np.asarray(burst.voice_bits, np.uint8)
        if self.config.vocoder:
            voice, _errs = ambe.regenerate_voice(voice, self.device)
        if burst.kind == "voice_sync":
            self._emb_rx = EmbeddedLCAssembler(self.device)
            if self.rx_state == RX_IDLE:
                self.rx_state = RX_LATE_ENTRY
        else:
            lc = self._emb_rx.add(burst.embedded_fragment, burst.emb_lcss)
            if lc is not None:
                self._process_embedded_lc(lc)
        if self.rx_state in (RX_AUDIO, RX_LATE_ENTRY):
            if (self.config.mode != MODE_DMO
                    and self.tx_state != TX_IDLE):
                return
            if self.on_digital_audio:
                self.on_digital_audio(np.packbits(voice).tobytes())

    def _process_embedded_lc(self, lc: LinkControl):
        """dmrcontrol.cpp processEmbeddedData:464-563."""
        if lc.flco in (FLCO_GROUP, FLCO_USER_USER):
            self._rx_call.src_id = lc.src_id
            self._rx_call.dst_id = lc.dst_id
            self._rx_call.flco = lc.flco
            if self.rx_state == RX_IDLE:
                self.rx_state = RX_LATE_ENTRY
        elif lc.flco == FLCO_GPS_INFO:
            if self.on_gps:
                self.on_gps(extract_gps(lc.to_bytes()))
        elif FLCO_TALKER_ALIAS_HEADER <= lc.flco <= FLCO_TALKER_ALIAS_BLOCK3:
            alias = self._ta_rx.add(lc)
            if alias is not None and self.on_talker_alias:
                self.on_talker_alias(alias)

    def _process_voice_header(self, burst: DecodedBurst, slot_no):
        if not self._check_color_code(burst.color_code, None):
            return
        self._color_code_rx = burst.color_code or self._color_code_rx
        lc = burst.lc
        self._rx_call = CallInfo(src_id=lc.src_id, dst_id=lc.dst_id,
                                 flco=lc.flco, fid=lc.fid,
                                 slot=slot_no or 0)
        self.rx_state = RX_AUDIO
        if self.on_header:
            self.on_header(self._rx_call)

    def _process_terminator(self, burst: DecodedBurst, slot_no):
        lc = burst.lc
        if lc is not None and lc.src_id == 0 and lc.dst_id == 0:
            return                  # trunking-generated terminator
        if not self._check_color_code(burst.color_code, None):
            return
        if self.rx_state != RX_IDLE and self.on_terminator:
            self.on_terminator(self._rx_call)
        self._rx_call = CallInfo()
        self.rx_state = RX_IDLE
        self._ta_rx.reset()
        self._color_code_rx = 0
        self._timeslot_rx = 0

    def _process_csbk(self, burst: DecodedBurst, slot_no):
        if not self._check_color_code(burst.color_code, None):
            return
        csbk = Csbk.from_bytes(burst.payload[:12])
        if csbk is not None and self.on_csbk:
            self.on_csbk(csbk)

    def _process_data_header(self, burst: DecodedBurst, slot_no):
        if not self._check_color_code(burst.color_code, None):
            return
        hdr = self._data_handler.process_header(bytes(burst.payload[:12]))
        if hdr is None:
            return
        self.rx_state = RX_DATA
        self._rx_call = CallInfo(src_id=hdr.src_id, dst_id=hdr.dst_id,
                                 slot=slot_no or 0)
        if self.on_header:
            self.on_header(self._rx_call)

    def _process_data_block(self, burst: DecodedBurst, slot_no):
        """Data-call payload blocks feed the reassembler
        (dmrcontrol.cpp processDataBlock + DMRMessageHandler)"""
        if self.rx_state != RX_DATA:
            return
        if not self._check_color_code(burst.color_code, True):
            return
        msg = self._data_handler.process_block(
            burst.data_type, bytes(burst.payload), self._rx_call.src_id)
        if msg is not None:
            self.rx_state = RX_IDLE
            if self.on_data_message:
                self.on_data_message(msg)
