"""Settings + memory channels: the framework's config system (a copy of
qradiolink_tpu/config.py: the same JSON schema, field defaults and default
directory, so a file either package saved loads in the other unchanged).

Equivalent of reference src/settings.{h,cpp} (libconfig file with ~100
typed keys read into a Settings object) and src/radiochannel.{h,cpp}
(memory-channel store). Here both are dataclasses persisted as JSON
under ~/.config/qradiolink_tpu/, keeping the reference's key names
where they map 1:1 so operators recognize them.

Key map vs reference settings.h:22-177 (every reference key accounted
for; "n/a (<reason>)" = intentionally absent):

  rx_device_args/tx_device_args/rx_antenna/tx_antenna  n/a (physical SDR)
  tx_power/if_gain/rx_freq_corr/tx_freq_corr           n/a (physical SDR)
  rx_sensitivity -> rx_gain ; tx_power gain knob -> tx_gain
  bb_gain, squelch -> squelch_db, rx_volume, tx_volume, voip_volume
  rx_ctcss, tx_ctcss, rx_frequency, tx_shift, callsign
  video_device n/a (V4L2 hardware); video_enabled gates the codec path
  voip_server, voip_port, voip_password, voip_bitrate
  rx_mode/tx_mode (string names, not ints), ip_address -> net_ip_address
  demod_offset, rx_sample_rate, tx_carrier_offset, scan_step
  show_* / fft_* / wf_* / waterfall_* / time_domain_* / night_mode /
    window_* / panadapter_* / coloured_fft / draw_constellation_eye
                                                       n/a (Qt GUI scope)
  audio_compressor, enable_relays n/a (FTDI hw), mute_forwarded_audio
  rssi_calibration_value, audio_output/input_device n/a (PulseAudio)
  control_port, udp_listen_port, udp_send_port, remote_control
  agc_attack, agc_decay, burst_ip_modem, scan_resume_time -> scan_resume_ms
  audio_record_path, vox_level, voip_bitrate, end_beep
  block_buffer_size -> block_len, radio_tot -> tot_seconds, tot_tx_end
  tx_band_limits, relay_sequence n/a (FTDI), lnb_lo_freq
  gpredict_control, lime_rfe_* n/a (LimeRFE hardware)
  mmdvm_channels, mmdvm_channel_separation, burst_delay_msec
  m17_can_tx, m17_can_rx, m17_src, m17_dest, m17_decode_all_can,
  m17_destination_type, udp_audio_sample_rate,
  sql_pty_path n/a (SVXLink pty), udp_audio_local/remote_address,
  vocoder_plugin_path, dmr_* (all 11), zmq_proxy_channel
  enable_duplex, filter_width (runtime analog override; 0 = mode default)
"""

from __future__ import annotations

import json
import dataclasses
from dataclasses import dataclass, asdict
from pathlib import Path

DEFAULT_DIR = Path.home() / ".config" / "qradiolink_tpu"


@dataclass
class Settings:
    # radio (settings.h rx_frequency/tx_shift/rx_mode... subset that has
    # meaning without physical hardware)
    rx_frequency: int = 434_000_000
    demod_offset: int = 0
    tx_shift: int = 0
    rx_mode: str = "NBFM"
    tx_mode: str = "NBFM"
    rx_sample_rate: int = 1_000_000
    squelch_db: float = -140.0
    rx_volume: float = 1.0
    tx_volume: float = 1.0
    bb_gain: float = 1.0
    rssi_calibration_value: float = -80.0
    rx_gain: int = 50                 # reference rx_sensitivity (0-99)
    tx_gain: int = 50                 # reference tx_power gain knob (0-99)
    tx_carrier_offset: int = 0        # changed by Doppler correction
    scan_step: int = 0                # Hz; 0 = per-mode default step
    filter_width: int = 0             # Hz; 0 = mode default (analog only)
    rx_ctcss: float = 0.0             # CTCSS squelch tone (Hz), 0 = off
    tx_ctcss: float = 0.0             # CTCSS TX tone (Hz), 0 = off
    lnb_lo_freq: int = 0
    # voice
    audio_compressor: bool = False
    audio_denoise: bool = False       # Speex-preprocess equivalent
    agc_attack: int = 1               # reference agc_attack (attack steps)
    agc_decay: int = 100              # reference agc_decay
    vox_level: float = 0.0
    voip_bitrate: int = 24_600
    vocoder_bitrate: int = 1400       # codec2 rate for digital voice
    vocoder_plugin_path: str = ""
    end_beep: int = 0
    audio_record_path: str = ""
    # station
    callsign: str = "CALL"
    video_enabled: bool = False
    net_ip_address: str = "10.0.0.1"  # reference ip_address (IP modem)
    burst_ip_modem: bool = False
    # VOIP (Mumble)
    voip_server: str = "127.0.0.1"
    voip_port: int = 64738
    voip_password: str = ""
    voip_volume: int = 80             # percent
    voip_forwarding: bool = False     # radio <-> VOIP bridge
    voip_ptt_enabled: bool = False    # use PTT for VOIP
    mute_forwarded_audio: bool = True
    # UDP PCM audio (SVXLink etc.)
    udp_enabled: bool = False
    udp_listen_port: int = 4938
    udp_send_port: int = 4937
    udp_audio_sample_rate: int = 8000
    udp_audio_local_address: str = "127.0.0.1"
    udp_audio_remote_address: str = "127.0.0.1"
    # remote control
    remote_control: bool = False
    control_port: int = 4939          # reference config_defines.h:16
    gpredict_control: bool = False
    # TDMA / MMDVM
    mmdvm_channels: int = 7
    mmdvm_channel_separation: int = 25_000
    burst_delay_msec: int = 60
    zmq_proxy_channel: int = 0
    # M17 (reference settings.h m17_* block)
    m17_src: str = ""
    m17_dest: str = ""
    m17_can_tx: int = 0
    m17_can_rx: int = 0
    m17_decode_all_can: bool = False
    m17_destination_type: int = 0
    # DMR (reference settings.h dmr_* block)
    dmr_mode: int = 0
    dmr_vocoder: int = 0
    dmr_codec2_bitrate: int = 3200
    dmr_timeslot: int = 1
    dmr_color_code: int = 1
    dmr_promiscuous_mode: bool = False
    dmr_timing_correction: int = 0
    dmr_source_id: int = 1
    dmr_destination_id: int = 9
    dmr_call_type: int = 0
    dmr_talker_alias: str = ""
    # control
    enable_duplex: bool = False
    repeater_enabled: bool = False    # digital repeater forwarding
    tx_band_limits: bool = False      # enforce IARU band plan on TX
    tot_seconds: float = 120.0        # TX timeout timer
    tot_tx_end: bool = False          # beep at TOT expiry
    rx_timeout_ms: int = 200          # data watchdog (radiocontroller:336)
    scan_resume_ms: int = 5000
    # processing
    block_len: int = 125_000          # samples per device step (125 ms)

    def save(self, path=None) -> Path:
        path = Path(path) if path else DEFAULT_DIR / "qradiolink_tpu.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(asdict(self), indent=2))
        return path

    @classmethod
    def load(cls, path=None) -> "Settings":
        path = Path(path) if path else DEFAULT_DIR / "qradiolink_tpu.json"
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclass
class MemoryChannel:
    """One stored channel (reference radiochannel.h)."""
    name: str = ""
    rx_frequency: int = 0
    tx_shift: int = 0
    rx_mode: str = "NBFM"
    tx_mode: str = "NBFM"
    squelch_db: float = -140.0
    skip: bool = False


class RadioChannels:
    """Memory-channel table with JSON persistence
    (reference qradiolink_mem.cfg)."""

    def __init__(self, channels=None):
        self.channels: list[MemoryChannel] = list(channels or [])

    def add(self, ch: MemoryChannel):
        self.channels.append(ch)

    def save(self, path=None) -> Path:
        path = Path(path) if path else DEFAULT_DIR / "memory_channels.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps([asdict(c) for c in self.channels],
                                   indent=2))
        return path

    @classmethod
    def load(cls, path=None) -> "RadioChannels":
        path = Path(path) if path else DEFAULT_DIR / "memory_channels.json"
        if not path.exists():
            return cls()
        return cls([MemoryChannel(**d) for d in json.loads(path.read_text())])
