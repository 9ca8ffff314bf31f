"""Per-source audio mixer + UDP PCM audio client (VOIP audio plumbing;
port of qradiolink_tpu/audio/mixer.py).

AudioMixer mirrors reference src/audio/audiomixer.cpp: per-SID sample
queues, mix_samples sums the first 320 samples (40 ms) of every active
queue scaled by 1/num_channels (radio SIDs >= 9900 bypass the RX
volume), draining each queue; a mix is produced only once some queue
has accumulated `maximum_frame_size` samples.

UdpAudioClient mirrors src/udpclient.cpp: raw mono int16 PCM over UDP
datagrams (SVXLink-style), with polyphase resampling between the
wire's sample rate and the internal 8 kHz (the reference uses the
Speex resampler; the framework's own RationalResampler fills that
role).

The mixer is host numpy, as in the JAX module. The client's two
resamplers run as the port's RationalResampler on one row on the client's
device (`device=None`: the card; the tests pass "cpu"): 48 kHz -> 8 kHz is
L1 M6 with 269 taps (the strided FIR `ops/cuda_fir.route` gives
K269 D6: fir_cols_f32) and 8 kHz -> 48 kHz L6 M1 with 45 taps a phase
(`ops/cuda_resample.route`: resample_up_f32). Each call pads its samples
with zeros to a multiple of M and truncates the float output to int16,
as the JAX client does.
"""

from __future__ import annotations

import socket
from fractions import Fraction

import numpy as np
import torch

from qradiolink_tpu_torch.core import resolve_device
from qradiolink_tpu_torch.ops.resample import RationalResampler

INTERNAL_RATE = 8_000
MIX_FRAME = 320          # 40 ms at 8 kHz (audiomixer.cpp:89)
RADIO_SID_BASE = 9900    # radio sources bypass rx_volume


class AudioMixer:
    def __init__(self):
        self._buffers: dict[int, np.ndarray] = {}

    def empty(self):
        self._buffers.clear()

    def add_samples(self, pcm: np.ndarray, sid: int):
        pcm = np.asarray(pcm, np.int16).ravel()
        prev = self._buffers.get(sid, np.zeros(0, np.int16))
        self._buffers[sid] = np.concatenate([prev, pcm])

    def buffers_available(self, maximum_frame_size: int) -> bool:
        return any(b.size >= maximum_frame_size
                   for b in self._buffers.values())

    def mix_samples(self, rx_volume: float = 1.0,
                    maximum_frame_size: int = MIX_FRAME) -> np.ndarray | None:
        """-> (320,) int16 mixed frame or None when not enough queued
        (audiomixer.cpp:89-155)."""
        active = {sid: b for sid, b in self._buffers.items() if b.size > 0}
        if not active or max(b.size for b in active.values()) \
                < maximum_frame_size:
            return None
        n_ch = len(active)
        mix = np.zeros(MIX_FRAME, np.float32)
        for sid, b in active.items():
            take = b[:MIX_FRAME].astype(np.float32)
            vol = 1.0 if sid >= RADIO_SID_BASE else rx_volume
            mix[:take.size] += take / n_ch * vol
            rest = b[min(b.size, MIX_FRAME):]
            if rest.size:
                self._buffers[sid] = rest
            else:
                del self._buffers[sid]
        return np.clip(mix, -32768, 32767).astype(np.int16)


class UdpAudioClient:
    """Raw UDP PCM audio in/out with rate conversion
    (reference src/udpclient.cpp:1-151)."""

    def __init__(self, listen_port: int = 4938, send_port: int = 4937,
                 host: str = "127.0.0.1", wire_rate: int = 48_000,
                 internal_rate: int = INTERNAL_RATE, device=None):
        self.device = resolve_device(device)
        self.addr = (host, send_port)
        self.wire_rate = int(wire_rate)
        self.internal_rate = int(internal_rate)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, listen_port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        fr = Fraction(self.internal_rate, self.wire_rate)
        self._down = (fr.numerator, fr.denominator)
        self._rs_down = self._make_resampler(*self._down)
        self._rs_up = self._make_resampler(self._down[1], self._down[0])

    def _make_resampler(self, L, M):
        if L == M == 1:
            return None
        rs = RationalResampler(L, M, device=self.device)
        return [rs, rs.init_state()]

    def _resample(self, rs, pcm: np.ndarray, M: int) -> np.ndarray:
        if rs is None:
            return pcm
        x = pcm.astype(np.float32) / 32768.0
        pad = (-len(x)) % M
        if pad:
            x = np.concatenate([x, np.zeros(pad, np.float32)])
        rs[1], y = rs[0](rs[1], torch.from_numpy(x).to(self.device))
        return np.clip(y.cpu().numpy() * 32768.0, -32768,
                       32767).astype(np.int16)

    def read_audio(self) -> np.ndarray:
        """Drain pending datagrams -> int16 PCM at the internal rate."""
        chunks = []
        while True:
            try:
                data, _ = self.sock.recvfrom(65536)
            except BlockingIOError:
                break
            chunks.append(np.frombuffer(data, np.int16))
        if not chunks:
            return np.zeros(0, np.int16)
        return self._resample(self._rs_down, np.concatenate(chunks),
                              self._down[1])

    def write_audio(self, pcm: np.ndarray):
        """Internal-rate int16 PCM -> wire-rate UDP datagrams."""
        out = self._resample(self._rs_up, np.asarray(pcm, np.int16),
                             self._down[0])
        raw = out.tobytes()
        for i in range(0, len(raw), 1280):
            self.sock.sendto(raw[i:i + 1280], self.addr)

    def close(self):
        self.sock.close()
