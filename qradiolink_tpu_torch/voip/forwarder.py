"""Radio <-> VOIP forwarding glue (port of
qradiolink_tpu/voip/forwarder.py; host-side).

The reference's RadioController fans decoded radio audio out to the
Mumble connection and mixes incoming VOIP audio into the TX path /
local playback (reference src/radiocontroller.cpp:1498-1560 RX fanout,
:470-500 VOIP TX tee, audio/audiomixer.h per-SID mixing). Text
messages from private chats drive the CommandProcessor when remote
control is enabled (commandprocessor.h:131).
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.audio.mixer import AudioMixer


class VoipForwarder:
    """Couples a MumbleClient to the radio side.

    radio_rx_audio(pcm): decoded radio audio -> Opus -> Mumble voice.
    Incoming Mumble voice decodes into the per-SID mixer; mixed_frame()
    yields 40 ms frames for TX/playback. Private text messages go to
    the command processor when attached.
    """

    def __init__(self, client, codec=None, command_processor=None,
                 forwarding: bool = False):
        self.client = client
        self.command_processor = command_processor
        self.forwarding = forwarding
        self.mixer = AudioMixer()
        if codec is None:
            try:
                from qradiolink_tpu_torch.audio.codecs import (
                    AudioEncoder, opus_available)
                codec = AudioEncoder() if opus_available() else None
            except Exception:
                codec = None
        self.codec = codec
        client.on_voice = self._voice_in
        client.on_text = self._text_in

    # radio -> VOIP
    def radio_rx_audio(self, pcm: np.ndarray):
        """float/int16 8 kHz audio from the radio RX -> Mumble."""
        if not self.client.synchronized or self.codec is None:
            return
        pcm16 = np.asarray(pcm)
        if pcm16.dtype != np.int16:
            pcm16 = np.clip(pcm16 * 32767.0, -32767, 32767).astype(np.int16)
        for i in range(0, (pcm16.size // 320) * 320, 320):
            self.client.send_opus_voice(
                self.codec.encode_opus(pcm16[i:i + 320]))

    # VOIP -> radio
    def _voice_in(self, session: int, opus: bytes):
        if self.codec is None:
            return
        try:
            pcm = self.codec.decode_opus(opus)
        except Exception:
            return
        self.mixer.add_samples(pcm, sid=session)

    def mixed_frame(self, rx_volume: float = 1.0):
        """-> (320,) int16 mixed VOIP frame or None (feed to TX audio
        or local playback)."""
        return self.mixer.mix_samples(rx_volume)

    def _text_in(self, message: str, sender: str, channel_msg: bool):
        if self.command_processor is not None and not channel_msg:
            resp = self.command_processor.process(message)
            if resp:
                self.client.send_text(resp)
