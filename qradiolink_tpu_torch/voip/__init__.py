"""VOIP: Mumble client (control + voice) and helpers (port of
qradiolink_tpu/voip)."""

from qradiolink_tpu_torch.voip.mumble import (   # noqa: F401
    MumbleClient, Station, mumble_varint, read_mumble_varint,
)

from qradiolink_tpu_torch.voip.forwarder import VoipForwarder  # noqa: F401
