"""Standards-based digital voice protocol stacks, M17 and DMR (port of
qradiolink_tpu/protocols: m17, dmr, and DMR's call layer dmr_stream,
dmr_control, dmr_data, dmr_signalling and dmr_utils).

Frame-level FEC transforms are array ops over bit arrays; per-transmission
bookkeeping (LSF reassembly, slot state machines) is host-side Python —
mirroring the reference's split between GR blocks and the
gr_modem/DMRControl control plane (reference src/gr_modem.cpp:1019).
"""

from qradiolink_tpu_torch.protocols import m17  # noqa: F401
