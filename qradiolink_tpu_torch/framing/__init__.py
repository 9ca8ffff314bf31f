"""Layer-1 and layer-2 framing and the TDMA slot clock (host-side; port of
qradiolink_tpu/framing: layer1, layer2 and tdma).

Mirrors the reference's split: device-side chains produce continuous bit
streams; sync hunting and frame assembly happen in the control plane
(reference src/gr_modem.cpp:1019-1441, src/layer1framing.h). The
bit-serial shift-register hunt is a vectorized sliding-word search over
bit blocks.
"""

from qradiolink_tpu_torch.framing.layer1 import (  # noqa: F401
    FrameType, Layer1Framer, Deframer, MODE_FRAME_CONFIG, FrameConfig,
)
from qradiolink_tpu_torch.framing.layer2 import (  # noqa: F401
    build_layer2_frame, parse_layer2_frame, PageMessage,
)
from qradiolink_tpu_torch.framing.tdma import (  # noqa: F401
    BurstTimer, slot_mask,
)
