"""IP-over-radio: TUN/TAP device + net-stream pump (port of
qradiolink_tpu/net).

Equivalent of reference src/net/netdevice.cpp + the controller net
paths (src/radiocontroller.cpp:745-824,1260-1290,1669-1704).
"""

from qradiolink_tpu_torch.net.netdev import (   # noqa: F401
    TunTapDevice, LoopbackNetDevice, ip_frame_encode, ip_frame_decode,
    NetPump, IP_MODE_PARAMS,
)
