"""Scale-out over torch.distributed: channel sharding and the time-block
halo exchange (port of qradiolink_tpu/parallel/)."""

from qradiolink_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, shard_over_channels, halo_exchange_left, time_sharded_fir,
    MultichannelRx,
)
