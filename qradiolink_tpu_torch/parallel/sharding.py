"""Multichannel receive front-end (port of MultichannelRx in
qradiolink_tpu/parallel/sharding.py).

Only MultichannelRx is ported, on one card. The JAX module's mesh
argument, `jit_step`, `shard_over_channels`, `time_sharded_*` and the halo
exchange wait for the scale-out slice (ROADMAP item 19).
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.core import iq_take, resolve_device
from qradiolink_tpu_torch.ops.channelizer import PfbChannelizer


class MultichannelRx:
    """Polyphase channelizer front-end + per-channel demod chains: the
    BASELINE 64-channel mixed config (channelizer on one wideband stream,
    NBFM and 4FSK chains per channel).

    Because different modes have different chain structures, channels are
    grouped by mode: each group is one chain built with lead_shape=(n,)
    over its n channels; every group runs in the same step.

    groups: list of (chain_factory, channel_indices). A factory is called
    as factory(lead_shape=(n,), device=device), so a chain class such as
    Fsk4DemodFF or NbfmDemod serves as one. State: (channelizer state,
    (group 0 state, group 1 state, ...)), as in the JAX package.
    """

    def __init__(self, num_channels: int, groups, device=None):
        self.M = int(num_channels)
        self.device = resolve_device(device)
        self.channelizer = PfbChannelizer(self.M, device=self.device)
        self.groups = []
        for factory, idxs in groups:
            idxs = np.asarray(idxs, np.int32)
            chain = factory(lead_shape=(len(idxs),), device=self.device)
            self.groups.append((chain, idxs))

    def init_state(self):
        return (self.channelizer.init_state(),
                tuple(c.init_state() for c, _ in self.groups))

    def __call__(self, state, iq):
        """One step over a wideband block (..., T), T a multiple of M and
        T/M a legal block length of every group's chain. Returns
        (new_state, outs), outs[g] the output dict of group g."""
        ch_state, g_states = state
        ch_state, chans = self.channelizer(ch_state, iq)  # (M, T/M)
        new_g = []
        outs = []
        for (chain, idxs), gs in zip(self.groups, g_states):
            x = iq_take(chans, idxs, axis=-2)
            gs, out = chain(gs, x)
            new_g.append(gs)
            outs.append(out)
        return (ch_state, tuple(new_g)), outs
