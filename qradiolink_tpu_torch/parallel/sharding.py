"""Sharding over the ranks of a torch.distributed process group (port of
qradiolink_tpu/parallel/sharding.py).

Channel parallelism: a chain built with lead_shape=(n,) is a function
(state, x[n, T]) -> (state, y[n, ...]); each rank of a mesh runs it on its
own contiguous block of the channel axis, with no communication, the
counterpart of the reference's per-channel flowgraph threads (reference
src/gr/gr_demod_mmdvm_multi2.cpp).

Time parallelism: FIR stages need only the previous K-1 input samples
(their streaming state), so a long block can be split across ranks with a
left-halo exchange from the left neighbour (SURVEY §2.8, §5).

The JAX package writes one program over global arrays, and GSPMD partitions
a chain built for C rows. The port runs one eager program a rank on that
rank's rows: every chain a rank runs is built at the rank's row count (the
chains reshape by their lead_shape, so a chain built for C cannot run on
C/n rows), and `shard_over_channels` refuses one that is not. The ranks'
chains launch the same kernels as a single process does; only the halo
crosses between ranks. Under gloo the halo goes through the host (its
send and receive take CPU tensors); under nccl it stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from qradiolink_tpu_torch.core import (IqPair, _flatten, iq_take,
                                       resolve_device, tree_map)
from qradiolink_tpu_torch.ops.channelizer import PfbChannelizer
from qradiolink_tpu_torch.ops.fir import (conv1d_valid_flipped,
                                          flipped_tap_planes)


class Mesh:
    """The ranks of the default process group laid out on named axes, and
    the device this rank computes on.

    The layout and its groups are a torch DeviceMesh (`device_mesh`) of the
    collectives' device type: "cpu" under gloo, whose send and receive take
    host tensors, "cuda" under nccl. DeviceMesh holds a device type, not a
    device, so the rank's device is kept beside it: the device the caller
    gave init_process, the CPU, or cuda:0 for both ranks of a rehearsal on
    one card. No DTensor is made: the port's kernels take raw pointers, so
    a rank keeps its rows as a plain tensor on `device`.
    """

    def __init__(self, ranks, axis_names, device):
        from torch.distributed.device_mesh import DeviceMesh

        ranks = np.asarray(ranks, np.int64)
        if ranks.size != world_size():
            raise ValueError(f"a mesh of {ranks.size} ranks in a world of "
                             f"{world_size()}: every rank is one device of "
                             f"the mesh")
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        kind = "cpu" if dist.get_backend() == "gloo" else "cuda"
        self.device_mesh = DeviceMesh(kind, torch.from_numpy(ranks),
                                      mesh_dim_names=self.axis_names)
        self.shape = ranks.shape
        self.ranks = ranks.reshape(-1)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def index(self) -> int:
        """This rank's place in the mesh, its axes flattened row-major:
        the block of a sharded leading axis that it holds."""
        return int(np.ravel_multi_index(self.device_mesh.get_coordinate(),
                                        self.shape))


def world_size() -> int:
    """The default group's size; raises where there is no group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "multihost.init_process first")
    return dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: `device` where given, else the
    current CUDA device (init_process sets it); raises without a card."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              device=None) -> Mesh:
    """A one-axis mesh named `axis` over the ranks of the default group
    (multihost.init_process makes it). n_devices, where given, must be the
    world size: each rank is one device of the mesh. device: this rank's
    compute device (rank_device)."""
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}) in a world of {n} ranks")
    return Mesh(np.arange(n), (axis,), rank_device(device))


def local_block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of a leading axis of n, in blocks of
    ceil(n / mesh.size): the last ranks may hold fewer rows, or none."""
    per = -(-n // mesh.size)
    lo = min(mesh.index * per, n)
    return slice(lo, min(lo + per, n))


def chain_rows(chain):
    """The row count a chain was built for: the leading dimension that
    every leaf of its state shares (None where they share none, as in a
    chain built for unbatched input)."""
    leaves = _flatten(chain.init_state(), [])
    lead = {int(leaf.shape[0]) if leaf.ndim else None for leaf in leaves}
    return lead.pop() if len(lead) == 1 else None


def rows_step(chain):
    """chain itself as a step that first checks that the rows of x are
    the rows the chain was built for."""
    rows = chain_rows(chain)

    def step(state, x):
        n = int(x.shape[0]) if x.ndim >= 2 else None
        if rows is not None and n != rows:
            raise ValueError(
                f"the chain was built for {rows} rows and this rank holds "
                f"{n}: build each rank's chain with lead_shape=({n},)")
        return chain(state, x)

    return step


def to_device(leaf, device):
    """A numpy or tensor leaf as a tensor on `device`; any other leaf (a
    Python number) as it is."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf


def shard_over_channels(chain, mesh: Mesh, axis: str = "ch"):
    """(step, place) for a chain whose leading channel axis is split over
    the mesh.

    place(tree) takes this rank's contiguous block of the leading axis of
    every leaf with a dimension (a global input block, numpy or tensors)
    and moves it to the rank's device. step(state, x) runs the chain on
    those local rows. The chain must be built for the rank's row count,
    C / mesh.size (lead_shape=(C // mesh.size,), on mesh.device), and its
    state is its own init_state(): step raises where the rows differ. C
    must be a multiple of the mesh size."""
    del axis  # one mesh axis: the channels

    def place_leaf(leaf):
        if getattr(leaf, "ndim", 0) == 0:
            return to_device(leaf, mesh.device)
        if leaf.shape[0] % mesh.size:
            raise ValueError(f"{leaf.shape[0]} rows not divisible by "
                             f"{mesh.size} ranks")
        return to_device(leaf[local_block(leaf.shape[0], mesh)],
                         mesh.device)

    return rows_step(chain), lambda tree: tree_map(place_leaf, tree)


def _exchange(tail: torch.Tensor, mesh: Mesh) -> torch.Tensor | None:
    """Send `tail` to the next rank of the mesh and return what the
    previous one sent (None on the first rank), with every send and
    receive posted at once (dist.batch_isend_irecv), so no pair of ranks
    waits on the other. Under gloo the tensors cross through the host."""
    i, n = mesh.index, mesh.size
    host = dist.get_backend() == "gloo"
    wire = (tail.cpu() if host else tail).contiguous()
    recv = torch.empty_like(wire) if i > 0 else None
    ops = []
    if i + 1 < n:
        ops.append(dist.P2POp(dist.isend, wire, int(mesh.ranks[i + 1])))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, int(mesh.ranks[i - 1])))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if recv is None else recv.to(tail.device)


def halo_exchange_left(x_local, halo: int, mesh: Mesh):
    """Prepend the left neighbour's last `halo` samples to x_local (..., T)
    (zeros on the first rank). x_local: a real tensor, a complex one or an
    IqPair; every rank calls it with the same shape."""
    if halo > x_local.shape[-1]:
        raise ValueError(f"halo {halo} longer than the local block "
                         f"{x_local.shape[-1]}")
    if isinstance(x_local, IqPair):
        planes = torch.stack([x_local.re, x_local.im])
    elif torch.is_complex(x_local):
        planes = torch.stack([x_local.real, x_local.imag])
    else:
        planes = x_local.unsqueeze(0)
    tail = planes[..., planes.shape[-1] - halo:]
    recv = _exchange(tail, mesh)
    if recv is None:
        recv = torch.zeros_like(tail)
    out = torch.cat([recv, planes], dim=-1)
    if isinstance(x_local, IqPair):
        return IqPair(out[0], out[1])
    if torch.is_complex(x_local):
        return torch.complex(out[0], out[1])
    return out[0]


def time_sharded_fir(taps, mesh: Mesh, axis: str = "t", decim: int = 1):
    """A FIR over a time-sharded stream: fn(x_local) filters this rank's
    block of a stream x[T] (T = mesh.size * local) with the K-1 samples
    before it taken from the left neighbour, which equals the serial
    streaming FIR from zero state. The local length must be a multiple of
    decim; every rank calls fn with the same length."""
    del axis
    tap_planes = flipped_tap_planes(taps, mesh.device)
    k = tap_planes[0].shape[0]

    def fn(x_local):
        if x_local.shape[-1] % decim:
            raise ValueError(f"local length {x_local.shape[-1]} not a "
                             f"multiple of decimation {decim}")
        xc = halo_exchange_left(x_local, k - 1, mesh)
        return conv1d_valid_flipped(xc, tap_planes, decim)

    return fn


def time_sharded_chain(chain, mesh: Mesh, halo: int, out_keys=("bits",),
                       axis: str = "t", out_ratio: dict | None = None):
    """A whole feedforward chain over a time-sharded stream, sequence
    parallelism for one high-rate channel (SURVEY §2.8).

    Every stage of a feedforward chain has bounded input memory, so a rank
    reproduces the serial output from `halo` extra input samples from its
    left neighbour: it runs the chain from zero state on [halo | local]
    and drops the round(halo * r) warm-up outputs of each key (r: the key's
    outputs per input sample, out_ratio[key] or the produced length over
    the input's). Provided halo covers the chain's memory and the local
    length keeps the chain's block quantum aligned, the outputs equal the
    serial run's; the first rank starts from zeros, as the serial run does.

    chain: built for unbatched (T,) input. Returns fn(x_local) -> {key:
    this rank's outputs}."""
    del axis
    ratios = dict(out_ratio or {})

    def fn(x_local):
        xh = halo_exchange_left(x_local, halo, mesh)
        _, out = chain(chain.init_state(), xh)
        trimmed = {}
        for key in out_keys:
            y = out[key]
            r = ratios.get(key)
            if r is None:
                r = y.shape[-1] / xh.shape[-1]
            trimmed[key] = y[..., int(round(halo * r)):]
        return trimmed

    return fn


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

    mesh: every rank runs the channelizer on the whole wideband block (the
    input is the same on every rank) and its contiguous block of each
    group's channels (local_block): each group's chain is built for the
    rank's rows. A rank that holds no row of a group skips it: its state
    and output for that group are None. device defaults to mesh.device.
    """

    def __init__(self, num_channels: int, groups, mesh: Mesh | None = None,
                 device=None):
        self.M = int(num_channels)
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.channelizer = PfbChannelizer(self.M, device=self.device)
        self.groups = []
        for factory, idxs in groups:
            idxs = np.asarray(idxs, np.int32)
            if mesh is not None:
                idxs = idxs[local_block(len(idxs), mesh)]
            chain = factory(lead_shape=(len(idxs),), device=self.device) \
                if len(idxs) else None
            self.groups.append((chain, idxs))

    def init_state(self):
        return (self.channelizer.init_state(),
                tuple(None if c is None else c.init_state()
                      for c, _ in self.groups))

    def __call__(self, state, iq):
        """One step over a wideband block (..., T), T a multiple of M and
        T/M a legal block length of every group's chain. Returns
        (new_state, outs), outs[g] the output dict of group g (this rank's
        rows of it)."""
        ch_state, g_states = state
        ch_state, chans = self.channelizer(ch_state, iq)  # (M, T/M)
        new_g = []
        outs = []
        for (chain, idxs), gs in zip(self.groups, g_states):
            if chain is None:
                new_g.append(None)
                outs.append(None)
                continue
            gs, out = chain(gs, iq_take(chans, idxs, axis=-2))
            new_g.append(gs)
            outs.append(out)
        return (ch_state, tuple(new_g)), outs

    def step(self):
        """The callable that runs one step: the JAX package's jit_step.
        PyTorch runs eagerly, so it is __call__ itself."""
        return self.__call__

    jit_step = step
