"""Multi-process execution: a channel axis sharded over the ranks of a
torch.distributed process group (port of
qradiolink_tpu/parallel/multihost.py).

The reference scales past one machine only by pushing baseband over process
boundaries (ZeroMQ ipc:// a channel to external MMDVMHost processes; UDP
audio). Here each process is one rank on one device: it ingests the IQ of
its own channels, runs the chain on them and emits its own output rows. A
feedforward chain needs no collective on the channel axis, so no sample
crosses between ranks; time-sharded chains exchange halos
(parallel/sharding.py).

The caller names the backend: "nccl" where each rank has its own card,
"gloo" on the CPU, and for two ranks sharing one card (NCCL refuses two
ranks on one GPU), where the chains still run on the card and only the
collectives go through the host. A rank keeps its rows as a plain tensor on
its device: the port's kernels take raw pointers, so no DTensor reaches a
chain, and every chain a rank runs is built for the rank's row count.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from qradiolink_tpu_torch.core import resolve_device, tree_map
from qradiolink_tpu_torch.parallel.sharding import (Mesh, local_block,
                                                    rank_device, rows_step,
                                                    to_device, world_size)


def init_process(coordinator: str, num_processes: int, process_id: int,
                 backend: str = "nccl", device=None,
                 timeout_s: float = 120.0) -> torch.device:
    """Join the default process group and return this rank's device.

    coordinator: "host:port" of process 0's rendezvous. backend: "nccl"
    (a card a rank) or "gloo" (the CPU, or ranks that share a card).
    device: the rank's compute device, cuda:<process_id mod cards> by
    default; a CUDA device becomes the current one."""
    if device is None:
        resolve_device(None)
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def pod_mesh(axes: tuple = ("host", "ch"), device=None) -> Mesh:
    """A two-axis mesh of (processes, local devices): one device a
    process, so its shape is (world size, 1). device: this rank's compute
    device (sharding.rank_device)."""
    n = world_size()
    return Mesh(np.arange(n).reshape(n, 1), axes, rank_device(device))


def channel_spec(mesh: Mesh) -> tuple:
    """Channel-major placement, (blocks, this rank's block): the leading
    axis in mesh.size contiguous blocks over both mesh axes, the rank
    holding block mesh.index."""
    return mesh.size, mesh.index


def local_channel_slice(n_channels: int) -> slice:
    """Which rows of the global channel axis this rank ingests: its
    contiguous block, as channel_spec places it."""
    n_proc = world_size()
    if n_channels % n_proc:
        raise ValueError(f"{n_channels} channels not divisible by "
                         f"{n_proc} processes")
    per = n_channels // n_proc
    pid = dist.get_rank()
    return slice(pid * per, (pid + 1) * per)


def distribute_channels(local_rows, n_channels: int, mesh: Mesh):
    """This rank's block of the global (C, ...) input, from the rows it
    ingested (local_channel_slice), as a tensor on its device; no rank
    sends another a sample."""
    blocks, _ = channel_spec(mesh)
    if n_channels % blocks or local_rows.shape[0] != n_channels // blocks:
        raise ValueError(f"{local_rows.shape[0]} local rows of "
                         f"{n_channels} channels over {blocks} ranks")
    return tree_map(lambda leaf: to_device(leaf, mesh.device), local_rows)


def replicate(tree, mesh: Mesh):
    """Small host-computed values (masks, settings) on the rank's device,
    the same on every rank."""
    return tree_map(lambda leaf: to_device(leaf, mesh.device), tree)


def shard_state(state, mesh: Mesh):
    """A state tree built for the global channel count (numpy or tensors,
    the same on every rank), as this rank's part on its device: its block
    of each leaf whose leading axis divides over the mesh, the whole of
    any other leaf."""
    def leaf(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % mesh.size == 0:
            x = x[local_block(x.shape[0], mesh)]
        return to_device(x, mesh.device)

    return tree_map(leaf, state)


def multihost_step(chain, mesh: Mesh):
    """A chain step over this rank's rows: step(state, x) with x from
    distribute_channels and state from shard_state (or the chain's own
    init_state). The chain is built for the rank's row count, C /
    mesh.size, on mesh.device; step raises where the rows differ."""
    del mesh  # the rows are local already: no collective
    return rows_step(chain)


def local_output_rows(arr) -> np.ndarray:
    """This rank's rows of a channel-sharded output, on the host (audio and
    bit egress stay local to the rank, like the reference's per-channel
    UDP/ZMQ sinks)."""
    return arr.detach().cpu().numpy()
