"""One rank of the port's scale-out tests (spawned by
tests/test_torch_parallel.py and tests/test_torch_multihost.py).

Usage: python tests/torch_multihost_worker.py <case> <rank> <world> <port>
           <inputs.npz> <out_prefix>

Joins a gloo process group over 127.0.0.1 on the CPU, runs one case of
qradiolink_tpu_torch.parallel on this rank's part of the inputs, and saves
what the rank computed to <out_prefix><rank>.npz. The parent compares the
ranks' outputs with the JAX package's: the reference is computed there
once, not in every rank. Imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qradiolink_tpu_torch.core import (Block, Sequencer,  # noqa: E402
                                       _flatten, init_states)
from qradiolink_tpu_torch.parallel import multihost, sharding  # noqa: E402

CPU = torch.device("cpu")


class ChanNbfm(Block):
    """tests/test_sharding.py's channel-rate NBFM chain: a 25 kHz low-pass
    and a quadrature demodulator."""

    def __init__(self, lead_shape=(), device=CPU, fs_ch=25_000.0):
        from qradiolink_tpu_torch.ops import firdes
        from qradiolink_tpu_torch.ops.analog import QuadratureDemod
        from qradiolink_tpu_torch.ops.fir import FirFilter

        self.filt = FirFilter(firdes.low_pass(1.0, fs_ch, 5000.0, 2000.0),
                              lead_shape=lead_shape, device=device)
        self.quad = QuadratureDemod(1.0, lead_shape=lead_shape,
                                    device=device)
        self.blocks = [self.filt, self.quad]

    def init_state(self):
        return init_states(self.blocks)

    def __call__(self, state, x):
        seq = Sequencer(state)
        y = seq(self.quad, seq(self.filt, x))
        return seq.states(), {"audio": y}


def time_block(x, mesh):
    local = x.shape[-1] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        x[..., mesh.index * local:(mesh.index + 1) * local]))


def case_fir(data):
    mesh = sharding.make_mesh(axis="t", device=CPU)
    fn = sharding.time_sharded_fir(data["taps"], mesh,
                                   decim=int(data["decim"]))
    return {"y": fn(time_block(data["x"], mesh)).numpy()}


def case_chain(data):
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF

    mesh = sharding.make_mesh(axis="t", device=CPU)
    fn = sharding.time_sharded_chain(
        Fsk4DemodFF(sync_window=320, device=CPU), mesh,
        halo=int(data["halo"]), out_keys=("bits",))
    return {"bits": fn(time_block(data["iq"], mesh))["bits"].numpy()}


def case_channels(data):
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    mesh = sharding.make_mesh(axis="ch", device=CPU)
    iq = torch.from_numpy(data["iq"])
    C = iq.shape[0]
    demod = NbfmDemod(lead_shape=(C // mesh.size,), device=CPU)
    step, place = sharding.shard_over_channels(demod, mesh, axis="ch")
    _, out = step(demod.init_state(), place(iq))
    # a chain built for the global row count is refused
    whole = NbfmDemod(lead_shape=(C,), device=CPU)
    step_whole, _ = sharding.shard_over_channels(whole, mesh)
    try:
        step_whole(whole.init_state(), place(iq))
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"audio": out["audio"].numpy(), "refused": np.asarray(refused)}


def case_mcrx(data):
    """groups: one row a group, its channels padded with -1."""
    mesh = sharding.make_mesh(axis="ch", device=CPU)
    groups = [(ChanNbfm, [int(c) for c in g if c >= 0])
              for g in data["groups"]]
    rx = sharding.MultichannelRx(int(data["M"]), groups, mesh=mesh)
    step = rx.step()
    state = rx.init_state()
    saved = {f"rows{g}": idxs for g, (_, idxs) in enumerate(rx.groups)}
    for i, blk in enumerate(data["blocks"]):
        state, outs = step(state, torch.from_numpy(blk))
        for g, out in enumerate(outs):
            if out is not None:
                saved[f"audio{g}_{i}"] = out["audio"].numpy()
    return saved


def case_multihost(data):
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.core import state_to_numpy

    mesh = multihost.pod_mesh(device=CPU)
    blocks = data["blocks"]
    C = blocks.shape[1]
    chain = Fsk4DemodFF(lead_shape=(C // mesh.size,), device=CPU)
    step = multihost.multihost_step(chain, mesh)
    # the global zero state, as every rank builds it on the host
    state = multihost.shard_state(state_to_numpy(
        Fsk4DemodFF(lead_shape=(C,), device=CPU).init_state()), mesh)
    rows = multihost.local_channel_slice(C)
    saved = {"rows": np.arange(C)[rows]}
    for i, blk in enumerate(blocks):
        x = multihost.distribute_channels(np.ascontiguousarray(blk[rows]),
                                          C, mesh)
        state, out = step(state, x)
        saved[f"symbols{i}"] = multihost.local_output_rows(out["symbols"])
        saved[f"bits{i}"] = multihost.local_output_rows(out["bits"])
    for j, leaf in enumerate(_flatten(state, [])):
        saved[f"state{j}"] = leaf.numpy()
    return saved


def start_ranks(case, inputs, tmp_path, world=2, timeout=120):
    """Start `case` on `world` ranks, each a process of this script, over
    the numpy arrays `inputs`, and return wait(): it returns each rank's
    saved arrays (the same ones on a later call), or fails with the
    ranks' output where one fails or the case times out. No rank outlives
    wait()."""
    import socket
    import subprocess

    src = tmp_path / f"{case}_inputs.npz"
    np.savez(src, **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prefix = str(tmp_path / f"{case}_rank")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(world), str(port), str(src), prefix],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    done = []

    def wait():
        if done:
            return done[0]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            tail = "\n".join(log.splitlines()[-30:])
            if p.returncode != 0 or "TORCH_MULTIHOST_OK" not in log:
                raise RuntimeError(f"rank {r} of {case} failed "
                                   f"(exit {p.returncode}):\n{tail}")
        outs = []
        for r in range(world):
            with np.load(f"{prefix}{r}.npz") as f:
                outs.append(dict(f))
        done.append(outs)
        return outs

    return wait


CASES = {"fir": case_fir, "chain": case_chain, "channels": case_channels,
         "mcrx": case_mcrx, "multihost": case_multihost}


def main():
    case, rank, world, port, inputs, out_prefix = sys.argv[1:7]
    torch.set_num_threads(2)
    multihost.init_process(f"127.0.0.1:{port}", int(world), int(rank),
                           backend="gloo", device=CPU, timeout_s=60)
    try:
        with np.load(inputs, allow_pickle=False) as f:
            data = dict(f)
        np.savez(f"{out_prefix}{rank}.npz", **CASES[case](data))
    finally:
        torch.distributed.destroy_process_group()
    print(f"[rank {rank}] TORCH_MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
