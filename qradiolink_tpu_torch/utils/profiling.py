"""Tracing and profiling hooks (port of qradiolink_tpu/utils/profiling.py):

  with trace("build/qrl-trace"):      # torch.profiler trace of a step
      step(state, iq)

  with annotate("front-half"):        # a named region inside a trace
      ...

  stats = step_timer(step, state, iq)   # fenced step time and throughput

and which path served each kernel call (KernelPathRecorder, the
counterpart of the JAX package's PallasPathRecorder).

Every kernel wrapper records each call: `launched=True` where it launches
its CUDA kernel (and only there), `launched=False` where it took the plain
PyTorch version because its tensors lie on the CPU. The record is plain
integer counts, so it stays small however long a stream runs:

    kernel_paths.reset()
    state, out = chain(state, iq)
    kernel_paths.launches("fir_stream_f32")       # kernel launches
    kernel_paths.report()
    # {'fir_stream_f32': {'cuda': 3, 'plain': 0,
    #                     'shapes': {'cuda K419 D50 ...': 1, ...}}, ...}

A stage is told apart by the shape key its wrapper records (taps and
stride for the FIR), so a report shows which stage went through which path.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block under torch.profiler (the CPU, and the card where
    there is one) and write its Chrome trace to logdir/trace.json, for
    chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region inside an active trace."""
    return torch.profiler.record_function(name)


def step_timer(fn, *args, iters: int = 10, samples_per_step: int = 0):
    """Time fn(*args): one warm-up call, then `iters` calls between CUDA
    events on the current stream where the outputs lie on a card, or on
    the host clock otherwise. Returns {"step_ms"} and, when
    samples_per_step is given, {"samples_per_s"}."""
    from qradiolink_tpu_torch.core import tree_map

    leaves = []
    tree_map(leaves.append, fn(*args))
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in leaves)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    res = {"step_ms": dt * 1e3}
    if samples_per_step:
        res["samples_per_s"] = samples_per_step / dt
    return res


class KernelPathRecorder:
    def __init__(self):
        self.counts = {}

    def reset(self):
        self.counts = {}

    def record(self, op: str, launched: bool, shape: str = ""):
        path = "cuda" if launched else "plain"
        row = self.counts.setdefault(op, {"cuda": 0, "plain": 0,
                                          "shapes": {}})
        row[path] += 1
        key = f"{path} {shape}".strip()
        row["shapes"][key] = row["shapes"].get(key, 0) + 1

    def launches(self, op: str) -> int:
        """Kernel launches of `op` since the last reset."""
        return self.counts.get(op, {"cuda": 0})["cuda"]

    def report(self) -> dict:
        return {op: {"cuda": r["cuda"], "plain": r["plain"],
                     "shapes": dict(r["shapes"])}
                for op, r in self.counts.items()}

    def served_only(self) -> bool:
        """True when calls were recorded and every one launched a kernel."""
        return bool(self.counts) and all(
            r["plain"] == 0 for r in self.counts.values())


kernel_paths = KernelPathRecorder()

