"""Which path served each kernel call (counterpart of
qradiolink_tpu/utils/profiling.py PallasPathRecorder).

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

