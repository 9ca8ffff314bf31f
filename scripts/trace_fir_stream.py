"""Does torch.profiler see every fir_stream_f32 launch? One card.

    python scripts/trace_fir_stream.py

Runs the port's fir_stream_f32 kernel at two shapes, 2048 rows, two planes,
the tails read in place: the WBFM head (K225 D5, 4 KB of shared memory a
block) and the SSB head (K5597 D125, 108 KB, which needs the kernel's
dynamic shared-memory limit raised before the launch). For each it prints
the kernel's time by CUDA events and, for one launch under
torch.profiler, the device ops the profiler reports with their names and
durations. The SSB chain's traced step in chip_smoke.py reported no
fir_stream_f32 op, though the stage takes most of the step by CUDA
events.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from qradiolink_tpu_torch.chains.ssb import SsbDemod  # noqa: E402
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_fir  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    C, T = 2048, 200_000
    for name, rs in (("wbfm_head", WbfmDemod(device=dev).resamp),
                     ("ssb_head", SsbDemod(device=dev).resamp)):
        tf, D = rs.phase_taps[0], rs.M
        xs = [torch.randn((C, T), generator=gen, device=dev)
              for _ in range(2)]
        st = torch.randn((C, 2, rs.kp - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])

        def call():
            return cuda_fir.fir_stream(xs, tf, D, T // D, tails=tails)

        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        print(f"{name} K{tf.shape[0]} D{D}: {start.elapsed_time(end):.4f} ms "
              f"by CUDA events")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ops = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
        print(f"  under torch.profiler: {len(ops)} device ops: " + "; ".join(
            f"{n[:50]} {ms:.4f} ms" for n, ms in ops))
        del xs, st


if __name__ == "__main__":
    main()
