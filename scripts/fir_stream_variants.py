"""fir_stream_f32 against its first design, fir_stream_v0_f32, in turns, at
the shapes that ops/cuda_fir.route() gives it on a path. One card.

    python scripts/fir_stream_variants.py [--shapes a,b] [--variants]
        [--ablate] [--probe]

The shapes (2 planes, 256 rows, the tails read in place from a (C, 2,
K-1) state, the chains' own taps): FreeDV's head K1045 D125 and 4FSK1KFM's
head K837 D100 over 1,000,000 samples a row, 4FSK100K's head K17 D2 over
200,000. At each, both kernels are held to the plain version (FIR_TOL of
chip_smoke.py) and to each other bit for bit, then timed in turns (v0,
new, new, v0; device time by CUDA events) beside the bound of
chip_smoke.py (each input read once, each output written once).

--variants  also builds csrc/fir.cu with other constants (VARIANTS
            below: the ring's slots and chunk, the warps a block), holds
            each bit-equal to the kernel and times it in turns with it.
--ablate    also builds csrc/fir_stream_v0.cu and csrc/fir.cu with one
            part taken away (ABLATIONS below). fir_stream_v0_f32:
            "staging", the FMA loop replaced by one read of the staged
            span, so the block stages its span and stores; "fma", the
            staging loads replaced by a value from the index (no
            device-memory read), so the block runs its FMA loop on shared
            memory it wrote itself. fir_stream_f32: "no_copies" (no
            device-memory reads), "no_tap_loads" (constant taps),
            "no_fmas" (the sample loads and the bookkeeping kept). Each is
            timed in turns with its kernel (outputs not checked).
--probe     times the copy mechanisms alone (PROBE_SRC below: the
            kernel's 4-byte cp.async, a 1-D bulk copy a lane, 16-byte
            cp.async a lane) on FreeDV's head's stream layout, each lane
            reading its chunks once from shared memory.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card and nvcc; builds into build/fir_stream_variants/.
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import bound, check_fir, turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_fir  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402

OUT = ROOT / "build" / "fir_stream_variants"

# name: (K, D, rows, samples a row)
SHAPES = {"freedv_head": (1045, 125, 256, 1_000_000),
          "fsk1kfm_head": (837, 100, 256, 1_000_000),
          "fsk100k_head": (17, 2, 256, 200_000)}

# tag: [(line of csrc/fir.cu, replacement)]
VARIANTS = {
    "ch32_slots3": [("constexpr int kCh = 64;", "constexpr int kCh = 32;"),
                    ("constexpr int kSlots = 2;",
                     "constexpr int kSlots = 3;")],
    "ch128": [("constexpr int kCh = 64;", "constexpr int kCh = 128;")],
    "slots3_w3": [("constexpr int kSlots = 2;", "constexpr int kSlots = 3;"),
                  ("constexpr int kWarps = 4;",
                   "constexpr int kWarps = 3;")],
    "w5": [("constexpr int kWarps = 4;", "constexpr int kWarps = 5;")],
}

# (source, tag): [(text of csrc/<source>.cu, replacement)]
ABLATIONS = {
    ("fir_stream_v0", "staging"): [
        ("for (int j = 0; j < K; ++j) acc = fmaf(s_tap[j], p[j], acc);",
         "acc = p[0] + s_tap[0];")],
    ("fir_stream_v0", "fma"): [
        ("s_x[i] = v < tail_len ? tail[v] : x[v - tail_len];",
         "s_x[i] = (float)(v & 7) * 0.25f;")],
    # the kernel without its device-memory reads (no copy issued: the ring
    # keeps what it holds), without its tap loads (constant taps), or
    # without its FMAs (the sample loads and the bookkeeping kept)
    ("fir", "no_copies"): [
        ('    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" '
         '::"r"(s),\n                 "l"(src), "r"(full ? 4 : 0)\n'
         '                 : "memory");', "    (void)s;")],
    ("fir", "no_tap_loads"): [
        ("const float4 f = reinterpret_cast<const float4*>(tp)[k];",
         "const float4 f = make_float4(1.0f, 0.5f, 0.25f, 0.125f);")],
    ("fir", "no_fmas"): [
        ("        for (int k = 0; k < S - 1; ++k) acc[k] = fmaf(t[k], x, "
         "acc[k]);", "        acc[0] += x;"),
        ("        if (kOldest) acc[S - 1] = fmaf(t[S - 1], x, acc[S - 1]);",
         ""),
        ("                        acc[k] = fmaf(tr[qq][k], x, acc[k]);",
         "                        acc[k] += x;"),
        ("                        acc[S - 1] = fmaf(tr[qq][S - 1], x, "
         "acc[S - 1]);", "                        acc[S - 1] += x;")],
}

# --probe: the copy mechanisms alone, on fir_stream_f32's stream layout
PROBE_SRC = r"""
#include <cuda_runtime.h>

constexpr int kWarps = 4;
constexpr int kPitch = 33;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// MODE 0: the kernel's copies, 4-byte cp.async.ca, a warp copying each of
//         its 32 streams' chunk (coalesced) into a ring at pitch 33;
// MODE 1: a 1-D bulk copy (TMA engine) a lane of its own stream's chunk,
//         from the 16-byte boundary below, into its own buffer, completion
//         on an mbarrier a slot;
// MODE 2: 16-byte cp.async.cg a lane from its own stream.
// Each lane then reads its stream's chunk once from shared memory.
template <int MODE, int CH>
__global__ void __launch_bounds__(32 * kWarps)
    probe(const float* __restrict__ x, long long T, int nsr, long long seg,
          int chunks, float* out) {
    extern __shared__ __align__(128) float sm[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long id = ((long long)blockIdx.x * kWarps + warp) * 32 + lane;
    const long long row = id / nsr, g = id % nsr;
    const float* base = x + row * T + g * seg;
    constexpr int kBuf = CH + 4;  // MODE 1, 2: a lane's buffer, 16-B rows
    constexpr int kSlotW = MODE == 0 ? CH * kPitch : 32 * kBuf;
    float* ring = sm + warp * (2 * kSlotW + 8);
    unsigned long long* bar =
        reinterpret_cast<unsigned long long*>(ring + 2 * kSlotW);
    if (MODE == 1 && lane == 0) {
        for (int k = 0; k < 2; ++k)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         ::"r"(smem_u32(bar + k)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    auto issue = [&](int c) {
        float* slot = ring + (c & 1) * kSlotW;
        if (MODE == 0) {
            for (int s = 0; s < 32; ++s) {
                const float* b = reinterpret_cast<const float*>(
                    __shfl_sync(0xffffffffu, (unsigned long long)base, s));
                for (int i = 0; i < CH / 32; ++i) {
                    const unsigned d = smem_u32(
                        slot + (i * 32 + lane) * kPitch + s);
                    asm volatile(
                        "cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                        "l"(b + (long long)c * CH + i * 32 + lane)
                        : "memory");
                }
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        } else {
            const float* src = reinterpret_cast<const float*>(
                (unsigned long long)(base + (long long)c * CH) & ~15ull);
            float* dst = slot + lane * kBuf;
            if (MODE == 1) {
                const unsigned b = smem_u32(bar + (c & 1));
                if (lane == 0)
                    asm volatile(
                        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                        "%1;\n" ::"r"(b), "r"(32 * kBuf * 4) : "memory");
                __syncwarp();
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::"
                    "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                    ::"r"(smem_u32(dst)), "l"(src), "r"(kBuf * 4), "r"(b)
                    : "memory");
            } else {
                for (int i = 0; i < kBuf / 4; ++i)
                    asm volatile(
                        "cp.async.cg.shared.global [%0], [%1], 16;\n"
                        ::"r"(smem_u32(dst + 4 * i)), "l"(src + 4 * i)
                        : "memory");
                asm volatile("cp.async.commit_group;\n" ::: "memory");
            }
        }
    };
    float acc = 0.0f;
    issue(0);
    for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) issue(c + 1);
        else if (MODE != 1)
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (MODE == 1) {
            const unsigned b = smem_u32(bar + (c & 1));
            const unsigned par = (c >> 1) & 1;
            unsigned done = 0;
            while (!done)
                asm volatile(
                    "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::"
                    "cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                    : "=r"(done) : "r"(b), "r"(par) : "memory");
        } else {
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        }
        __syncwarp();
        const float* slot = ring + (c & 1) * kSlotW;
        for (int o = 0; o < CH; ++o)
            acc += MODE == 0 ? slot[o * kPitch + lane] : slot[lane * kBuf + o];
        __syncwarp();
    }
    out[id] = acc;
}

extern "C" int probe_run(int mode, int ch, const void* x, long long T,
                         int rows, int nsr, long long seg, int chunks,
                         int smem, void* out, void* stream) {
    const long long lanes = (long long)rows * nsr;
    const int blocks = (int)((lanes + 32 * kWarps - 1) / (32 * kWarps));
    void (*k)(const float*, long long, int, long long, int, float*) =
        mode == 0 ? (ch == 64 ? probe<0, 64> : probe<0, 128>)
        : mode == 1 ? (ch == 64 ? probe<1, 64> : probe<1, 128>)
                    : (ch == 64 ? probe<2, 64> : probe<2, 128>);
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    k<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const float*)x, T, nsr, seg, chunks, (float*)out);
    return (int)cudaGetLastError();
}
"""


def probe(dev):
    """Each copy mechanism alone on FreeDV's head layout (512 rows of
    1,000,000 samples, 64 streams a row 15,625 samples apart, each reading
    16,545), 2 or 3 blocks of 4 warps an SM: ms and GB/s copied."""
    import ctypes

    d = OUT / "probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE_SRC)
    so = d / "libprobe.so"
    finish("probe", subprocess.Popen(
        [kernels._nvcc(), *kernels._ARCH, *kernels._FLAGS, "-o", str(so),
         str(d / "probe.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_run.argtypes = [i, i, p, ll, i, i, ll, i, i, p, p]
    rows, T, nsr, seg = 512, 1_000_000, 64, 15_625
    # the last stream of the last row reads 924 samples past the rows
    x = torch.randn(rows * T + 4096, device=dev)
    out = torch.empty(rows * nsr, device=dev)
    res = {}
    for mode, name in ((0, "cp4_ca"), (1, "bulk"), (2, "cp16_cg")):
        for ch in (64, 128):
            chunks = (seg + 920) // ch
            slot_w = ch * 33 if mode == 0 else 32 * (ch + 4)
            need = 4 * 4 * (2 * slot_w + 8)
            for smem in sorted({max(96 * 1024, need), max(72 * 1024, need)},
                               reverse=True):
                def run():
                    err = lib.probe_run(
                        mode, ch, x.data_ptr(), T, rows, nsr, seg, chunks,
                        smem, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"probe {name}: error {err}")
                from chip_smoke import cuda_ms
                ms = cuda_ms(run)
                gb = rows * nsr * chunks * ch * 4 / 1e9
                key = f"{name} ch{ch} {228 * 1024 // (smem + 1024)} blocks/SM"
                res[key] = {"ms": ms, "GB/s": gb / ms * 1e3}
                print(f"probe {key}: {ms:.4f} ms, {gb / ms * 1e3:.0f} GB/s",
                      flush=True)
    return res



def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(tag, name, edits):
    """Start nvcc for csrc/<name>.cu with `edits` applied; returns (proc,
    library path)."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    for line, repl in edits:
        if src.count(line) != 1:
            raise RuntimeError(f"csrc/{name}.cu has no single `{line}`")
        src = src.replace(line, repl)
    d = OUT / tag
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.cu").write_text(src)
    so = d / f"lib{name}.so"
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels._ARCH, *kernels._FLAGS, "-o", str(so),
         str(d / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish(tag, proc, so):
    import ctypes

    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {tag}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def with_lib(name, lib, fn):
    """fn, its wrapper's kernel library swapped for lib while it runs."""
    def run():
        keep = kernels._loaded.get(name)
        kernels._loaded[name] = lib
        try:
            return fn()
        finally:
            kernels._loaded[name] = keep
    return run


def shape_taps(name, dev):
    from qradiolink_tpu_torch.chains.freedv import FreeDvDemod
    from qradiolink_tpu_torch.chains.fsk import Fsk4Demod

    rs = {"freedv_head": lambda: FreeDvDemod(device=dev).resamp,
          "fsk1kfm_head": lambda: Fsk4Demod(variant="1KFM",
                                            device=dev).resamp,
          "fsk100k_head": lambda: Fsk4Demod(variant="96K",
                                            device=dev).resamp}[name]()
    return rs.phase_taps[0]


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(smi(), flush=True)
    jobs = {}
    if args.variants:
        for tag, edits in VARIANTS.items():
            jobs[("fir", tag)] = build(tag, "fir", edits)
    if args.ablate:
        for (src, tag), edits in ABLATIONS.items():
            jobs[(src, f"ablate_{tag}")] = build(f"{src}_{tag}", src, edits)
    kjobs = [kernels._start(n) for n in ("fir", "fir_stream_v0")]
    for job in kjobs:
        for line in kernels._finish(*job).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {job[0]}: {line.strip()}", flush=True)
    libs = {k: finish(f"{k[0]} {k[1]}", *v) for k, v in jobs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi()}
    if args.probe:
        out["probe"] = probe(dev)
    for name in args.shapes.split(","):
        K, D, C, T = SHAPES[name]
        n_out = T // D
        tf = shape_taps(name, dev)
        assert tf.shape == (K,) and cuda_fir.route(K, D) == cuda_fir.OP
        xs = [torch.randn((C, T), generator=gen, device=dev)
              for _ in range(2)]
        st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])
        new = lambda: cuda_fir._launch_stream(xs, tf, D, n_out, tails)  # noqa
        old = lambda: cuda_fir.fir_stream_v0(xs, tf, D, n_out, tails)  # noqa
        plain = cuda_fir.fir_stream_plain(xs, tf, D, n_out, tails=tails)
        y_new, y_old = new(), old()
        err = check_fir(f"{cuda_fir.OP}/{name}", y_new, plain)
        check_fir(f"{cuda_fir.V0_OP}/{name}", y_old, plain)
        if not equal(y_new, y_old):
            raise RuntimeError(f"{name}: not bit-equal to v0")
        del plain, y_old
        torch.cuda.synchronize()
        ms, turns = turns_ms({"v0": old, "new": new})
        n_bytes = 4 * (2 * C * (T + K - 1 + n_out) + K)
        b, by = bound(n_bytes, 2 * K * 2 * C * n_out)
        res = {"K": K, "D": D, "rows": C, "T": T, "max_abs_err": err,
               "v0_ms": ms["v0"], "ms": ms["new"],
               "turns": [[k, t] for k, t in turns], "bound_ms": b,
               "bound_by": by, "pct_of_bound": 100 * b / ms["new"]}
        print(f"{name} K{K} D{D}: bit-equal; in turns v0 {ms['v0']:.4f} ms, "
              f"new {ms['new']:.4f} ms ({ms['v0'] / ms['new']:.2f}x); bound "
              f"{b:.4f} ms ({by}), {res['pct_of_bound']:.1f}%", flush=True)
        for (src, tag), lib in libs.items():
            if src == "fir":
                fn = with_lib("fir", lib, new)
                if not tag.startswith("ablate_") and not equal(fn(), y_new):
                    raise RuntimeError(f"{tag}/{name}: not bit-equal")
                vms, _ = turns_ms({"kernel": new, tag: fn})
            else:
                fn = with_lib("fir_stream_v0", lib, old)
                vms, _ = turns_ms({"v0": old, tag: fn})
            res[tag] = vms
            print(f"  {tag}: " + ", ".join(f"{k} {t:.4f} ms"
                                           for k, t in vms.items()),
                  flush=True)
        out[name] = res
        del xs, st, y_new
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
