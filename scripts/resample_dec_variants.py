"""resample_dec_f32 built with other constants, instance parameters or a
part of its design undone, timed in turns on one card.

    python scripts/resample_dec_variants.py [--shapes=A,B] [--sass] SPEC
        [SPEC ...]

Each SPEC is a comma-separated list of items:

    NAME=VALUE          a `constexpr int NAME = ...;` line of
                        qradiolink_tpu_torch/csrc/resample_dec.cu
    L/M/K:AS/CW/R/B/P   the instance X(L, M, K, ...) of QRL_DEC_INSTANCES
                        with AS tap rows a segment, CW columns a lane, R
                        chunk buffers, B blocks an SM for its launch
                        bounds and piece rule P (0 blocks an SM, 1 whole
                        waves)
    L/M/K:RPL/CR/R/B    the instance of QRL_DEC_SEQ_INSTANCES (the
                        taps-in-order form) with RPL rows a lane, CR rows
                        of M a chunk, R chunk buffers, B blocks an SM
    full-rows           every warp runs AS rows, none the short body
    src=PATH            another source (a path in the repo, for example an
                        earlier design unpacked under build/) in place of
                        csrc/resample_dec.cu, for the items after it
    ablate-PART         PART of the design taken away (PATCHES: lanesum,
                        barrier, stage, finish; the taps-in-order form's
                        seq-taps, seq-stage, seq-store, seq-shift): timed,
                        not checked
    seq-unroll          the taps-in-order form's column loops unrolled
                        whole

The empty SPEC "-" is the source as it stands. --shapes=A,B times only
the SHAPES whose names contain A or B. --sass prints, for each variant's
kernels, the count of SASS instructions by opcode (cuobjdump -sass): all,
FFMA, LDS, STS, BAR and the rest. For example

    python scripts/resample_dec_variants.py - 3/125/2091:9/2/3/1/0 full-rows

Every variant is built with nvcc for sm_90a (all at once) into
build/resample_dec_variants/. At the kernel's path shapes (SHAPES, 2
planes, the chains' taps) each variant's outputs must lie within the FIR's
bound of resample_poly_plain (chip_smoke.check_fir) and its state equal
it; the variants are then timed in turns (a, b, ..., b, a; device times by
CUDA events, chip_smoke.py's timer), at the L 1 heads with fir_long_f32,
which they ran on before, among them, and at the taps-in-order instances
resample_poly_f32, whose bits they keep (each variant's equality printed). Prints the card's name and power
limit first, each variant's ptxas lines and each median with the SM
clock nvidia-smi sampled over the shape's turns. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import check_fir, turns_ms  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_fir, cuda_resample  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402
from scripts.loop_chain_floor import sampled  # noqa: E402
from scripts.resample_dec_shapes import head_taps  # noqa: E402
from scripts.resample_up_variants import bind, call  # noqa: E402

# name: ((L, M, K), rows, input samples a row)
SHAPES = {
    "DMR head": ((3, 125, 2091), 2048, 200_000),
    "M17 head": ((3, 125, 349), 2048, 200_000),
    "MMDVM RX, sweep (256 rows)": ((12, 125, 523), 256, 250_000),
    "MMDVM RX, headless block": ((12, 125, 523), 1, 30_000),
    "4FSK10KFM head (256 rows)": ((2, 25, 105), 256, 200_000),
    "2FSK10K head (256 rows)": ((2, 25, 561), 256, 200_000),
    "2FSK10K head (2 rows)": ((2, 25, 561), 2, 10_000),
    "2FSK10K head (1 row)": ((2, 25, 561), 1, 125_000),
    "GMSK2K head (L 1)": ((1, 50, 2239), 2048, 200_000),
    "2FSK2K head (L 1, 256 rows)": ((1, 50, 2239), 256, 1_000_000),
    "SSB head (L 1)": ((1, 125, 5597), 2048, 200_000),
}

_SHORTEN = ("constexpr bool shorten = tap_rows(M, K) - (S - 1) * AS < AS "
            "&& S <= 2;")
PATCHES = {
    "full-rows": [(_SHORTEN, "constexpr bool shorten = false;")],
    # ablations, timed only (their outputs are wrong or racy): the lane
    # sum of one float4 in place of eight; no barrier a chunk; no staging
    # after the first chunks; no window of partials added and stored
    "ablate-lanesum": [("for (int b = 0; b < 8; ++b) {",
                        "for (int b = 0; b < 1; ++b) {")],
    "ablate-barrier": [("__syncthreads();            // for every thread; "
                        "chunk j - 1 done", "__syncwarp();")],
    "ablate-stage": [("if (j + R - 1 <= n_c) stage(j + R - 1);", ";")],
    "ablate-finish": [("if (j > 0) finish(j - 1);", ";")],
    # L and S at run time at L 1 too
    "runtime-ls": [("L == 1 ? L : 0, L == 1 ? S : 0>;", "0, 0>;")],
    # the taps-in-order form: its columns' loops unrolled whole
    "seq-unroll": [("#pragma unroll 5\n            for (int c = 0; c < KL",
                    "#pragma unroll\n            for (int c = 0; c < KL"),
                   ("#pragma unroll 5\n            for (int c = KL; c < M",
                    "#pragma unroll\n            for (int c = KL; c < M")],
    # its ablations, timed only: no tap loads (taps of 1); no staging after
    # the first chunks; no stores (kept live by a test that never holds);
    # the slots not moved up
    "ablate-seq-taps": [
        ("const float4 h = reinterpret_cast<const float4*>(tc)[a4];",
         "const float4 h = make_float4(1.0f, 1.0f, 1.0f, 1.0f);")],
    "ablate-seq-stage": [("if (j + R - 1 < n_c) stage(j + R - 1);\n"
                          "        cp_async_commit();\n        const float* b",
                          "cp_async_commit();\n        const float* b")],
    "ablate-seq-store": [("            if (t >= t_lo && t < t_hi) {\n"
                          "#pragma unroll\n                for (int q = 0; q < RPL",
                          "            if (t >= t_lo && t < t_hi && "
                          "acc[0][A - 1] == 12345.5f) {\n#pragma unroll\n"
                          "                for (int q = 0; q < RPL")],
    "ablate-seq-shift": [("for (int a = A - 1; a > 0; --a) acc[q][a] = "
                          "acc[q][a - 1];", ";")],
}


def variant_source(spec: str) -> str:
    src = (kernels.CSRC / "resample_dec.cu").read_text()
    for item in filter(None, spec.strip("-").split(",")):
        if item.startswith("src="):
            src = (ROOT / item[4:]).read_text()
        elif ":" in item:
            lmk, params = item.split(":")
            L, M, K = lmk.split("/")
            pat = re.compile(rf"X\({L}, {M}, {K}(, \d+)+\)")
            if len(pat.findall(src)) != 1:
                raise RuntimeError(f"no single instance {lmk}")
            src = pat.sub(f"X({L}, {M}, {K}, " + ", ".join(
                params.split("/")) + ")", src)
        elif "=" in item:
            name, value = item.split("=")
            line = re.compile(rf"constexpr int {name} = -?\d+;")
            if len(line.findall(src)) != 1:
                raise RuntimeError(f"no single {name}")
            src = line.sub(f"constexpr int {name} = {int(value)};", src)
        else:
            for old, new in PATCHES[item]:
                if src.count(old) != 1:
                    raise RuntimeError(f"{item} matches {src.count(old)} "
                                       f"times")
                src = src.replace(old, new)
    return src


def start_build(spec: str):
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec) or "base"
    out = ROOT / "build" / "resample_dec_variants" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / "resample_dec.cu").write_text(variant_source(spec))
    so = out / "libresample_dec.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels._ARCH,
                             *kernels._FLAGS, "-o", str(so),
                             str(out / "resample_dec.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return spec, so, proc


def sass_counts(so):
    """{kernel: {opcode class: count}} of a built library's SASS, with
    "body": the instructions from its first FFMA to its last (the
    unrolled row sums)."""
    cuobjdump = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if fn and m:
            op = m.group(1)
            key = op if op in ("FFMA", "LDS", "STS", "BAR", "LDGSTS") else \
                "other"
            c = out[fn]
            c[key] = c.get(key, 0) + 1
            c["all"] = c.get("all", 0) + 1
            if op == "FFMA":
                c.setdefault("_first", c["all"])
                c["body"] = c["all"] - c["_first"] + 1
    for c in out.values():
        c.pop("_first", None)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("resample_dec_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    picks = [a.split("=", 1)[1].split(",") for a in argv[1:]
             if a.startswith("--shapes=")]
    sass = "--sass" in argv[1:]
    specs = [a for a in argv[1:] if not a.startswith("--")] or ["-"]
    shapes = {k: v for k, v in SHAPES.items()
              if not picks or any(p in k for p in picks[0])}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    jobs = [start_build(s) for s in specs]
    libs = {}
    for spec, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
                print(f"  {spec}: {line.strip()}", flush=True)
        libs[spec] = bind(so, cuda_resample.DEC_OP)
        if sass:
            for fn, counts in sass_counts(so).items():
                print(f"  {spec}: SASS {fn}: {counts}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, ((L, M, K), C, T) in shapes.items():
        taps = head_taps((L, M, K), dev)
        xs = tuple(torch.randn((C, T), generator=gen, device=dev)
                   for _ in range(2))
        st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
        tails = (st[:, 0], st[:, 1])
        p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M,
                                                          tails)
        fns = {}
        for spec, lib in libs.items():
            state, ys = call(lib, xs, taps, L, M, tails)
            if "ablate-" not in spec:
                check_fir(f"{spec} at {name}", ys, p_ys)
                if not torch.equal(state, p_state):
                    raise RuntimeError(f"{spec} at {name}: state differs")
            fns[spec] = (lambda lib=lib: call(lib, xs, taps, L, M, tails))
        if (L, M, K) in cuda_resample.DEC_IN_ORDER:
            # the kernel whose sum order the taps-in-order form keeps:
            # each variant's bits compared, and it joins the turns
            want = cuda_resample.launch(cuda_resample.OP, xs, taps, L, M,
                                        tails)
            for spec, lib in libs.items():
                got = call(lib, xs, taps, L, M, tails)
                same = all(torch.equal(a, b) for a, b in
                           zip((got[0], *got[1]), (want[0], *want[1])))
                print(f"  {spec} at {name}: bit-equal to "
                      f"{cuda_resample.OP}: {same}", flush=True)
            fns[cuda_resample.OP] = (lambda: cuda_resample.launch(
                cuda_resample.OP, xs, taps, L, M, tails))
            del want, got
        if L == 1:
            # the strided FIR kernel the L 1 heads ran before
            tf, n_out = taps[0], T // M
            ys = cuda_fir.fir_long(xs, tf, M, n_out, tails)
            check_fir(f"{cuda_fir.LONG_OP} at {name}", ys, p_ys)
            fns[cuda_fir.LONG_OP] = (lambda: cuda_fir.fir_long(
                xs, tf, M, n_out, tails))
        del p_ys, p_state, ys, state
        (ms, _), mhz = sampled(lambda: turns_ms(fns))
        print(f"{name} L{L} M{M} K{K} 2x{C}x{T}: " + ", ".join(
            f"[{spec}] {t:.4f} ms" for spec, t in ms.items())
            + f" (SM clock {mhz} MHz)", flush=True)
        del xs, st, tails, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
