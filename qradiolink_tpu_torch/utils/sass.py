"""What a built kernel issues: the opcode mix of its SASS.

    python -m qradiolink_tpu_torch.utils.sass fir_long 15

Builds csrc/<name>.cu if needed (utils/kernels.py), disassembles the
library with cuobjdump -sass (from the CUDA toolkit beside nvcc) and
prints, for each kernel instance whose mangled name holds `ILi<arg>E`
(every instance without an argument): its instruction count, the count
of each opcode, and each straight run of code between two branches (or a
branch and a reconvergence point, BSYNC) that holds 16 FFMAs or more,
with its length and its opcode mix. In an unrolled FIR loop those runs
are the rows, so their length is what a row issues. Needs nvcc, so it
runs on the machine with the card.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

from qradiolink_tpu_torch.utils import kernels

_INSN = re.compile(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def disassemble(name: str) -> str:
    kernels.load(name)
    cuobjdump = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass",
                           str(kernels._lib_path(name))], capture_output=True,
                          text=True, check=True).stdout


def functions(sass: str) -> dict[str, list[str]]:
    """Each kernel's mangled name and its opcodes, in order."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        lines = part.splitlines()
        out[lines[0].strip()] = [m.group(1) for m in map(_INSN.match, lines)
                                 if m]
    return out


def runs(ops: list[str], min_ffma: int = 16) -> list[collections.Counter]:
    """Opcode counts of each run between branches or reconvergence points
    with >= min_ffma FFMAs."""
    found, cur = [], collections.Counter()
    for op in ops + ["BRA"]:
        cur[op] += 1
        if op in ("BRA", "EXIT", "BSYNC"):
            if cur["FFMA"] >= min_ffma:
                found.append(cur)
            cur = collections.Counter()
    return found


def main(argv: list[str]) -> int:
    name = argv[0]
    tag = f"ILi{argv[1]}E" if len(argv) > 1 else ""
    for fn, ops in functions(disassemble(name)).items():
        if tag not in fn:
            continue
        print(f"{fn}: {len(ops)} instructions")
        print("  " + ", ".join(f"{op} {n}" for op, n in
                               collections.Counter(ops).most_common()))
        for r in runs(ops):
            print(f"  run of {sum(r.values())}: " + ", ".join(
                f"{op} {n}" for op, n in r.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
