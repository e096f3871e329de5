"""The integer-work bound of the mask kernels (``draw_masks``,
``draw_masks_gpt2``: ``csrc/train_block.cuh`` ``fill_mask``).

Each mask element costs one Philox4x32-10 draw (``csrc/common.cuh``
``philox_word0``): integer multiplies, xors and adds, which a byte bound
does not count. This tool reads the SASS of ``fill_mask`` from the built
library (``cuobjdump -sass``) and takes its drawing loop: of the loops
closed by a backward branch, the longest (the compiler gives the
keep-everything case, rate 0, a loop of its own). Within it, a region that
a predicated forward branch skips (the tensor-parallel index remap, skipped
where the site has no span) is counted apart; what is left runs once an
element. It counts those instructions by the pipe that runs them on
Hopper: the FMA-heavy pipe (``IMAD*``, ``IMUL*``), the integer / logic ALU
(``IADD3``, ``LOP3``, ``SHF``, ``ISETP`` and the rest), the load / store
unit, control. An H100 SM dispatches one warp instruction a clock on each of
its 4 schedulers (128 thread instructions a clock), and each scheduler's
FMA-heavy and ALU pipes take 16 lanes a clock (64 a clock an SM each). So
an element takes at least max(all / 128, fma-heavy / 64, alu / 64) SM
clocks, and a mask of E elements at least E times that over 132 SMs at the
card's maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).

Run on the card (it builds the kernels first):
    python3 -m afft_tpu_torch.tools.philox_bound [--sass-out FILE]
It prints one JSON line: the loop's counts by pipe, the clocks an element
takes, and the bound of each row's mask at the flagship's shapes beside its
byte bound.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

from ..ops import _build

SMS = 132
DISPATCH = 128     # thread instructions an SM dispatches a clock
PIPE = 64          # lanes a clock an SM of the FMA-heavy pipe, and the ALU
BYTES_PER_S = 3.35e12
# the masks at the flagship's training shapes: the fuser block (R 4096 rows
# of N 5, C 1024, 4 heads; five sites) and the GPT-2 layer (B 256, T 16, C
# 2048, 4 heads; three sites)
ROWS = {
    "10 draw_masks": 4096 * 4 * 5 * 5 + 2 * 4096 * 5 * 1024 + 2 * 4096,
    "16 draw_masks_gpt2": 256 * 4 * 16 * 16 + 2 * 256 * 16 * 2048,
}
FMA_HEAVY = ("IMAD", "IMUL")
LSU = ("STG", "LDG", "ST", "LD", "STS", "LDS", "LDC", "ULDC")
CONTROL = ("BRA", "EXIT", "CALL", "RET", "BSYNC", "BSSY", "BAR", "NOP",
           "WARPSYNC", "YIELD")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "cuobjdump") if home else None),
                 shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def function_sass(sass: str, name: str):
    """The instruction lines of each function whose symbol holds ``name``:
    {symbol: [(address, opcode, operands, predicated)]}."""
    out, current = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            current = head.group(1) if name in head.group(1) else None
            if current:
                out[current] = []
            continue
        if current is None:
            continue
        m = _INSTR.search(line)
        if m:
            out[current].append((int(m.group(1), 16), m.group(3),
                                 m.group(4), m.group(2) is not None))
    return out


def _target(args):
    t = _TARGET.search(args)
    return int(t.group(1), 16) if t else None


def drawing_loop(instrs):
    """(the instructions an element runs, those of the loop's skipped
    regions): the longest loop closed by a backward branch, less what its
    predicated forward branches skip inside it."""
    loops = [(t, addr) for addr, op, args, _ in instrs if op == "BRA"
             for t in [_target(args)] if t is not None and t < addr]
    if not loops:
        raise RuntimeError("no backward branch: the drawing loop not found")
    start, end = max(loops, key=lambda se: se[1] - se[0])
    body = [i for i in instrs if start <= i[0] <= end]
    skipped = set()
    for addr, op, args, predicated in body:
        t = _target(args) if op == "BRA" else None
        if predicated and t is not None and addr < t <= end:
            skipped.update(a for a, *_ in body if addr < a < t)
    return ([i for i in body if i[0] not in skipped],
            [i for i in body if i[0] in skipped])


def classify(body):
    counts = {"fma_heavy": 0, "alu": 0, "lsu": 0, "control": 0}
    for _, op, *_ in body:
        if op.startswith(FMA_HEAVY):
            counts["fma_heavy"] += 1
        elif op.startswith(LSU):
            counts["lsu"] += 1
        elif op in CONTROL:
            counts["control"] += 1
        else:
            counts["alu"] += 1
    counts["all"] = len(body)
    return counts


def sass_of(sass: str, symbol: str) -> str:
    """The raw SASS listing of one function."""
    lines, inside = [], False
    for line in sass.splitlines():
        if "Function : " in line:
            inside = symbol in line
        if inside:
            lines.append(line)
    return "\n".join(lines) + "\n"


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass-out", default=None,
                    help="write fill_mask's SASS to this file")
    args = ap.parse_args(argv)
    _build.library()
    lib = _build.build()
    sass = subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, timeout=600).stdout
    funcs = function_sass(sass, "fill_mask")
    if not funcs:
        raise RuntimeError("fill_mask not found in the library's SASS")
    # every .cu that includes train_block.cuh has its own static copy: the
    # same source, the same code
    symbol, instrs = sorted(funcs.items())[0]
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            f.write(sass_of(sass, symbol))
    run, skipped = drawing_loop(instrs)
    counts = classify(run)
    clocks = max(counts["all"] / DISPATCH, counts["fma_heavy"] / PIPE,
                 counts["alu"] / PIPE)
    hz = max_sm_clock_hz()
    rows = {}
    for row, elements in ROWS.items():
        ms = elements * clocks / (SMS * hz) * 1e3
        rows[row] = {"elements": elements, "integer_bound_ms": ms,
                     "byte_bound_ms": elements * 4 / BYTES_PER_S * 1e3}
    print(json.dumps({"symbol": symbol, "copies": len(funcs),
                      "loop_instructions": counts,
                      "skipped_region_instructions": len(skipped),
                      "sm_clocks_per_element": clocks,
                      "max_sm_clock_mhz": hz / 1e6, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
