"""The integer-work bound of the drop passes: the mask kernel of rows 10 and
16 (``draw_masks``, ``draw_masks_gpt2``: ``csrc/train_block.cuh``
``fill_masks_kernel``) and the backward entries' ``drop_grad``.

Each element costs one Philox4x32-10 draw (``csrc/common.cuh``
``philox_word0``): integer multiplies, xors and adds, which a byte bound
does not count. This tool reads the kernels' SASS from the built library
(``cuobjdump -sass``) and counts the instructions an element runs on each
pipe of Hopper: the FMA-heavy pipe (``IMAD*``, ``IMUL*``; ``IMAD.WIDE`` is
counted apart too), fp32 arithmetic (``FMUL``, ``FADD``, ``FFMA``), the
integer / logic ALU (``IADD3``, ``LOP3``, ``SHF``, ``ISETP``, ``FSEL`` and
the rest), the load / store unit, control.

The counted path: of the loops closed by a backward branch, take each
loop's best forward path (inner back edges not taken) from its head to its
backward branch: the most elements stored a turn (each global store's
bytes over the element's), then the most Philox multiplies (the
multipliers as immediates), then the fewest instructions. So the path
draws and skips what the drawing elements do not run: a keep-everything
route, a ragged tail, a 64-bit or remap route. The loop is the one whose
path writes the most elements, the innermost among equals (a tile loop,
not the loop over rows or sites around it). Its counts over its elements
are the counts an element. Where a loop divides 64-bit numbers (the
one-element-a-turn ``drop_grad<T>`` of earlier trees: i / C, row / tokens)
the fewest-instructions rule takes the division's call, not its inline
32-bit route, so that count is a floor.

An H100 SM dispatches one warp instruction a clock on each of its 4
schedulers (128 thread instructions a clock), each scheduler's FMA-heavy
and ALU pipes take 16 lanes a clock (64 a clock an SM each), and its two
FMA pipes together 32 (fp32 arithmetic on either, IMAD on the heavy one).
So an element takes at least ``sm_clocks``: max(all / 128, fma-heavy /
64, alu / 64, (fma-heavy + fp32) / 128) SM clocks, an IMAD.WIDE counted as
the FMA-heavy slots that ``--probe`` measures (``PROBE_SRC``; one without
it), and E elements at least E times that over 132 SMs at the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``). The byte bound
counts each element's bytes read and written once at 3.35 TB/s.

Run on the card (it builds the kernels first):
    python3 -m afft_tpu_torch.tools.philox_bound [--probe] \\
        [--parent-lib LIB] [--sass-out FILE]
``--parent-lib``: another tree's built library (the parent's), counted
beside this one's. It prints one JSON line: for each kernel its counts by
pipe, the clocks an element takes and each row's integer bound beside its
byte bound at the flagship's shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

SMS = 132
DISPATCH = 128     # thread instructions an SM dispatches a clock
PIPE = 64          # lanes a clock an SM of the FMA-heavy pipe, and the ALU
BYTES_PER_S = 3.35e12
# (elements, bytes an element) of each drop pass at the flagship's training
# shapes: the fuser block (R 4096 rows of N 5, C 1024, 4 heads; five mask
# sites, fp32 masks) and the GPT-2 layer (B 256, T 16, C 2048, 4 heads;
# three sites); drop_grad over one branch's (M, C) gradient, read and
# written in bf16
ROWS = {
    "10 draw_masks": (4096 * 4 * 5 * 5 + 2 * 4096 * 5 * 1024 + 2 * 4096, 4),
    "16 draw_masks_gpt2": (256 * 4 * 16 * 16 + 2 * 256 * 16 * 2048, 4),
    "drop_grad fuser": (4096 * 5 * 1024, 4),
    "drop_grad gpt2": (256 * 16 * 2048, 4),
}
# each row's kernel: (SASS symbol substrings of this tree's, of the
# one-element-a-turn kernels of earlier trees),
# and the bytes of the element its stores write
KERNELS = {
    "masks": (("17fill_masks_kernelE",), ("9fill_maskE",), 4),
    "drop_grad bf16": (("drop_gradI13__nv_bfloat16Li8E",),
                       ("drop_gradI13__nv_bfloat16E",), 2),
    "drop_grad fp32": (("drop_gradIfLi4E",), ("drop_gradIfE",), 4),
}
ROW_KERNEL = {"10 draw_masks": "masks", "16 draw_masks_gpt2": "masks",
              "drop_grad fuser": "drop_grad bf16",
              "drop_grad gpt2": "drop_grad bf16"}
FMA_HEAVY = ("IMAD", "IMUL")
# fp32 arithmetic: the FMA pipes, heavy and lite (128 lanes a clock an SM,
# the heavy pipe's share taken by IMAD)
FP32 = ("FMUL", "FADD", "FFMA", "FMNMX")
LSU = ("STG", "LDG", "ST", "LD", "STS", "LDS", "LDC", "ULDC")
CONTROL = ("BRA", "EXIT", "CALL", "RET", "BSYNC", "BSSY", "BAR", "NOP",
           "WARPSYNC", "YIELD")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
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
    {symbol: [(address, opcode, operands, predicated, suffixes)]}."""
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
                                 m.group(5), m.group(2) is not None,
                                 m.group(4)))
    return out


def _target(args):
    t = _TARGET.search(args)
    return int(t.group(1), 16) if t else None


def _loops(instrs):
    """(head, tail) address of each loop closed by a backward branch."""
    return [(t, addr) for addr, op, args, *_ in instrs if op == "BRA"
            for t in [_target(args)] if t is not None and t < addr]


# the Philox multipliers as cuobjdump prints them (signed or not)
PHILOX_CONSTANTS = ("-0x2daee0ad", "-0x326172a9", "0xd2511f53", "0xcd9e8d57")


def store_bytes(instr) -> int:
    """Bytes a thread's global store writes (0: not a global store)."""
    _, op, _, _, suffix = instr
    if op != "STG":
        return 0
    for width, nbytes in ((".128", 16), (".64", 8), (".U16", 2),
                          (".S16", 2), (".16", 2), (".U8", 1), (".S8", 1)):
        if width in suffix:
            return nbytes
    return 4


def _is_fma_heavy(instr) -> bool:
    return instr[1].startswith(FMA_HEAVY)


def _is_philox_multiply(instr) -> bool:
    return _is_fma_heavy(instr) and any(c in instr[2].lower()
                                        for c in PHILOX_CONSTANTS)


def _best_path(instrs, head, tail, elem_bytes):
    """The best forward path (inner back edges not taken) from the loop's
    head to its backward branch at ``tail``: the most elements stored,
    then the most Philox multiplies, then the fewest instructions;
    (elements, multiplies, -instructions, path) or None."""
    addrs = [i[0] for i in instrs]
    body = [i for i in instrs if head <= i[0] <= tail]
    # basic blocks: leaders at the head, at every branch target inside the
    # body and after every branch or exit
    leaders = {head}
    for addr, op, args, _, _ in body:
        if op in ("BRA", "EXIT"):
            nxt = [a for a in addrs if a > addr]
            if nxt:
                leaders.add(nxt[0])
            t = _target(args) if op == "BRA" else None
            if t is not None and head <= t <= tail:
                leaders.add(t)
    blocks, current = [], []
    for i in body:
        if i[0] in leaders and current:
            blocks.append(current)
            current = []
        current.append(i)
    blocks.append(current)
    start = {b[0][0]: k for k, b in enumerate(blocks)}
    best = [None] * len(blocks)
    best[0] = (0, 0, 0, [])
    found = None
    for k, block in enumerate(blocks):
        if best[k] is None:
            continue
        el, mul, neg, path = best[k]
        score = (el + sum(store_bytes(i) for i in block) / elem_bytes,
                 mul + sum(map(_is_philox_multiply, block)),
                 neg - len(block))
        path = path + block
        last = block[-1]
        t = _target(last[2]) if last[1] == "BRA" else None
        succ = []
        if last[1] == "BRA" and t is not None and t < last[0]:
            if last[0] == tail and (found is None or score > found[:3]):
                found = score + (path,)
            if last[3]:  # predicated: may fall through
                succ.append(k + 1)
        elif last[1] == "BRA":
            if t in start:
                succ.append(start[t])
            if last[3]:
                succ.append(k + 1)
        elif last[1] != "EXIT" or last[3]:
            succ.append(k + 1)
        for n in succ:
            if n < len(blocks) and (best[n] is None or
                                    score > best[n][:3]):
                best[n] = score + (path,)
    return found


def drawing_path(instrs, elem_bytes):
    """(the instructions of one thread's turn, the elements it writes): of
    the loops closed by a backward branch whose best path (``_best_path``)
    draws, the one that writes the most elements a turn, the innermost
    among equals. None where no loop draws."""
    chosen = None
    for head, tail in _loops(instrs):
        got = _best_path(instrs, head, tail, elem_bytes)
        if got is None or got[1] == 0 or got[0] == 0:
            continue
        key = (got[0], -(tail - head))
        if chosen is None or key > chosen[0]:
            chosen = (key, got)
    if chosen is None:
        return None
    return chosen[1][3], chosen[1][0]


def classify(body):
    counts = {"fma_heavy": 0, "imad_wide": 0, "fp32": 0, "alu": 0, "lsu": 0,
              "control": 0}
    for _, op, _, _, suffix in body:
        if op.startswith(FMA_HEAVY):
            counts["fma_heavy"] += 1
            counts["imad_wide"] += ".WIDE" in suffix
        elif op in FP32:
            counts["fp32"] += 1
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


def count_kernel(sass: str, names, elem_bytes: int):
    """The counts an element of the first function whose symbol holds one
    of ``names`` (``drawing_path``); None where no such function is in the
    SASS."""
    for name in names:
        funcs = function_sass(sass, name)
        if funcs:
            break
    else:
        return None
    # every .cu that includes train_block.cuh has its own static copy: the
    # same source, the same code
    symbol, instrs = sorted(funcs.items())[0]
    got = drawing_path(instrs, elem_bytes)
    if got is None:
        raise RuntimeError(f"{symbol}: no loop of it draws and stores")
    path, elements = got
    counts = classify(path)
    per = {k: v / elements for k, v in counts.items()}
    return {"symbol": symbol, "copies": len(funcs),
            "elements_a_turn": elements, "turn_instructions": counts,
            "philox_multiplies": sum(map(_is_philox_multiply, path)),
            "per_element": per}


def sm_clocks(per, wide_slots=1.0):
    """The SM clocks an element takes at least: dispatch, the FMA-heavy
    pipe (an IMAD.WIDE taking ``wide_slots`` of its issue slots), the ALU,
    and the FMA pipes together for IMAD and fp32 arithmetic."""
    heavy = per["fma_heavy"] + (wide_slots - 1.0) * per["imad_wide"]
    return max(per["all"] / DISPATCH, heavy / PIPE, per["alu"] / PIPE,
               (heavy + per["fp32"]) / (2 * PIPE))


# Chains of IMAD (a * M + s) and of IMAD.WIDE (hi + lo of a * M, with an
# IADD3 beside each), eight a thread: the second's time over the first's is
# the FMA-heavy pipe's issue slots an IMAD.WIDE takes (both are bound by
# that pipe at one slot: 8 slots and 16 dispatches a turn against 8 and 8).
PROBE_SRC = r"""
#include <cuda_runtime.h>
template <bool WIDE>
__global__ void probe(unsigned* out, unsigned seed, int iters) {
  unsigned a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = seed + threadIdx.x * 8u + k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (WIDE) {
        const unsigned long long p = (unsigned long long)a[k] * 0x9E3779B9u;
        a[k] = (unsigned)(p >> 32) + (unsigned)p;
      } else {
        a[k] = a[k] * 0x9E3779B9u + seed;
      }
    }
  }
  unsigned x = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

extern "C" float afft_probe(int wide, int blocks, int threads, int iters) {
  unsigned* out = nullptr;
  if (cudaMalloc(&out, sizeof(unsigned) * blocks * threads) != cudaSuccess)
    return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    for (int r = 0; r < 5; ++r) {
      if (wide) probe<true><<<blocks, threads>>>(out, 1u, iters);
      else probe<false><<<blocks, threads>>>(out, 1u, iters);
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms / 5 : -1.f;
}
"""


def wide_slots():
    """(the FMA-heavy issue slots an IMAD.WIDE takes, as measured by
    PROBE_SRC on this card, and both chains' ms and opcodes)."""
    import ctypes
    from ..ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "philox_probe.cu")
    lib = os.path.join(_build.BUILD_DIR, "libphilox_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True,
                   capture_output=True, timeout=600)
    fn = ctypes.CDLL(lib).afft_probe
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_int] * 4
    ms = {kind: fn(wide, SMS * 16, 128, 4096)
          for kind, wide in (("imad", 0), ("imad_wide", 1))}
    if min(ms.values()) <= 0:
        raise RuntimeError(f"the pipe probe failed: {ms}")
    ops = {}
    for sym, instrs in function_sass(library_sass(lib), "probe").items():
        kind = "imad_wide" if "ILb1E" in sym else "imad"
        ops[kind] = sorted({op + suffix for _, op, _, _, suffix in instrs
                            if op.startswith(FMA_HEAVY)})
    return ms["imad_wide"] / ms["imad"], {"ms": ms, "fma_heavy_ops": ops}


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def library_sass(lib: str) -> str:
    return subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, timeout=600).stdout


def bounds(sass: str, hz: float, which: int, wide=1.0):
    """Each kernel's counts and each row's bounds from one library's SASS;
    ``which``: 0 this tree's symbols, 1 those of earlier trees
    (``--parent-lib``); ``wide``: the FMA-heavy slots an IMAD.WIDE takes
    (``wide_slots``; 1 unless measured)."""
    kernels = {k: count_kernel(sass, names[which], names[2])
               for k, names in KERNELS.items()}
    for k in kernels.values():
        if k is not None:
            k["sm_clocks_per_element"] = sm_clocks(k["per_element"], wide)
    rows = {}
    for row, (elements, nbytes) in ROWS.items():
        k = kernels[ROW_KERNEL[row]]
        if k is None:
            continue
        rows[row] = {
            "elements": elements,
            "integer_bound_ms": elements * k["sm_clocks_per_element"]
            / (SMS * hz) * 1e3,
            "byte_bound_ms": elements * nbytes / BYTES_PER_S * 1e3}
    return {"kernels": kernels, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-lib", default=None,
                    help="another tree's built library, counted beside")
    ap.add_argument("--probe", action="store_true",
                    help="measure the FMA-heavy slots an IMAD.WIDE takes "
                         "(PROBE_SRC) and count them so")
    ap.add_argument("--sass-out", default=None,
                    help="write the mask kernel's SASS to this file")
    args = ap.parse_args(argv)
    from ..ops import _build
    _build.library()
    sass = library_sass(_build.build())
    hz = max_sm_clock_hz()
    wide, probe = wide_slots() if args.probe else (1.0, None)
    out = {"max_sm_clock_mhz": hz / 1e6, "imad_wide_slots": wide,
           "probe": probe, "new": bounds(sass, hz, 0, wide)}
    if args.sass_out:
        symbol = out["new"]["kernels"]["masks"]["symbol"]
        with open(args.sass_out, "w") as f:
            f.write(sass_of(sass, symbol))
    if args.parent_lib:
        psass = library_sass(args.parent_lib)
        out["parent"] = bounds(psass, hz, 1, wide)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
