#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afft_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  - the card's name and power limit (nvidia-smi), TF32 off;
  2. build   - compile afft_tpu_torch/csrc with nvcc for sm_90a;
  3. kernels - each kernel (fused_block, gpt2_attn_half, gpt2_mlp_half,
               fused_attention, fused_seq_block, fused_decoder_block)
               against its plain PyTorch version on the card, in bf16 at the
               shapes of the served paths and in fp32 at a reduced batch,
               and at edge shapes; its time beside the plain version's, a
               cuBLAS + SDPA composition of the same function, and the least
               time the card could take;
  4. serve   - the Server on five paths at full width (bf16, batch 256,
               seeded weights): the flagship
               expts/01_SA-Fuser_ek100_val_Swin.txt, its multi-step rollout
               (model.common.fp_output_len=4, the KV cache), and expts 02
               (SA-Fuser without token), 03 (T-SA-Fuser) and 04 (CA-Fuser).
               Each answers 4 requests through the kernels with the expected
               launch counts, and is held against the same model run through
               the plain versions, in bf16 and in fp32 at batch 32; the bf16
               top-1 flips of both paths against the plain path in fp32;
               clips/s, ms per batch and the device time by kernel group
               (torch.profiler). In fp32 the rollout also equals the full
               re-run of every step on the plain path;
  5. report  - one JSON line of per-kernel numbers, then the result line.

Imports torch and afft_tpu_torch only (no JAX).
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
EXPTS = os.path.join(REPO, "expts")
FLAGSHIP = os.path.join(EXPTS, "01_SA-Fuser_ek100_val_Swin.txt")
ROLLOUT_LEN = 4
SERVE_BATCH = 256
SERVE_REQUESTS = 4
FP32_BATCH = 32

# Published dense peaks of the H100 SXM (NVIDIA data sheet; its device name
# reads "NVIDIA H100 80GB HBM3"): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"H100": {"bf16": 989e12, "bytes": 3.35e12}}

# bf16 kernel vs plain: both round the same intermediates (qkv, LN outputs,
# attention output, MLP hidden) to bf16; a different fp32 summation order
# flips some of those roundings by one ulp (2^-8 relative), which the rest
# of the block carries. Bound: 1e-2 of the output's largest magnitude
# (~2.5 ulps there). fp32: only the summation order differs.
KERNEL_TOL = {"bf16": 1e-2, "fp32": 1e-5}


def log(*args):
    print(*args, flush=True)


def peaks_for(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(fn, iters=25, warmup=3):
    """Median of per-launch CUDA-event times, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got, want):
    d = (got.float() - want.float()).abs()
    finite = bool(got.float().isfinite().all())
    max_abs = d.max().item()
    return finite, max_abs, max_abs / max(want.float().abs().max().item(),
                                          1e-30)


# -- inputs and yardsticks for the kernel phase -------------------------------

def _randn(gen, dt):
    import torch

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dt)
    return rn


def _norms(p, names, C, rn):
    for norm in names:
        p[f"{norm}.weight"] = 1 + rn(C, std=0.1)
        p[f"{norm}.bias"] = rn(C, std=0.1)


def block_params(C, hidden, dt, gen, affine=True, qkv_bias=False):
    rn = _randn(gen, dt)
    p = {"attn.qkv.weight": rn(3 * C, C, std=0.02),
         "attn.proj.weight": rn(C, C, std=0.02),
         "attn.proj.bias": rn(C, std=0.02),
         "mlp.mlp.0.weight": rn(hidden, C, std=0.02),
         "mlp.mlp.0.bias": rn(hidden, std=0.02),
         "mlp.mlp.2.weight": rn(C, hidden, std=0.02),
         "mlp.mlp.2.bias": rn(C, std=0.02)}
    if affine:
        _norms(p, ("norm1", "norm2"), C, rn)
    if qkv_bias:
        p["attn.qkv.bias"] = rn(3 * C, std=0.02)
    return p


def decoder_params(C, hidden, dt, gen, affine=True, qkv_bias=False):
    rn = _randn(gen, dt)
    p = block_params(C, hidden, dt, gen, affine=False, qkv_bias=qkv_bias)
    for k in ("w_q", "w_k", "w_v", "proj"):
        p[f"cross_attn.{k}.weight"] = rn(C, C, std=0.02)
        if qkv_bias or k == "proj":
            p[f"cross_attn.{k}.bias"] = rn(C, std=0.02)
    if affine:
        _norms(p, ("norm_self", "norm_q", "norm_kv", "norm_mlp"), C, rn)
    return p


def gpt2_params(C, hidden, dt, gen):
    rn = _randn(gen, dt)
    return {"ln_1.weight": 1 + rn(C, std=0.1), "ln_1.bias": rn(C, std=0.1),
            "attn.c_attn.weight": rn(C, 3 * C, std=0.02),
            "attn.c_attn.bias": rn(3 * C, std=0.02),
            "attn.c_proj.weight": rn(C, C, std=0.02),
            "attn.c_proj.bias": rn(C, std=0.02),
            "ln_2.weight": 1 + rn(C, std=0.1), "ln_2.bias": rn(C, std=0.1),
            "mlp.c_fc.weight": rn(C, hidden, std=0.02),
            "mlp.c_fc.bias": rn(hidden, std=0.02),
            "mlp.c_proj.weight": rn(hidden, C, std=0.02),
            "mlp.c_proj.bias": rn(C, std=0.02)}


def rollout_operands(B, n_new, pos, t_max, H, hd, dt, gen):
    """What the cached GPT-2 block hands the attention: q as a column slice
    of the packed c_attn output, the (B, Tmax, H, hd) caches read whole, and
    the mask that hides the slots after each query's position."""
    import torch
    rn = _randn(gen, dt)
    q = rn(B, n_new, 3, H, hd)[:, :, 0]
    kc, vc = rn(B, t_max, H, hd), rn(B, t_max, H, hd)
    key_pos = torch.arange(t_max, device="cuda")[None, :]
    query_pos = pos + torch.arange(n_new, device="cuda")[:, None]
    mask = torch.zeros((n_new, t_max), device="cuda").masked_fill(
        key_pos > query_pos, float("-inf"))
    return q, kc, vc, mask


def tiled_causal_mask(frames, mods):
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    return neg_inf_causal_mask(frames, device="cuda").repeat(mods, mods)


def _sdpa(q, k, v, mask):
    """(B, N, H, hd) operands through F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    keep = None if mask is None else mask == 0
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=keep).transpose(1, 2)


def library_block(x, p, H, eps, mask=None):
    """A pre-LN block as cuBLAS GEMMs + SDPA in the working dtype."""
    import torch.nn.functional as F
    R, N, C = x.shape
    h = F.layer_norm(x, (C,), p["norm1.weight"], p["norm1.bias"], eps)
    q, k, v = F.linear(h, p["attn.qkv.weight"]).view(R, N, 3, H,
                                                     C // H).unbind(2)
    y = x + F.linear(_sdpa(q, k, v, mask).reshape(R, N, C),
                     p["attn.proj.weight"], p["attn.proj.bias"])
    h = F.layer_norm(y, (C,), p["norm2.weight"], p["norm2.bias"], eps)
    h = F.gelu(F.linear(h, p["mlp.mlp.0.weight"], p["mlp.mlp.0.bias"]))
    return y + F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])


def library_decoder_block(x, mem, p, H, eps, mask):
    import torch.nn.functional as F
    B, S, C = x.shape

    def ln(t, name):
        return F.layer_norm(t, (C,), p[f"{name}.weight"], p[f"{name}.bias"],
                            eps)

    def heads(t):
        return t.view(B, S, H, C // H)
    q, k, v = F.linear(ln(x, "norm_self"), p["attn.qkv.weight"]).view(
        B, S, 3, H, C // H).unbind(2)
    x = x + F.linear(_sdpa(q, k, v, mask).reshape(B, S, C),
                     p["attn.proj.weight"], p["attn.proj.bias"])
    qn, kn = ln(x, "norm_q"), ln(mem, "norm_kv")
    cross = _sdpa(heads(F.linear(qn, p["cross_attn.w_q.weight"])),
                  heads(F.linear(kn, p["cross_attn.w_k.weight"])),
                  heads(F.linear(kn, p["cross_attn.w_v.weight"])), mask)
    x = x + F.linear(cross.reshape(B, S, C), p["cross_attn.proj.weight"],
                     p["cross_attn.proj.bias"])
    h = F.gelu(F.linear(ln(x, "norm_mlp"), p["mlp.mlp.0.weight"],
                        p["mlp.mlp.0.bias"]))
    return x + F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])


def library_attn_half(x, p, H, eps):
    import torch.nn.functional as F
    B, T, C = x.shape
    h = F.layer_norm(x, (C,), p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = h @ p["attn.c_attn.weight"] + p["attn.c_attn.bias"]
    q, k, v = qkv.view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return x + (a.transpose(1, 2).reshape(B, T, C) @ p["attn.c_proj.weight"]
                + p["attn.c_proj.bias"])


def library_mlp_half(y, p, eps):
    import torch.nn.functional as F
    C = y.shape[-1]
    h = F.layer_norm(y, (C,), p["ln_2.weight"], p["ln_2.bias"], eps)
    h = F.gelu(h @ p["mlp.c_fc.weight"] + p["mlp.c_fc.bias"],
               approximate="tanh")
    return y + h @ p["mlp.c_proj.weight"] + p["mlp.c_proj.bias"]


def work(name, shape, C, H, hidden, itemsize):
    """(flops, bytes) the function must do and move: each input read once,
    each output written once."""
    if name == "fused_block":
        R, N = shape
        M = R * N
        flops = 2 * M * C * (4 * C + 2 * hidden) + 4 * R * N * N * C
        params = 4 * C * C + 2 * C * hidden + 9 * C + hidden
        return flops, (2 * M * C + params) * itemsize
    B, T = shape
    M = B * T
    if name == "gpt2_attn_half":
        flops = 2 * M * C * 4 * C + 4 * B * T * T * C
        params = 4 * C * C + 6 * C
        return flops, (2 * M * C + params) * itemsize + T * T * 4
    flops = 2 * M * C * 2 * hidden
    params = 2 * C * hidden + hidden + 3 * C
    return flops, (2 * M * C + params) * itemsize


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_work(q, k, v, mask):
    """What this mask needs: the products of the visible (query, key) pairs
    only, and the k / v rows that some query sees."""
    B, n_q, H, hd = q.shape
    visible = mask.isfinite()
    pairs = int(visible.sum())
    keys = int(visible.any(dim=0).sum())
    flops = 4 * B * H * hd * pairs
    item = q.element_size()
    return flops, (2 * B * n_q + 2 * B * keys) * H * hd * item + _nbytes(mask)


def block_work(x, p, mask, macs_per_row, n_attn, streams):
    """A block over x (B, S, C): its GEMMs (``macs_per_row`` multiply-adds a
    row in all), the visible pairs of its ``n_attn`` attention stages, and
    the bytes of its ``streams`` activation tensors (inputs and output), its
    parameters and its mask."""
    B, S, C = x.shape
    pairs = int(mask.isfinite().sum())
    flops = 2 * B * S * macs_per_row + n_attn * 4 * B * C * pairs
    return flops, streams * _nbytes(x) + _nbytes(*p.values(), mask)


# Each case builds its operands for a dtype and a size ("full": the shape of
# the served path at batch 256; "small": the reduced batch for fp32) and
# returns the three callables (kernel, plain, library) and the work.

def case_fused_block(frames, N, dt, size, gen):
    """A per-timestep fuser's block: one row of N tokens a frame."""
    from afft_tpu_torch.ops import fused_block as FB
    R, C, H, hidden, eps = ((256 if size == "full" else 32) * frames, 1024,
                            4, 4096, 1e-6)
    p = block_params(C, hidden, dt, gen)
    x = _randn(gen, dt)(R, N, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FB.fused_block(x, p, None, num_heads=H, eps=eps),
        plain=lambda: FB.fused_block_plain(x, p, None, num_heads=H, eps=eps),
        library=lambda: library_block(x, p, H, eps),
        work=work("fused_block", (R, N), C, H, hidden, x.element_size()))


def _case_gpt2(half, T, dt, size, gen):
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_gpt2 as FG
    B, C, H, hidden, eps = (256 if size == "full" else 32, 2048, 4, 8192,
                            1e-5)
    p = gpt2_params(C, hidden, dt, gen)
    mask = neg_inf_causal_mask(T, device="cuda")
    x = _randn(gen, dt)(B, T, C)
    if half == "gpt2_attn_half":
        fns = (lambda: FG.gpt2_attn_half(x, p, mask, num_heads=H, eps=eps),
               lambda: FG.gpt2_attn_half_plain(x, p, mask, num_heads=H,
                                               eps=eps),
               lambda: library_attn_half(x, p, H, eps))
    else:
        fns = (lambda: FG.gpt2_mlp_half(x, p, eps=eps),
               lambda: FG.gpt2_mlp_half_plain(x, p, eps=eps),
               lambda: library_mlp_half(x, p, eps))
    return dict(shape=tuple(x.shape), kernel=fns[0], plain=fns[1],
                library=fns[2],
                work=work(half, (B, T), C, H, hidden, x.element_size()))


def _case_attention(n_new, pos, dt, size, gen):
    """The rollout of the flagship, fp_output_len = 4: 16 frames, 19 cache
    slots, 4 heads of 512."""
    from afft_tpu_torch.ops import attention as FA
    B = 256 if size == "full" else 32
    q, kc, vc, mask = rollout_operands(B, n_new, pos, 16 + ROLLOUT_LEN - 1,
                                       4, 512, dt, gen)
    return dict(shape=(tuple(q.shape), tuple(kc.shape)),
                kernel=lambda: FA.fused_attention(q, kc, vc, mask),
                plain=lambda: FA.attention_plain(q, kc, vc, mask)[0],
                library=lambda: _sdpa(q, kc, vc, mask),
                work=attention_work(q, kc, vc, mask))


def case_seq_block(frames, dt, size, gen):
    """4 modalities x frames, C 1024, 4 heads of 256, hidden 4096."""
    from afft_tpu_torch.ops import fused_seq_block as FS
    B, S, C, H, hidden, eps = (256 if size == "full" else 32, 4 * frames,
                               1024, 4, 4096, 1e-6)
    p = block_params(C, hidden, dt, gen)
    mask = tiled_causal_mask(frames, 4)
    x = _randn(gen, dt)(B, S, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FS.fused_seq_block(x, p, mask, num_heads=H, eps=eps),
        plain=lambda: FS.fused_seq_block_plain(x, p, mask, num_heads=H,
                                               eps=eps),
        library=lambda: library_block(x, p, H, eps, mask),
        work=block_work(x, p, mask, C * (4 * C + 2 * hidden), 1, 2))


def case_decoder_block(dt, size, gen):
    """expt 04: 10 frames, C 1024, 4 heads, hidden 4096."""
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_seq_block as FS
    B, S, C, H, hidden, eps = (256 if size == "full" else 32, 10, 1024, 4,
                               4096, 1e-6)
    p = decoder_params(C, hidden, dt, gen)
    mask = neg_inf_causal_mask(S, device="cuda")
    rn = _randn(gen, dt)
    x, mem = rn(B, S, C), rn(B, S, C)
    return dict(
        shape=tuple(x.shape),
        kernel=lambda: FS.fused_decoder_block(x, mem, p, mask, num_heads=H,
                                              eps=eps),
        plain=lambda: FS.fused_decoder_block_plain(x, mem, p, mask,
                                                   num_heads=H, eps=eps),
        library=lambda: library_decoder_block(x, mem, p, H, eps, mask),
        work=block_work(x, p, mask, C * (8 * C + 2 * hidden), 2, 3))


# name, source, the TPU kernel it replaces, the case. A name with "/" is a
# further shape of the kernel before the slash: the first entry of a kernel
# is the shape of the first served path that runs it, the others are the
# shapes the other served paths give it (and, for fused_seq_block, S = 128
# at full width, 4 x 32 frames); their numbers are reported under the label
# after the slash.
KERNEL_CASES = [
    ("fused_block", "afft_tpu_torch/csrc/fused_block.cu",
     "afft_tpu/ops/pallas_block.py:120",
     lambda *a: case_fused_block(16, 5, *a)),         # flagship, rollout
    ("fused_block/expt02", None, None,
     lambda *a: case_fused_block(10, 4, *a)),         # SA-Fuser w/o token
    ("gpt2_attn_half", "afft_tpu_torch/csrc/fused_gpt2.cu",
     "afft_tpu/ops/pallas_gpt2.py:100",
     lambda *a: _case_gpt2("gpt2_attn_half", 16, *a)),
    ("gpt2_attn_half/t10", None, None,                # expts 02, 03, 04
     lambda *a: _case_gpt2("gpt2_attn_half", 10, *a)),
    ("gpt2_mlp_half", "afft_tpu_torch/csrc/fused_gpt2.cu",
     "afft_tpu/ops/pallas_gpt2.py:140",
     lambda *a: _case_gpt2("gpt2_mlp_half", 16, *a)),
    ("gpt2_mlp_half/t10", None, None,
     lambda *a: _case_gpt2("gpt2_mlp_half", 10, *a)),
    ("fused_attention", "afft_tpu_torch/csrc/attention.cu",
     "afft_tpu/ops/pallas_attn.py:42",
     lambda *a: _case_attention(16, 0, *a)),          # prefill
    ("fused_attention/decode", None, None,
     lambda *a: _case_attention(1, 16, *a)),          # first decode step
    ("fused_seq_block", "afft_tpu_torch/csrc/seq_block.cu",
     "afft_tpu/ops/pallas_seq_block.py:135",
     lambda *a: case_seq_block(10, *a)),              # expt 03, S = 40
    ("fused_seq_block/s128", None, None,
     lambda *a: case_seq_block(32, *a)),              # S = 128, hd = 256
    ("fused_decoder_block", "afft_tpu_torch/csrc/seq_block.cu",
     "afft_tpu/ops/pallas_seq_block.py:156", case_decoder_block),
]


def check_edge_shapes(gen):
    """Each kernel against its plain version at the edges of its limits:
    ragged row and column tiles, K not a multiple of the GEMM's k-tile,
    1 and the most tokens (1,024 keys for the attention and the sequence
    blocks), odd sequence lengths, Nq != Nk, head dims that are not
    multiples of 32, the optional LayerNorm affines, biases and mask; and
    the CrossAttention layer, whose attention is the kernel, with a memory
    stream of another length and width."""
    import torch
    from afft_tpu_torch.models.layers import (CrossAttention,
                                              cross_attention_diag_mask,
                                              neg_inf_causal_mask)
    from afft_tpu_torch.ops import (attention as FA, fused_block as FB,
                                    fused_gpt2 as FG, fused_seq_block as FS)

    n = 0
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rn = _randn(gen, dt)
        for R, N, C, H, hidden, diag, affine, qkv_bias in (
                (1, 1, 64, 8, 256, False, True, False),
                (37, 8, 96, 4, 384, True, False, True),
                (130, 3, 40, 5, 72, True, True, True)):
            p = block_params(C, hidden, dt, gen, affine, qkv_bias)
            mask = cross_attention_diag_mask(N, device="cuda") if diag \
                else None
            x = rn(R, N, C)
            got = FB.fused_block(x, p, mask, num_heads=H)
            want = FB.fused_block_plain(x, p, mask, num_heads=H)
            n += _edge_ok(f"fused_block {tag} R={R} N={N} C={C} H={H} "
                          f"hidden={hidden}", tag, got, want)
        for B, T, C, H, hidden in ((1, 1, 64, 8, 256), (3, 32, 96, 4, 200),
                                   (5, 7, 40, 5, 72)):
            p = gpt2_params(C, hidden, dt, gen)
            mask = neg_inf_causal_mask(T, device="cuda")
            x = rn(B, T, C)
            n += _edge_ok(f"gpt2_attn_half {tag} B={B} T={T} C={C} H={H}",
                          tag, FG.gpt2_attn_half(x, p, mask, num_heads=H),
                          FG.gpt2_attn_half_plain(x, p, mask, num_heads=H))
            n += _edge_ok(f"gpt2_mlp_half {tag} B={B} T={T} C={C} "
                          f"hidden={hidden}", tag, FG.gpt2_mlp_half(x, p),
                          FG.gpt2_mlp_half_plain(x, p))
        # attention: B, Nq, Nk, H, hd, mask kind; q, k, v strided or not
        for B, n_q, n_k, H, hd, kind in (
                (3, 1, 1, 2, 8, None), (2, 1, 128, 3, 24, "cache"),
                (5, 32, 128, 2, 256, "cache"), (2, 9, 9, 1, 512, "causal"),
                (7, 17, 33, 4, 40, None), (1, 32, 1, 2, 8, None),
                (2, 32, 1024, 2, 64, "cache"),
                (1, 1024, 1024, 2, 16, "causal")):
            if kind == "cache":
                q, k, v, mask = rollout_operands(B, n_q, n_k - n_q - 2, n_k,
                                                 H, hd, dt, gen)
            else:
                q, k, v = rn(B, n_q, H, hd), rn(B, n_k, H, hd), \
                    rn(B, n_k, H, hd)
                mask = neg_inf_causal_mask(n_q, device="cuda") if kind \
                    else None
            n += _edge_ok(f"fused_attention {tag} B={B} Nq={n_q} Nk={n_k} "
                          f"H={H} hd={hd} mask={kind}", tag,
                          FA.fused_attention(q, k, v, mask),
                          FA.attention_plain(q, k, v, mask)[0])
        # the temporal fusers' blocks: B, S (frames x mods), C, H, hidden
        for B, frames, mods, C, H, hidden, affine, qkv_bias in (
                (1, 9, 1, 64, 8, 256, True, False),
                (3, 43, 3, 96, 4, 384, False, True),
                (2, 127, 1, 40, 5, 72, True, True),
                (2, 32, 4, 1024, 4, 512, True, False),
                (1, 1024, 1, 64, 4, 128, True, True)):
            S = frames * mods
            mask = tiled_causal_mask(frames, mods)
            x, mem = rn(B, S, C), rn(B, S, C)
            p = block_params(C, hidden, dt, gen, affine, qkv_bias)
            n += _edge_ok(f"fused_seq_block {tag} B={B} S={S} C={C} H={H} "
                          f"hidden={hidden}", tag,
                          FS.fused_seq_block(x, p, mask, num_heads=H),
                          FS.fused_seq_block_plain(x, p, mask, num_heads=H))
            p = decoder_params(C, hidden, dt, gen, affine, qkv_bias)
            n += _edge_ok(f"fused_decoder_block {tag} B={B} S={S} C={C} "
                          f"H={H} hidden={hidden}", tag,
                          FS.fused_decoder_block(x, mem, p, mask,
                                                 num_heads=H),
                          FS.fused_decoder_block_plain(x, mem, p, mask,
                                                       num_heads=H))
        # the layer on the card (w_q / w_k / w_v / proj in cuBLAS around
        # fused_attention) against the same layer on the CPU (all plain)
        layer = CrossAttention(64, 4, mem_dim=40, qkv_bias=True)
        layer.reset_parameters(torch.Generator().manual_seed(0))
        x, mem = rn(3, 7, 64), rn(3, 11, 40)
        want = layer.to(dt)(x.cpu(), mem.cpu())
        before = FA.LAUNCHES["fused_attention"]
        got = layer.to("cuda")(x, mem)
        if FA.LAUNCHES["fused_attention"] != before + 1:
            raise AssertionError("CrossAttention did not launch the kernel")
        n += _edge_ok(f"CrossAttention {tag} N=7 M=11 mem_dim=40", tag,
                      got.cpu(), want)
    log(f"kernels: {n} edge-shape checks agree with the plain versions")


def _edge_ok(what, tag, got, want):
    import torch
    torch.cuda.synchronize()
    finite, max_abs, rel = errors(got, want)
    if not (finite and rel <= KERNEL_TOL[tag]):
        raise AssertionError(f"{what}: max_abs_err={max_abs:.6g} rel_err="
                             f"{rel:.3g} (tol {KERNEL_TOL[tag]:g}) finite="
                             f"{finite}")
    return 1


def phase_kernels(peaks):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.no_grad():
        check_edge_shapes(gen)
    results = {}
    for name, source, replaces, make in KERNEL_CASES:
        numbers = {}
        for tag, dt, size in (("fp32", torch.float32, "small"),
                              ("bf16", torch.bfloat16, "full")):
            case = make(dt, size, gen)
            kernel, plain, library = (case["kernel"], case["plain"],
                                      case["library"])
            with torch.no_grad():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
            finite, max_abs, rel = errors(got, want)
            ok = finite and rel <= KERNEL_TOL[tag]
            log(f"kernel {name} {tag} shape={case['shape']}: max_abs_err="
                f"{max_abs:.6g} rel_err={rel:.3g} (tol {KERNEL_TOL[tag]:g} "
                f"of max|ref|) finite={finite} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {tag} disagrees with its plain "
                                     "version")
            if tag != "bf16":
                continue
            with torch.no_grad():
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, iters=20)
                library_ms = time_ms(library)
            flops, nbytes = case["work"]
            t_ops = flops / peaks["bf16"] * 1e3
            t_bytes = nbytes / peaks["bytes"] * 1e3
            numbers.update(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)
            log(f"kernel {name} bf16 kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms="
                f"{numbers['bound_ms']:.4f} ({numbers['bound_by']}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                f"achieved={flops / ms / 1e9:.1f} TFLOP/s "
                f"{nbytes / ms / 1e6:.1f} GB/s")
        if "/" in name:
            main, shape = name.split("/")
            results[main][shape] = numbers
        else:
            results[name] = dict(name=name, route="cuda", source=source,
                                 replaces=replaces, **numbers)
    return results


# -- the main path ------------------------------------------------------------

def profile_forward(fn):
    """Device ms by kernel group over one forward (torch.profiler), and the
    device's busy share of the forward's host wall time. Fails when the
    profiler sees no device work."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device events")
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        # gemm_bf16<EPI, B_KN, ...>: EPI 0 bias, 1 bias + residual,
        # 2 exact GELU, 3 gelu_new; B_KN true = Conv1D (GPT-2) weights
        m = re.search(r"afft::(\w+)(?:<(\d+), (true|false))?", e.name)
        if m is None:
            group = "other (PyTorch ops)"
        elif m.group(2) is None:
            group = m.group(1)
        else:
            group = (f"{m.group(1)}<epi {m.group(2)}, "
                     f"{'gpt2' if m.group(3) == 'true' else 'fuser'}>")
        groups[group] = groups.get(group, 0.0) + us
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
    busy = sum(groups.values())
    log(f"profile: one bf16 forward, device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms host wall (busy share "
        f"{busy / wall_us:.3f}, profiler on)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {us / 1e3:9.3f} ms  {us / busy:6.1%}  {group}")
    other = sorted(((n, us) for n, us in names.items() if "afft::" not in n),
                   key=lambda kv: -kv[1])[:6]
    for n, us in other:
        log(f"profile:     other {us / 1e3:8.3f} ms  {n}")
    return {"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
            "busy_share": busy / wall_us,
            "groups_ms": {g: us / 1e3 for g, us in groups.items()}}


def top1_report(logits, plain):
    """The three-part bf16 top-1 form on (rows, classes) logits: agreement
    on the rows whose plain top-1 leads by more than 2 bf16 ulps, the kernel
    path's pick within 2 ulps of the plain top-1 on every row, and enough
    decided rows. Returns (ok, text)."""
    import torch
    agree = logits.argmax(-1) == plain.argmax(-1)
    # the logits are bf16 values: a row whose plain top-1 leads its top-2
    # by at most 2 ulps of the top logit is a tie at the output's own
    # resolution, where either answer is right
    top2 = plain.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * ulp
    top1_all = agree.float().mean().item()
    top1_decided = agree[decided].float().mean().item()
    picked = plain.gather(1, logits.argmax(-1, keepdim=True))[:, 0]
    top1_tied = (picked >= top2[:, 0] - 2 * ulp).float().mean().item()
    rows = len(plain)
    text = (f"top1_agree all rows={top1_all:.4f}, {int(decided.sum())} of "
            f"{rows} rows with a top-1 margin > 2 bf16 ulps="
            f"{top1_decided:.4f} (>= 0.99), all rows up to a 2-ulp tie="
            f"{top1_tied:.4f} (>= 0.99); ties within 1 ulp: "
            f"{int((margin <= ulp).sum())}, within 2 ulps: "
            f"{int((~decided).sum())}")
    ok = (top1_decided >= 0.99 and top1_tied >= 0.99
          and int(decided.sum()) >= rows // 2)
    return ok, text


# label, expt file, overrides, kernel launches one forward must make as a
# function of (fuser depth, GPT-2 layers, modalities); every other kernel's
# count must be 0
SERVED_PATHS = [
    ("flagship", "01_SA-Fuser_ek100_val_Swin.txt", [],
     lambda d, n, m: {"fused_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    # the KV cache: a prefill and ROLLOUT_LEN - 1 decode steps, each one
    # fused_attention a layer; the cached block uses no GPT-2 kernel
    ("rollout", "01_SA-Fuser_ek100_val_Swin.txt",
     [f"model.common.fp_output_len={ROLLOUT_LEN}"],
     lambda d, n, m: {"fused_block": d, "fused_attention": n * ROLLOUT_LEN}),
    ("expt02_sa_wo_token", "02_SA-Fuser_wo_token_ek100_train.txt", [],
     lambda d, n, m: {"fused_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    ("expt03_t_sa", "03_T-SA-Fuser_ek100_train.txt", [],
     lambda d, n, m: {"fused_seq_block": d, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
    ("expt04_ca", "04_CA-Fuser_ek100_train.txt", [],
     lambda d, n, m: {"fused_decoder_block": m - 1, "gpt2_attn_half": n,
                      "gpt2_mlp_half": n}),
]


def serve_path(label, expt, overrides, expected_fn):
    """Drive one served path at full width and hold it against the plain
    path; returns (launches of its one counted run, its numbers)."""
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches

    cfg = serve.load_config(os.path.join(EXPTS, expt), overrides)
    num_classes = {"action": 3806}
    modal_dims = {m: int(d) for m, d in
                  cfg.model.modal_dims.to_container().items()}
    T = int(cfg.data_eval.num_frames)
    out_len = int(cfg.model.common.fp_output_len)
    t0 = time.perf_counter()
    server = serve.Server(cfg, num_classes, "bfloat16", "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    fuser = server.model.future_predictor.fuser
    log(f"serve {label}: {expt} {overrides} built in "
        f"{time.perf_counter() - t0:.2f} s, {type(fuser).__name__}, "
        f"{n_params / 1e6:.1f} M params, T={T}, output_len={out_len}, bf16, "
        f"weights {server.weights_source}")
    requests = serve.random_requests(modal_dims, T, SERVE_BATCH,
                                     SERVE_REQUESTS)

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    answers = server.answer(requests)
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = dict.fromkeys(launches, 0)
    expected.update(expected_fn(len(fuser.blocks),
                                int(cfg.model.common.fp_layers),
                                len(modal_dims)))
    log(f"serve {label}: {len(answers)} requests answered, launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label}: the serving forward did not run "
                             "every kernel the expected number of times")
    if len(answers) != SERVE_REQUESTS:
        raise AssertionError("wrong number of answers")
    for (values, indices), req in zip(answers, requests):
        b = len(next(iter(req.values())))
        shape = (b, 5) if out_len == 1 else (b, out_len, 5)
        if values.shape != shape or indices.shape != shape:
            raise AssertionError(f"answer shape {tuple(values.shape)}, "
                                 f"expected {shape}")
        if not bool(values.isfinite().all()):
            raise AssertionError("non-finite top-k scores")
        if int(indices.min()) < 0 or int(indices.max()) >= 3806:
            raise AssertionError("class index out of range")

    def rows(lg):  # every anticipated step is a row of its own
        return lg.reshape(-1, lg.shape[-1])

    host_feats = {m: torch.cat([r[m] for r in requests]) for m in requests[0]}
    feats = server.to_device(host_feats)
    with torch.no_grad():
        logits = rows(server.head_logits(server.model(feats)))
        plain = rows(server.head_logits(server.model(feats, impl="plain")))
    torch.cuda.synchronize()
    finite = bool(logits.isfinite().all())
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    # bf16: ~40 rounded layers between the features and the logits, each of
    # which may flip a bf16 rounding by one ulp (2^-8 relative); the logits
    # themselves are a bf16 GEMM output. Bound: 5e-2 of max|logit|.
    tol_bf16 = 5e-2 * scale
    top1_ok, top1_text = top1_report(logits, plain)
    log(f"serve {label} bf16 B={SERVE_BATCH}: logits finite={finite} "
        f"max_abs_diff={max_abs:.6g} (tol {tol_bf16:.6g} = 5e-2 * "
        f"max|logit| {scale:.4g}); {top1_text}")
    bf16_ok = finite and max_abs <= tol_bf16 and top1_ok

    # throughput: the whole answer (host features in, top-k out), and the
    # model's forward on device-resident features
    with torch.no_grad():
        for _ in range(3):
            server.answer(requests)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            server.answer(requests)
        torch.cuda.synchronize()
        answer_ms = (time.perf_counter() - t0) / iters * 1e3
        forward_ms = time_ms(lambda: server.model(feats), iters=10)
    clips_s = SERVE_BATCH / answer_ms * 1e3
    log(f"serve {label} bf16 B={SERVE_BATCH}: answer_ms_per_batch="
        f"{answer_ms:.3f} clips_per_s={clips_s:.1f} "
        f"forward_ms_on_device_feats={forward_ms:.3f} forward_clips_per_s="
        f"{SERVE_BATCH / forward_ms * 1e3:.1f} peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    profile = profile_forward(lambda: server.model(feats))
    del server, feats

    # witness for the bf16 top-1 flips: the same weights (the bf16 model is
    # the seeded fp32 init, rounded) and clips through the plain path in
    # fp32. If the kernel path's flips are bf16 rounding at near-ties, the
    # plain path in bf16 flips against this reference about as often, and
    # its logits lie about as far from it.
    server = serve.Server(cfg, num_classes, "float32", "cuda")
    with torch.no_grad():
        ref = rows(server.head_logits(server.model(
            server.to_device(host_feats), impl="plain")))
    top1 = {"kernel_bf16": logits.argmax(-1), "plain_bf16": plain.argmax(-1),
            "ref": ref.argmax(-1)}
    witness = {path: {"top1_flip": (top1[path] != top1["ref"]).float()
                      .mean().item(),
                      "rms_err": (lg - ref).square().mean().sqrt().item(),
                      "max_abs_err": (lg - ref).abs().max().item()}
               for path, lg in (("kernel_bf16", logits),
                                ("plain_bf16", plain))}
    split = top1["kernel_bf16"] != top1["plain_bf16"]
    sides = {path: int((split & (top1["ref"] == top1[path])).sum())
             for path in ("kernel_bf16", "plain_bf16")}
    # 0.03: about two standard errors of the difference of two flip rates
    # near 4% over 256 clips
    log(f"serve {label} bf16 B={SERVE_BATCH} witness, against the plain "
        f"path in fp32 (top-1 flips: kernel <= plain + 0.03): "
        f"{json.dumps(witness)}; of the {int(split.sum())} rows where "
        f"kernel and plain bf16 differ, fp32 sides with {sides}")
    bf16_ok = bf16_ok and (witness["kernel_bf16"]["top1_flip"]
                           <= witness["plain_bf16"]["top1_flip"] + 0.03)

    # fp32 at a reduced batch: only the summation order differs
    small = serve.random_requests(modal_dims, T, FP32_BATCH, 1, seed=1)[0]
    feats = server.to_device(small)
    with torch.no_grad():
        logits = rows(server.head_logits(server.model(feats)))
        plain = rows(server.head_logits(server.model(feats, impl="plain")))
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    tol_fp32 = 1e-4 * scale
    log(f"serve {label} fp32 B={FP32_BATCH}: max_abs_diff={max_abs:.6g} "
        f"(tol {tol_fp32:.6g} = 1e-4 * max|logit| {scale:.4g}) top1_agree="
        f"{top1:.4f}")
    if not (bool(logits.isfinite().all()) and max_abs <= tol_fp32):
        raise AssertionError(f"{label}: fp32 serving disagrees with the "
                             "plain path")
    if out_len > 1:
        # the KV-cache rollout against the full re-run of every step on the
        # plain path, which a model built with fp_output_attentions takes
        rerun_cfg = serve.load_config(
            os.path.join(EXPTS, expt),
            overrides + ["model.common.fp_output_attentions=true"])
        rerun = serve.Server(rerun_cfg, num_classes, "float32", "cuda",
                             weights=server.model.state_dict())
        with torch.no_grad():
            full = rows(rerun.head_logits(rerun.model(feats, impl="plain")))
        del rerun
        max_abs = (logits - full).abs().max().item()
        log(f"serve {label} fp32 B={FP32_BATCH}: rollout vs the plain full "
            f"re-run max_abs_diff={max_abs:.6g} (tol {tol_fp32:.6g})")
        if not max_abs <= tol_fp32:
            raise AssertionError(f"{label}: the KV-cache rollout disagrees "
                                 "with the full re-run")
    if not bf16_ok:
        raise AssertionError(f"{label}: bf16 serving disagrees with the "
                             "plain path")
    return launches, {"answer_ms": answer_ms, "clips_per_s": clips_s,
                      "forward_ms": forward_ms,
                      "bf16_vs_fp32": witness,
                      "profile": profile}


def phase_serve():
    """Every served path in turn; returns ({kernel: launches on the path
    that runs it}, {path: numbers})."""
    import torch
    launches, numbers = {}, {}
    for label, expt, overrides, expected_fn in SERVED_PATHS:
        counted, numbers[label] = serve_path(label, expt, overrides,
                                             expected_fn)
        for name, n in counted.items():
            # a kernel's count comes from the first path that launches it
            if n and name not in launches:
                launches[name] = n
        torch.cuda.empty_cache()
    return launches, numbers


def main():
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: CUDA is not available; chip_smoke.py needs an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "afft_tpu_torch")):
        log("FAIL: run chip_smoke.py from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        log(smi)
        name = torch.cuda.get_device_name(0)
        log(f"device: {name}, count {torch.cuda.device_count()}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        peaks = peaks_for(name)

        # 2. build
        from afft_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.library()
        log(f"build: {time.perf_counter() - t0:.2f} s -> "
            f"{os.path.relpath(_build.build(), REPO)}")

        # 3. kernels
        kernels = phase_kernels(peaks)

        # 4. serve
        launches, serve_numbers = phase_serve()
        for k in kernels.values():
            # KeyError if no served path launched the kernel
            k["launches"] = launches[k["name"]]
        log(json.dumps({"serve": serve_numbers}))
    except Exception:  # noqa: BLE001 - any failure fails the smoke test
        traceback.print_exc()
        log("FAIL")
        return 1

    # 5. report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # a kernel's further shapes are the dict-valued items of its entry
    log(json.dumps({"kernels": [
        {**{k: e[k] for k in keys},
         **{label: {k: sub[k] for k in keys[5:]}
            for label, sub in e.items() if isinstance(sub, dict)}}
        for e in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
