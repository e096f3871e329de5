#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afft_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  - the card's name and power limit (nvidia-smi), TF32 off;
  2. build   - compile afft_tpu_torch/csrc with nvcc for sm_90a;
  3. kernels - each kernel (fused_block, gpt2_attn_half, gpt2_mlp_half)
               against its plain PyTorch version on the card, in bf16 at the
               flagship shapes and in fp32 at a reduced batch; its time
               beside the plain version's, a cuBLAS + SDPA composition of
               the same function, and the least time the card could take;
  4. serve   - the Server on expts/01_SA-Fuser_ek100_val_Swin.txt (bf16,
               batch 256, seeded weights) answers 4 requests through the
               kernels (6 launches of each per forward), and is held
               against the same model run through the plain versions,
               in bf16 and in fp32 at batch 32; the bf16 top-1 flips of
               both paths against the plain path in fp32; clips/s, ms per
               batch and the device time by kernel group (torch.profiler);
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
FLAGSHIP = os.path.join(REPO, "expts", "01_SA-Fuser_ek100_val_Swin.txt")
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

def block_params(C, hidden, dt, gen, affine=True, qkv_bias=False):
    import torch

    def rn(*shape, std):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dt)
    p = {"attn.qkv.weight": rn(3 * C, C, std=0.02),
         "attn.proj.weight": rn(C, C, std=0.02),
         "attn.proj.bias": rn(C, std=0.02),
         "mlp.mlp.0.weight": rn(hidden, C, std=0.02),
         "mlp.mlp.0.bias": rn(hidden, std=0.02),
         "mlp.mlp.2.weight": rn(C, hidden, std=0.02),
         "mlp.mlp.2.bias": rn(C, std=0.02)}
    if affine:
        for norm in ("norm1", "norm2"):
            p[f"{norm}.weight"] = 1 + rn(C, std=0.1)
            p[f"{norm}.bias"] = rn(C, std=0.1)
    if qkv_bias:
        p["attn.qkv.bias"] = rn(3 * C, std=0.02)
    return p


def gpt2_params(C, hidden, dt, gen):
    import torch

    def rn(*shape, std):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dt)
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


def library_block(x, p, H, eps):
    """The fuser block as cuBLAS GEMMs + SDPA in the working dtype."""
    import torch.nn.functional as F
    R, N, C = x.shape
    h = F.layer_norm(x, (C,), p["norm1.weight"], p["norm1.bias"], eps)
    q, k, v = (F.linear(h, p["attn.qkv.weight"]).view(R, N, 3, H, C // H)
               .permute(2, 0, 3, 1, 4))
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    y = x + F.linear(a.reshape(R, N, C), p["attn.proj.weight"],
                     p["attn.proj.bias"])
    h = F.layer_norm(y, (C,), p["norm2.weight"], p["norm2.bias"], eps)
    h = F.gelu(F.linear(h, p["mlp.mlp.0.weight"], p["mlp.mlp.0.bias"]))
    return y + F.linear(h, p["mlp.mlp.2.weight"], p["mlp.mlp.2.bias"])


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


def check_edge_shapes(gen):
    """Each kernel against its plain version at the edges of its limits:
    ragged row and column tiles, K not a multiple of the GEMM's k-tile,
    1 and the most tokens, head dims that are not multiples of 32, the
    optional LayerNorm affine, qkv bias and mask."""
    import torch
    from afft_tpu_torch.models.layers import (cross_attention_diag_mask,
                                              neg_inf_causal_mask)
    from afft_tpu_torch.ops import fused_block as FB, fused_gpt2 as FG

    n = 0
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for R, N, C, H, hidden, diag, affine, qkv_bias in (
                (1, 1, 64, 8, 256, False, True, False),
                (37, 8, 96, 4, 384, True, False, True),
                (130, 3, 40, 5, 72, True, True, True)):
            p = block_params(C, hidden, dt, gen, affine, qkv_bias)
            mask = cross_attention_diag_mask(N, device="cuda") if diag \
                else None
            x = torch.randn(R, N, C, generator=gen, device="cuda").to(dt)
            got = FB.fused_block(x, p, mask, num_heads=H)
            want = FB.fused_block_plain(x, p, mask, num_heads=H)
            n += _edge_ok(f"fused_block {tag} R={R} N={N} C={C} H={H} "
                          f"hidden={hidden}", tag, got, want)
        for B, T, C, H, hidden in ((1, 1, 64, 8, 256), (3, 32, 96, 4, 200),
                                   (5, 7, 40, 5, 72)):
            p = gpt2_params(C, hidden, dt, gen)
            mask = neg_inf_causal_mask(T, device="cuda")
            x = torch.randn(B, T, C, generator=gen, device="cuda").to(dt)
            n += _edge_ok(f"gpt2_attn_half {tag} B={B} T={T} C={C} H={H}",
                          tag, FG.gpt2_attn_half(x, p, mask, num_heads=H),
                          FG.gpt2_attn_half_plain(x, p, mask, num_heads=H))
            n += _edge_ok(f"gpt2_mlp_half {tag} B={B} T={T} C={C} "
                          f"hidden={hidden}", tag, FG.gpt2_mlp_half(x, p),
                          FG.gpt2_mlp_half_plain(x, p))
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
    from afft_tpu_torch.models.layers import neg_inf_causal_mask
    from afft_tpu_torch.ops import fused_block as FB, fused_gpt2 as FG

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.no_grad():
        check_edge_shapes(gen)
    results = {}
    cases = [
        # name, kernel, plain, library, (flagship shape), reduced fp32 shape
        ("fused_block", "afft_tpu/ops/pallas_block.py:120",
         (4096, 5), (512, 5), 1024, 4, 4096, 1e-6),
        ("gpt2_attn_half", "afft_tpu/ops/pallas_gpt2.py:100",
         (256, 16), (32, 16), 2048, 4, 8192, 1e-5),
        ("gpt2_mlp_half", "afft_tpu/ops/pallas_gpt2.py:140",
         (256, 16), (32, 16), 2048, 4, 8192, 1e-5),
    ]
    for name, replaces, shape, small, C, H, hidden, eps in cases:
        entry = {"name": name, "route": "cuda", "replaces": replaces,
                 "source": ("afft_tpu_torch/csrc/fused_block.cu"
                            if name == "fused_block"
                            else "afft_tpu_torch/csrc/fused_gpt2.cu")}
        for tag, dt, shp in (("fp32", torch.float32, small),
                             ("bf16", torch.bfloat16, shape)):
            if name == "fused_block":
                p = block_params(C, hidden, dt, gen)
                fns = (lambda x: FB.fused_block(x, p, None, num_heads=H,
                                                eps=eps),
                       lambda x: FB.fused_block_plain(x, p, None, num_heads=H,
                                                      eps=eps),
                       lambda x: library_block(x, p, H, eps))
            else:
                p = gpt2_params(C, hidden, dt, gen)
                mask = neg_inf_causal_mask(shp[1], device="cuda")
                if name == "gpt2_attn_half":
                    fns = (lambda x: FG.gpt2_attn_half(x, p, mask,
                                                       num_heads=H, eps=eps),
                           lambda x: FG.gpt2_attn_half_plain(
                               x, p, mask, num_heads=H, eps=eps),
                           lambda x: library_attn_half(x, p, H, eps))
                else:
                    fns = (lambda x: FG.gpt2_mlp_half(x, p, eps=eps),
                           lambda x: FG.gpt2_mlp_half_plain(x, p, eps=eps),
                           lambda x: library_mlp_half(x, p, eps))
            kernel, plain, library = fns
            x = torch.randn(*shp, C, generator=gen, device="cuda").to(dt)
            with torch.no_grad():
                got = kernel(x)
                torch.cuda.synchronize()
                want = plain(x)
            finite, max_abs, rel = errors(got, want)
            ok = finite and rel <= KERNEL_TOL[tag]
            log(f"kernel {name} {tag} shape={tuple(x.shape)}: max_abs_err="
                f"{max_abs:.6g} rel_err={rel:.3g} (tol {KERNEL_TOL[tag]:g} "
                f"of max|ref|) finite={finite} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {tag} disagrees with its plain "
                                     "version")
            if tag != "bf16":
                continue
            with torch.no_grad():
                ms = time_ms(lambda: kernel(x))
                plain_ms = time_ms(lambda: plain(x), iters=20)
                library_ms = time_ms(lambda: library(x))
            flops, nbytes = work(name, shp, C, H, hidden, x.element_size())
            t_ops = flops / peaks["bf16"] * 1e3
            t_bytes = nbytes / peaks["bytes"] * 1e3
            entry.update(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)
            log(f"kernel {name} bf16 kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms="
                f"{entry['bound_ms']:.4f} ({entry['bound_by']}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) "
                f"achieved={flops / ms / 1e9:.1f} TFLOP/s")
        results[name] = entry
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


def phase_serve():
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.ops import launch_counts, reset_launches

    cfg = serve.load_config(FLAGSHIP)
    num_classes = {"action": 3806}
    depth = int(cfg.model.fuser.depth)
    layers = int(cfg.model.common.fp_layers)
    modal_dims = {m: int(d) for m, d in
                  cfg.model.modal_dims.to_container().items()}
    T = int(cfg.data_eval.num_frames)
    t0 = time.perf_counter()
    server = serve.Server(cfg, num_classes, "bfloat16", "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serve: model built in {time.perf_counter() - t0:.2f} s, "
        f"{n_params / 1e6:.1f} M params, bf16, weights "
        f"{server.weights_source}")
    requests = serve.random_requests(modal_dims, T, SERVE_BATCH,
                                     SERVE_REQUESTS)

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    answers = server.answer(requests)
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = {"fused_block": depth, "gpt2_attn_half": layers,
                "gpt2_mlp_half": layers}
    log(f"serve: {len(answers)} requests answered, launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError("the serving forward did not run every kernel "
                             "the expected number of times")
    if len(answers) != SERVE_REQUESTS:
        raise AssertionError("wrong number of answers")
    for (values, indices), req in zip(answers, requests):
        b = len(next(iter(req.values())))
        if values.shape != (b, 5) or indices.shape != (b, 5):
            raise AssertionError(f"answer shape {tuple(values.shape)}")
        if not bool(values.isfinite().all()):
            raise AssertionError("non-finite top-k scores")
        if int(indices.min()) < 0 or int(indices.max()) >= 3806:
            raise AssertionError("class index out of range")

    host_feats = {m: torch.cat([r[m] for r in requests]) for m in requests[0]}
    feats = server.to_device(host_feats)
    with torch.no_grad():
        logits = server.head_logits(server.model(feats))
        plain = server.head_logits(server.model(feats, impl="plain"))
    torch.cuda.synchronize()
    finite = bool(logits.isfinite().all())
    agree = logits.argmax(-1) == plain.argmax(-1)
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    # bf16: ~40 rounded layers between the features and the logits, each of
    # which may flip a bf16 rounding by one ulp (2^-8 relative); the logits
    # themselves are a bf16 GEMM output. Bound: 5e-2 of max|logit|.
    tol_bf16 = 5e-2 * scale
    # the logits are bf16 values: a clip whose plain top-1 leads its top-2
    # by at most 2 ulps of the top logit is a tie at the output's own
    # resolution, where either answer is right
    top2 = plain.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * ulp
    top1_all = agree.float().mean().item()
    top1_decided = agree[decided].float().mean().item()
    # on every clip: the kernel path's top-1 class scores, in the plain
    # logits, within 2 ulps of the plain top-1
    picked = plain.gather(1, logits.argmax(-1, keepdim=True))[:, 0]
    top1_tied = (picked >= top2[:, 0] - 2 * ulp).float().mean().item()
    log(f"serve bf16 B={SERVE_BATCH}: logits finite={finite} max_abs_diff="
        f"{max_abs:.6g} (tol {tol_bf16:.6g} = 5e-2 * max|logit| "
        f"{scale:.4g}); top1_agree all clips={top1_all:.4f}, "
        f"{int(decided.sum())} clips with a top-1 margin > 2 bf16 ulps="
        f"{top1_decided:.4f} (>= 0.99), all clips up to a 2-ulp tie="
        f"{top1_tied:.4f} (>= 0.99); ties within 1 ulp: "
        f"{int((margin <= ulp).sum())}, within 2 ulps: "
        f"{int((~decided).sum())}")
    bf16_ok = (finite and max_abs <= tol_bf16 and top1_decided >= 0.99
               and top1_tied >= 0.99
               and int(decided.sum()) >= SERVE_BATCH // 2)

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
    log(f"serve bf16 B={SERVE_BATCH}: answer_ms_per_batch={answer_ms:.3f} "
        f"clips_per_s={clips_s:.1f} forward_ms_on_device_feats="
        f"{forward_ms:.3f} forward_clips_per_s="
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
        ref = server.head_logits(server.model(server.to_device(host_feats),
                                              impl="plain"))
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
    log(f"serve bf16 B={SERVE_BATCH} witness, against the plain path in "
        f"fp32 (top-1 flips: kernel <= plain + 0.03): {json.dumps(witness)}; "
        f"of the {int(split.sum())} clips where kernel and plain bf16 "
        f"differ, fp32 sides with {sides}")
    bf16_ok = bf16_ok and (witness["kernel_bf16"]["top1_flip"]
                           <= witness["plain_bf16"]["top1_flip"] + 0.03)

    # fp32 at a reduced batch: only the summation order differs
    requests = serve.random_requests(modal_dims, T, FP32_BATCH, 1, seed=1)
    feats = server.to_device(requests[0])
    with torch.no_grad():
        logits = server.head_logits(server.model(feats))
        plain = server.head_logits(server.model(feats, impl="plain"))
    max_abs = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    tol_fp32 = 1e-4 * scale
    log(f"serve fp32 B={FP32_BATCH}: max_abs_diff={max_abs:.6g} (tol "
        f"{tol_fp32:.6g} = 1e-4 * max|logit| {scale:.4g}) top1_agree="
        f"{top1:.4f}")
    if not (bool(logits.isfinite().all()) and max_abs <= tol_fp32):
        raise AssertionError("fp32 serving disagrees with the plain path")
    if not bf16_ok:
        raise AssertionError("bf16 serving disagrees with the plain path")
    return launches, {"answer_ms": answer_ms, "clips_per_s": clips_s,
                      "forward_ms": forward_ms,
                      "bf16_vs_fp32": witness,
                      "profile": profile}


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
            k["launches"] = launches[k["name"]]
        log(json.dumps({"serve": serve_numbers}))
    except Exception:  # noqa: BLE001 - any failure fails the smoke test
        traceback.print_exc()
        log("FAIL")
        return 1

    # 5. report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: e[k] for k in keys}
                                for e in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
