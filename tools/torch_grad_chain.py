#!/usr/bin/env python3
"""Where the bf16 training step's gradients part from fp32, on one NVIDIA
GPU: each training layer alone, then the flagship's whole step.

    python3 tools/torch_grad_chain.py [--json FILE]

(i) Each training layer alone, from the same weights, inputs and masks
(rates 0.1): the fuser block at (R, N, C) (1,024, 5, 1,024) in 4 heads, the
GPT-2 layer at (B, T, C) (64, 16, 2,048) in 4 heads, through four paths:
the kernels in bf16 (``kernel``), the plain version in bf16 (``plain``: its
backward ``fused_block_train.block_train_bwd_plain``, the kernels' cast
chain), the plain forward in bf16 under plain autograd (``autograd``: the
plain version's backward before that, which rounds where autograd's casts
do), and the plain version in fp32 (``fp32``). For each pair, each tensor
(dx and every parameter gradient): max|a - b| over max|b|.

(ii) The flagship's bf16 step at T 48, B 8 (``chip_smoke._long_grad_step``
with its three runners: kernels bf16, plain bf16, plain fp32, the same
weights and masks), with the plain layers' backward on the kernels' chain
and again under plain autograd: each distance's worst tensor, the fuser's
and the GPT-2 predictor's.

Prints one JSON line of the worst readings; ``--json FILE`` writes every
tensor's. Imports torch, the port and ``chip_smoke.py`` only.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from afft_tpu_torch.ops import _build  # noqa: E402
from afft_tpu_torch.ops import fused_block_train as FT  # noqa: E402
from afft_tpu_torch.ops import fused_gpt2_train as FGT  # noqa: E402

PAIRS = (("kernel", "fp32"), ("plain", "fp32"), ("autograd", "fp32"),
         ("kernel", "plain"), ("kernel", "autograd"))


def _grads(fn, x, p, dout):
    """(dx, {name: grad}) of sum(fn(x, p) * dout), in fp32."""
    x = x.detach().clone().requires_grad_(True)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    fn(x, p).backward(dout.to(x.dtype))
    return {"dx": x.grad.float(), **{k: v.grad.float() for k, v in p.items()}}


def _rels(a, b):
    return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(
        1e-30)) for k in b}


def layers():
    """(i): {layer: {pair: {tensor: distance}}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    out = {}
    bf, f32 = torch.bfloat16, torch.float32
    # the fuser block
    R, N, C, H, hidden = 1024, 5, 1024, 4, 4096
    p = S.block_params(C, hidden, bf, gen)
    x, dout = S._randn(gen, bf)(R, N, C), S._randn(gen, bf)(R, N, C)
    rates = tuple(S.TRAIN_RATES.values())
    masks = FT.draw_masks_plain(R, N, C, H, S.TRAIN_SEEDS, 5, *rates,
                                device="cuda")
    paths = {
        "kernel": lambda x, p: FT.fused_block_train(
            x, p, None, S.TRAIN_SEEDS, num_heads=H, block_idx=5,
            **S.TRAIN_RATES),
        "plain": lambda x, p: FT.fused_block_train_plain(
            x, p, None, masks, num_heads=H),
        "autograd": lambda x, p: FT._block_train_fwd_plain(
            x, p, None, masks, H, 1e-6)[0]}
    got = {k: _grads(fn, x, p, dout) for k, fn in paths.items()}
    got["fp32"] = _grads(paths["plain"], x.float(),
                         {k: v.float() for k, v in p.items()}, dout)
    out["fuser_block"] = {f"{a}/{b}": _rels(got[a], got[b])
                          for a, b in PAIRS}
    # the GPT-2 layer
    B, T, C, H, hidden = 64, 16, 2048, 4, 8192
    p = S.gpt2_params(C, hidden, bf, gen)
    x, dout = S._randn(gen, bf)(B, T, C), S._randn(gen, bf)(B, T, C)
    mask = torch.full((T, T), float("-inf"), device="cuda").triu(1)
    rates = tuple(S.GPT2_RATES.values())
    masks = FGT.draw_masks_gpt2_plain(B, T, C, H, S.TRAIN_SEEDS, 3, *rates,
                                      device="cuda")
    paths = {
        "kernel": lambda x, p: FGT.fused_gpt2_block_train(
            x, p, mask, S.TRAIN_SEEDS, num_heads=H, layer_idx=3,
            **S.GPT2_RATES),
        "plain": lambda x, p: FGT.fused_gpt2_block_train_plain(
            x, p, mask, masks, num_heads=H),
        "autograd": lambda x, p: FGT._gpt2_train_fwd_plain(
            x, p, mask, masks, H, 1e-5)[0]}
    got = {k: _grads(fn, x, p, dout) for k, fn in paths.items()}
    got["fp32"] = _grads(paths["plain"], x.float(),
                         {k: v.float() for k, v in p.items()}, dout)
    out["gpt2_layer"] = {f"{a}/{b}": _rels(got[a], got[b])
                         for a, b in PAIRS}
    del got
    torch.cuda.empty_cache()
    return out


def _autograd_chain():
    """The plain layers' backward under plain autograd through their
    forward (their backward before ``block_train_bwd_plain``)."""
    def block(x, params, mask, masks, *, num_heads, eps=1e-6, **_):
        return FT._block_train_fwd_plain(x, params, mask, masks, num_heads,
                                         eps)[0]

    def gpt2(x, params, mask, masks, *, num_heads, eps=1e-5, **_):
        return FGT._gpt2_train_fwd_plain(x, params, mask, masks, num_heads,
                                         eps)[0]
    return block, gpt2


def whole_step():
    """(ii): {chain: the three distances' tables}."""
    out = {}
    kernels_chain = (FT.fused_block_train_plain,
                     FGT.fused_gpt2_block_train_plain)
    for chain, (block, gpt2) in (("kernels_chain", kernels_chain),
                                 ("autograd", _autograd_chain())):
        FT.fused_block_train_plain = block
        FGT.fused_gpt2_block_train_plain = gpt2
        try:
            # the hold (2e-2) is chip_smoke.py's; here only the readings
            S._long_grad_step(f"grad chain {chain}", [], three_way=True)
        except AssertionError as e:
            S.log(f"grad chain {chain}: {e}")
        finally:
            FT.fused_block_train_plain, FGT.fused_gpt2_block_train_plain = \
                kernels_chain
        with open(S.LONG_GRAD_TABLE) as f:
            out[chain] = json.load(f)
        os.remove(S.LONG_GRAD_TABLE)
        torch.cuda.empty_cache()
    return out


def _worst(table, part=None):
    items = [(v, k) for k, v in table.items()
             if part is None or f".{part}." in k]
    return max(items, default=None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write every tensor's distances here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_grad_chain.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    tables = {"layers": layers(), "whole_step": whole_step()}
    summary = {
        "device": torch.cuda.get_device_name(0),
        "layers": {layer: {pair: _worst(t) for pair, t in pairs.items()}
                   for layer, pairs in tables["layers"].items()},
        "whole_step": {chain: {dist: {
            "worst": _worst(t), "fuser": _worst(t, "fuser"),
            "gpt2": _worst(t, "gpt_model"),
            "modal_token": [v for k, v in t.items()
                            if k.endswith(".fuser.modal_token")]}
            for dist, t in dists.items()}
            for chain, dists in tables["whole_step"].items()}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(tables, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
