"""Serve top-k action scores for per-modality feature clips.

The port's counterpart of ``tools/export_serving.py`` (``build_serving_fn``)
plus ``tools/serve_bundle.py``: compose an expt file over
``afft_tpu_torch/conf``, build ``BaseModel``, load weights (or draw them
from the config's seed), cast to the serving dtype, and answer requests.
A request is a dict of per-modality (b, T, F) feature tensors; the requests
handed to one ``answer`` call are batched into one forward, and each gets
back ``(values, indices)``, its clips' top-k scores over the action classes:
(b, k) for the single-step models, (b, output_len, k) — every anticipated
step — when ``model.common.fp_output_len`` > 1 (the KV-cache rollout).

Usage:
  python -m afft_tpu_torch.serve -c expts/01_SA-Fuser_ek100_val_Swin.txt \
      [--batch 256] [--num-classes action:3806] [--dtype bfloat16|float32] \
      [--topk 5] [--requests N] [--weights FILE] [--device cuda|cpu] \
      [--output-len N]

Without ``--weights`` the model serves seeded random weights and says so.
The default device is the card; without CUDA the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import resolve_device
from .config import CONF_DIR, compose, read_expt_file
from .models import BaseModel
from .weights import load_reference_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
RANDOM_INIT = "RANDOM-INIT (no checkpoint; not a deployment artifact)"


def build_model(cfg, num_classes, dtype, device, weights=None):
    """(model in eval mode on ``device`` in ``dtype``, weights provenance).

    ``weights`` is a reference ``.pth`` path, a state dict, or None for a
    seeded init drawn from ``cfg.seed``."""
    with torch.device(device):
        model = BaseModel(cfg.model, num_classes=num_classes)
    if weights is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg.get("seed", 42)))
        model.reset_parameters(gen)
        source = RANDOM_INIT
    else:
        sd = (weights if isinstance(weights, dict)
              else load_reference_checkpoint(weights))
        missing, _ = model.load_state_dict(sd, strict=False)
        if missing:
            raise KeyError(f"weights lack {len(missing)} tensors of the "
                           f"model, e.g. {missing[:5]}")
        source = weights if isinstance(weights, str) else "state dict"
    return model.to(dtype).eval(), source


class Server:
    """Answers batched requests with top-k action scores per clip."""

    def __init__(self, cfg, num_classes, dtype="bfloat16", device="cuda",
                 weights=None, *, topk=5):
        self.device = resolve_device(device)
        self.dtype = DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.topk = topk
        self.target = "action" if "action" in num_classes \
            else next(iter(num_classes))
        self.output_len = int(cfg.model.common.get("fp_output_len") or 1)
        self.model, self.weights_source = build_model(
            cfg, num_classes, self.dtype, self.device, weights)

    def to_device(self, feats):
        return {m: torch.as_tensor(x).to(self.device, self.dtype)
                for m, x in feats.items()}

    def head_logits(self, outputs):
        """Model outputs -> fp32 logits: (B, n_classes) for single-step
        serving, every anticipated step (B, output_len, n_classes) for a
        multi-step rollout."""
        heads = outputs[f"logits/{self.target}"]
        modk = "all-fused" if "all-fused" in heads else next(iter(heads))
        logits = heads[modk]
        if self.output_len == 1:
            logits = logits[:, 0, :]
        return logits.float()

    @torch.no_grad()
    def logits(self, feats):
        """{mod: (B, T, F)} -> fp32 logits, as ``head_logits``."""
        return self.head_logits(self.model(self.to_device(feats)))

    @torch.no_grad()
    def answer(self, requests):
        """[{mod: (b_i, T, F)}] -> [(values, indices)], each (b_i, k), or
        (b_i, output_len, k) for a multi-step rollout."""
        sizes = [len(next(iter(r.values()))) for r in requests]
        feats = {m: torch.cat([torch.as_tensor(r[m]) for r in requests])
                 for m in requests[0]}
        values, indices = torch.topk(self.logits(feats), self.topk, dim=-1)
        return list(zip(values.split(sizes), indices.split(sizes)))


def random_requests(modal_dims, n_frames, batch, n_requests, seed=0):
    """``n_requests`` requests of seeded N(0, 1) features, ``batch`` clips
    in all."""
    rng = np.random.default_rng(seed)
    sizes = [batch // n_requests + (i < batch % n_requests)
             for i in range(n_requests)]
    return [{m: torch.from_numpy(rng.standard_normal(
                (b, n_frames, d), dtype=np.float32))
             for m, d in modal_dims.items()} for b in sizes]


def load_config(expt_file, overrides=()):
    return compose(CONF_DIR, read_expt_file(expt_file) + list(overrides))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--cfg", required=True,
                    help="expt override file (run.py format)")
    ap.add_argument("--batch", type=int, default=256,
                    help="clips in all, split over the requests")
    ap.add_argument("--num-classes", default="action:3806",
                    help="comma list target:count")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--weights", default=None,
                    help="reference .pth checkpoint (default: seeded init)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output-len", type=int, default=None,
                    help="override model.common.fp_output_len (>1 serves "
                         "the KV-cache multi-step rollout)")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg, [
        f"model.common.fp_output_len={args.output_len}"]
        if args.output_len else ())
    num_classes = {k: int(v) for k, v in
                   (kv.split(":") for kv in args.num_classes.split(","))}
    server = Server(cfg, num_classes, args.dtype, args.device, args.weights,
                    topk=args.topk)
    if args.weights is None:
        print(f"WARNING: serving {RANDOM_INIT}: weights drawn from seed "
              f"{cfg.get('seed', 42)}", flush=True)
    modal_dims = {m: int(d) for m, d in
                  cfg.model.modal_dims.to_container().items()}
    requests = random_requests(modal_dims, int(cfg.data_eval.num_frames),
                               args.batch, args.requests)
    t0 = time.perf_counter()
    answers = server.answer(requests)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "requests": len(answers), "clips": args.batch, "topk": args.topk,
        "output_len": server.output_len,
        "device": str(server.device), "dtype": args.dtype,
        "weights": server.weights_source,
        "first_answer_s": seconds,
        "top1_of_first_clip": int(answers[0][1][0].flatten()[0]),
    }), flush=True)


if __name__ == "__main__":
    main()
