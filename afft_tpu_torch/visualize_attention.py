"""Attention visualization entry point.

The port's counterpart of visualize_attention.py. Loads a checkpoint
(``init_from_model``: it refuses to run without one), runs eval batches
with the fuser's attention weights (``BaseModel(fuser_need_weights=True)``,
the fuser's plain path) and the GPT-2 attention maps
(``model.common.fp_output_attentions``) on, and writes per-batch
``batch_{i:04d}.npz`` dumps with the JAX entry point's keys (``uids`` as
unicode; ``{head}/{name}`` and ``{head}/{name}/{key}`` for every attention
output), then the mean modality-token attention of the last fuser block
over the valid clips and, where matplotlib imports,
``modality_attention.png``.

Usage: python -m afft_tpu_torch.run -c expts/<val expt>.txt -m
visualize_attention [--device cpu] [+attn_out_dir=DIR]
[+attn_max_batches=N]; or python -m afft_tpu_torch.visualize_attention
[--device ...] <overrides>. The model runs in ``model.compute_dtype``
(fp32 by default), on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from . import resolve_device
from .config import CONF_DIR, compose
from .data.loader import BatchLoader, get_dataset
from .models.base_model import BaseModel
from .train.checkpoint import init_from_model
from .train.loop import DATASET_EVAL_CFG_KEY, get_transforms
from .train.runner import DTYPES

log = logging.getLogger(__name__)


def _numpy(t):
    return t.detach().float().cpu().numpy()


def attention_payload(attentions):
    """{head: {name: tensor or {key: tensor}}} -> the dump's flat keys."""
    payload = {}
    for headk, d in attentions.items():
        for name, val in d.items():
            if isinstance(val, dict):
                for k2, v2 in val.items():
                    if v2 is not None:
                        payload[f"{headk}/{name}/{k2}"] = _numpy(v2)
            elif val is not None:
                payload[f"{headk}/{name}"] = _numpy(val)
    return payload


def visualize(cfg, device):
    """Write the dumps and the heatmap of ``cfg`` (composed overrides);
    returns the mean modality-token attention ({modality: weight}) or
    None."""
    dataset = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                          get_transforms(cfg, train=False), log)
    loader = BatchLoader(dataset, batch_size=cfg.eval.batch_size or 8,
                         shuffle=False, num_workers=cfg.workers,
                         pin_memory=device.type == "cuda")
    if not cfg.get("init_from_model"):
        raise ValueError("Checkpoint required (init_from_model).")
    cfg.model.common.set("fp_output_attentions", True)
    with torch.device(device):
        model = BaseModel(cfg.model,
                          num_classes={k: len(v) for k, v in
                                       dataset.classes.items()},
                          class_mappings=dataset.class_mappings,
                          fuser_need_weights=True)
    paths = cfg.init_from_model
    paths = paths if isinstance(paths, list) else [paths]
    paths = [os.path.join(cfg.cwd, "checkpoints", p) for p in paths]
    state, _ = init_from_model(model.state_dict(), paths, None, log)
    model.load_state_dict(state)
    dtype = DTYPES[cfg.model.get("compute_dtype") or "float32"]
    model = model.to(dtype).eval()

    out_dir = cfg.get("attn_out_dir", "attention_maps")
    os.makedirs(out_dir, exist_ok=True)
    max_batches = int(cfg.get("attn_max_batches", 4))
    feats_order = [m for m in cfg.model.modal_feature_order
                   if m in cfg.model.modal_dims]
    modality_sums, n_clips, written = None, 0, 0
    for bi, batch in enumerate(loader):
        if bi >= max_batches:
            break
        feats = {m: torch.as_tensor(x).to(device, dtype)
                 for m, x in batch["data_dict"].items()}
        with torch.no_grad():
            payload = attention_payload(model(feats)["attentions"])
        # unicode (not object) dtype: dumps load with allow_pickle=False
        np.savez_compressed(os.path.join(out_dir, f"batch_{bi:04d}.npz"),
                            uids=np.asarray(batch["uid"], dtype=str),
                            **payload)
        written += 1
        ma = payload.get("all-fused/modality_attns")
        if ma is not None and ma.ndim == 6:  # (B, depth, T, H, n+1, n+1)
            token_row = ma[:, -1].mean(axis=(1, 2))[:, 0, 1:]  # (B, n)
            valid = np.asarray(batch["valid"], bool)
            s = token_row[valid].sum(axis=0)
            modality_sums = s if modality_sums is None else modality_sums + s
            n_clips += int(valid.sum())
    log.info("Wrote %d attention dumps to %s", written, out_dir)
    if modality_sums is None or not n_clips:
        return None
    weights = modality_sums / n_clips
    log.info("mean modality-token attention: %s",
             dict(zip(feats_order, np.round(weights, 4))))
    try:
        import matplotlib
    except ImportError:
        return dict(zip(feats_order, weights.tolist()))
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.bar(feats_order, weights)
    ax.set_ylabel("mean attention from modality token")
    ax.set_title("SA-Fuser modality attention (last block)")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "modality_attention.png"), dpi=150)
    plt.close(fig)
    log.info("Saved %s/modality_attention.png", out_dir)
    return dict(zip(feats_order, weights.tolist()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="hydra-style overrides")
    args = ap.parse_intermixed_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    return visualize(compose(CONF_DIR, args.overrides), device)


if __name__ == "__main__":
    main()
