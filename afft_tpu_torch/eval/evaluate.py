"""Test / eval entry: logits export and marginalized evaluation.

Port of afft_tpu/eval/evaluate.py (reference test.py: save_logits :33-61,
store_append_h5 :20-30, evaluate :64-98, main :101-141). The forward is the
validation forward of the training loop, ``Runner.eval_step``: the model in
eval mode in ``model.compute_dtype`` on the card (for the flagship the fuser
blocks and GPT-2 layers on the serving kernels), and the fp32 action logits
of the fused head, or of the first head. On the card unless the caller asks
for the CPU.

Several processes (torchrun, ``parallel.mesh``) each forward their shard of
the eval set (strided, wrap-padded, as the training loop's validation);
``collect_logits`` gathers the shards and restores the dataset's row order.
Only rank 0 prints and writes.

Logits files. ``+save_name=x.h5`` writes ``logits/<model>/x.h5`` in
``store_append_h5``'s layout (the reference's; rows appended to an existing
file) where ``h5py`` imports. Where it does not, the same key
(``logits/action_<head>``) and row order go to ``x.npz`` beside it
(``store_append_npz``), and the path written is logged. ``eval.challenge``
reads either; the npz is a second file format, not a fallback of the device
or of the computation.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.loader import BatchLoader, get_dataset
from ..ops import launch_counts, reset_launches
from ..parallel import mesh
from ..train.checkpoint import init_from_model
from ..train.loop import DATASET_EVAL_CFG_KEY, get_transforms
from ..train.runner import Runner
from .challenge import LOGITS_DIR, marginalize_verb_noun, \
    print_accuracies_epic

log = logging.getLogger(__name__)


def h5py_imports() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def store_append_h5(endpoints, output_dir, save_file_name):
    import h5py
    output_fpath = os.path.join(output_dir, save_file_name)
    os.makedirs(output_dir, exist_ok=True)
    with h5py.File(output_fpath, "a") as fout:
        for key, val in endpoints.items():
            if key not in fout:
                fout.create_dataset(
                    key, data=val, compression="gzip", compression_opts=9,
                    chunks=True, maxshape=(None,) + val.shape[1:])
            else:
                fout[key].resize(
                    (fout[key].shape[0] + val.shape[0],) + val.shape[1:])
                fout[key][-val.shape[0]:, ...] = val
    return output_fpath


def npz_name(save_file_name: str) -> str:
    """``x.h5`` -> ``x.npz`` (any other name gains ``.npz``)."""
    root, ext = os.path.splitext(save_file_name)
    return (root if ext in (".h5", ".hdf5") else save_file_name) + ".npz"


def store_append_npz(endpoints, output_dir, save_file_name):
    """``store_append_h5``'s layout in ``npz_name(save_file_name)``: each key
    an array, rows appended to those of an existing file. Returns the
    path."""
    path = os.path.join(output_dir, npz_name(save_file_name))
    os.makedirs(output_dir, exist_ok=True)
    arrays = {}
    if os.path.exists(path):
        with np.load(path) as fin:
            arrays = {k: fin[k] for k in fin.files}
    for key, val in endpoints.items():
        arrays[key] = np.concatenate([arrays[key], val]) \
            if key in arrays else np.asarray(val)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def store_append(endpoints, output_dir, save_file_name):
    """h5 where h5py imports, else npz; returns the path written."""
    if h5py_imports():
        return store_append_h5(endpoints, output_dir, save_file_name)
    return store_append_npz(endpoints, output_dir, save_file_name)


def action_head(runner) -> str:
    """The head whose logits the eval reports (``Runner.eval_step``'s):
    the fused one, else the first (afft_tpu/eval/evaluate.py:53-54), of the
    heads the model's ``logits/action`` holds (score fusion: the fused
    head alone)."""
    cmfp = runner.model.future_predictor
    heads = (cmfp.logit_heads("action") if "action" in cmfp.num_classes
             else ["all-fused"])
    return "all-fused" if "all-fused" in heads else heads[0]


def _forward_all(runner, loader, timing=None):
    """Run the eval forward over a loader; yields (valid logits, uids,
    dataset row idx, head key). ``timing`` (a dict) gets the clips, batches
    and the window from the first batch's start to the last logits' read
    (``clips_per_s`` over it)."""
    modk = action_head(runner)
    t0, clips, batches = None, 0, 0
    for batch in loader:
        if t0 is None:
            t0 = time.perf_counter()
        _, _, logits = runner.eval_step(batch)
        valid = np.asarray(batch["valid"], bool)
        logits = logits.cpu().numpy()[valid]
        clips += int(valid.sum())
        batches += 1
        yield (logits, np.asarray(batch["uid"])[valid],
               np.asarray(batch["idx"])[valid], modk)
    if timing is not None and t0 is not None:
        window = (time.perf_counter() - t0) * 1e3
        timing.update(clips=clips, batches=batches, window_ms=window,
                      clips_per_s=clips / window * 1e3)


def _merge_shards(logits, idx):
    """Restore dataset row order and drop the DistributedSampler-style
    wrap-around duplicates after a cross-process gather."""
    order = np.argsort(idx, kind="stable")
    logits, idx = logits[order], idx[order]
    keep = np.ones(len(idx), bool)
    keep[1:] = np.diff(idx) > 0
    return logits[keep], idx[keep]


def collect_logits(runner, loader, timing=None):
    """Forward the (possibly per-process-sharded) loader, gather the shards
    from every process, and return (logits, dataset row idx, head key) in
    dataset order."""
    chunks, idxs, modk = [], [], None
    for logits, _, idx, modk in _forward_all(runner, loader, timing):
        chunks.append(logits)
        idxs.append(idx)
    # shard_indices tiles small datasets so every rank's shard is
    # non-empty whenever the dataset is; an empty loader here means an
    # empty dataset
    if not chunks:
        raise ValueError("eval loader yielded no batches (empty dataset?)")
    logits = np.concatenate(chunks, axis=0)
    idx = np.concatenate(idxs, axis=0)
    grid = runner.grid
    if grid.replicas > 1:
        logits = mesh.gather_from_all(logits, grid.data_group)
        idx = mesh.gather_from_all(idx, grid.data_group)
    logits, idx = _merge_shards(logits, idx)
    return logits, idx, modk


def save_logits(runner, loader, save_dir, save_file_name, timing=None):
    """Action logits in dataset order as ``logits/action_<head>`` in
    ``save_dir/save_file_name`` (h5, or its npz; reference :33-61), written
    by rank 0. Returns the path written (None on other ranks)."""
    logits, _, modk = collect_logits(runner, loader, timing)
    if mesh.rank_and_world()[0] != 0:
        return None
    path = store_append({f"logits/action_{modk}": logits}, save_dir,
                        save_file_name)
    log.info("Saved logits logits/action_%s (%d rows) to %s", modk,
             len(logits), path)
    return path


def evaluate(runner, dataset, loader, timing=None):
    """Marginalized verb/noun/action accuracies incl. unseen/tail
    (reference :64-98)."""
    logits_array, _, _ = collect_logits(runner, loader, timing)
    if len(logits_array) != len(dataset):
        raise ValueError(f"{len(logits_array)} logits vs {len(dataset)} "
                         "clips")
    accs, _ = marginalize_verb_noun(logits_array, dataset, to_prob=True,
                                    compute_manyshot_unseen_tail=True)
    if mesh.rank_and_world()[0] == 0:  # master-only console output
        print_accuracies_epic(accs)
    return accs


def eval_loader(cfg, dataset, device, shard_id=0, num_shards=1):
    """The eval set's batches: from the device feature cache with
    ``data_on_device`` (no fallback: a set the cache cannot hold raises),
    else from the host loader."""
    eval_batch = int(cfg.eval.batch_size or cfg.train.batch_size * 4)
    if cfg.get("data_on_device"):
        from ..data.device_cache import DeviceFeatureCache
        dtype = "int8" if cfg.get("data_on_device_dtype") == "int8" \
            else torch.bfloat16
        cache = DeviceFeatureCache(dataset, device, dtype=dtype)
        return cache.iter_batches(eval_batch, shuffle=False,
                                  shard_id=shard_id, num_shards=num_shards)
    return BatchLoader(dataset, batch_size=eval_batch, shuffle=False,
                       num_workers=cfg.workers, shard_id=shard_id,
                       num_shards=num_shards,
                       pin_memory=torch.device(device).type == "cuda")


def main(cfg, device="cuda"):
    """Evaluate ``cfg.init_from_model`` on ``cfg``'s eval set: the
    accuracies (returned on rank 0), or with ``save_name`` the logits file
    (its path returned on rank 0)."""
    resolve_device(device)
    dist_info = mesh.init_distributed(device, log)
    device = dist_info["device"]
    shard_id, num_shards = dist_info["rank"], dist_info["world_size"]
    reset_launches()
    transform_val = get_transforms(cfg, train=False)
    dataset_test = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                               transform_val, log)
    # an EK100 val eval without the RULSTM annotation dir silently
    # degrades the unseen/tail breakdowns to NaN
    # (challenge.epic100_unseen_tail_eval); name the kwarg up front
    from ..data.epic import EPIC100_VERSION
    df = getattr(dataset_test, "df", None)
    if (getattr(dataset_test, "version", None) == EPIC100_VERSION
            and getattr(dataset_test, "rulstm_annotation_dir", None) is None
            and df is not None and "action_class" in df.columns):
        log.warning(
            "EK100 val eval without rulstm_annotation_dir (config key "
            "dataset.epic_kitchens100.common.rulstm_annot_dir): "
            "unseen/tail MT5R breakdowns will be NaN")
    if num_shards > 1:
        log.info("multi-process eval: shard %d/%d", shard_id, num_shards)
    loader = eval_loader(cfg, dataset_test, device, shard_id, num_shards)

    num_classes = {k: len(v) for k, v in dataset_test.classes.items()}
    # every layer in each process, as the JAX package evaluates
    runner = Runner.from_config(cfg, num_classes, device=device,
                                class_mappings=dataset_test.class_mappings,
                                pipeline=False)
    if cfg.get("init_from_model") is None:
        raise ValueError("Checkpoint is required for test "
                         "(init_from_model).")
    ckpt_paths = cfg.init_from_model
    if not isinstance(ckpt_paths, list):
        ckpt_paths = [ckpt_paths]
    ckpt_paths = [os.path.join(cfg.cwd, "checkpoints", p)
                  for p in ckpt_paths]
    state, _ = init_from_model(runner.model.state_dict(), ckpt_paths, None,
                               log)
    runner.load_model_state(state)

    timing = {}
    if cfg.get("save_name"):
        # the first checkpoint's model dir names the logits dir (the
        # reference's create_ckpt_path-derived layout)
        first_ckpt = cfg.init_from_model
        if isinstance(first_ckpt, list):
            first_ckpt = first_ckpt[0]
        save_dir = os.path.join(cfg.cwd, LOGITS_DIR,
                                str(first_ckpt).split("/")[0])
        result = save_logits(runner, loader, save_dir, cfg.save_name, timing)
    else:
        result = evaluate(runner, dataset_test, loader, timing)
    run = {"device": str(device), "world_size": num_shards,
           "launches": launch_counts(), **timing}
    if isinstance(result, dict):
        run["accuracies"] = result
    elif result is not None:
        run["logits_file"] = result
    log.info("eval run: %s", json.dumps(run))
    return result if shard_id == 0 else None
