"""One-command MT5R parity against the reference's published numbers.

The port's counterpart of the repo's ``tools/reproduce_reference.py``, with
the same command line: import a released reference ``.pth`` checkpoint, run
the val protocol of the given expt file through the port's eval
(``eval.evaluate.main``, on the card unless ``--device cpu``), and compare
the headline metric against the published value:

    python -m afft_tpu_torch.tools.reproduce_reference \\
        --expt 01_SA-Fuser_ek100_val_TSN \\
        --ckpt fusion_ek100_tsn/checkpoint_best.pth \\
        --lmdb rgb=/f/rgb,objects=/f/obj,audio=/f/audio,flow=/f/flow

Exit code 0 iff |measured - expected| <= tolerance, 1 otherwise (a NaN
metric too). ``--expect`` overrides the published expectation
(``tests/test_torch_reproduce.py`` drives the whole command path on the
synthetic set with it). A ``.pth``
loads through ``train.checkpoint.init_from_model`` (the reference layout,
``weights.load_reference_checkpoint``); a port checkpoint loads as it is.
Under torchrun every process evaluates its shard of the set, as ``-m test
-n N`` does; rank 0 checks and prints the metric, and the other ranks
return None.

Published expectations (action MT5R unless noted):
  01_SA-Fuser_ek100_val_Swin          18.5
  01_SA-Fuser_ek100_val_TSN           17.0
  01_SA-Fuser_ek100_val_TSN_wo_audio  16.4
  06_SA-Fuser_egtea_val               42.5  (action top-1)
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the reference's published numbers (its README's results table)
EXPECTATIONS = {
    "01_SA-Fuser_ek100_val_Swin": ("amt5r", 18.5),
    "01_SA-Fuser_ek100_val_TSN": ("amt5r", 17.0),
    "01_SA-Fuser_ek100_val_TSN_wo_audio": ("amt5r", 16.4),
    "06_SA-Fuser_egtea_val": ("atop1", 42.5),
}


def build_overrides(args):
    """The expt file's override lines without ``save_name`` (which would
    switch the eval into its logits-export mode and return no accuracies),
    then ``init_from_model``, the feature stores of ``--lmdb`` and the
    ``--override`` lines."""
    from ..config import read_expt_file
    expt = args.expt if args.expt.endswith(".txt") else args.expt + ".txt"
    expt_path = expt if os.path.exists(expt) \
        else os.path.join(REPO, "expts", expt)
    overrides = [o for o in read_expt_file(expt_path)
                 if not o.lstrip("+").startswith("save_name=")]
    if args.ckpt:
        overrides.append(f"init_from_model={args.ckpt}")
    for spec in (args.lmdb.split(",") if args.lmdb else []):
        mod, _, path = spec.partition("=")
        if not path:
            raise ValueError(f"--lmdb entries are mod=path, got {spec!r}")
        overrides.append(f"dataset.{args.dataset_group}.common.reader_fn."
                         f"{mod}.lmdb_path={path}")
    return overrides + list(args.override or [])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Assert published-metric parity for a reference ckpt.")
    ap.add_argument("--expt", required=True,
                    help="expt file name (expts/<name>.txt) or path")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path relative to checkpoints/ "
                         "(.pth imports automatically); overrides the "
                         "expt file's init_from_model")
    ap.add_argument("--lmdb", default=None,
                    help="comma-separated mod=dir feature-store overrides")
    ap.add_argument("--dataset-group", default="epic_kitchens100",
                    help="config group for --lmdb paths")
    ap.add_argument("--expect", type=float, default=None,
                    help="expected metric value (default: published)")
    ap.add_argument("--metric", default=None,
                    help="accs key to check (default: published metric)")
    ap.add_argument("--tolerance", type=float, default=0.3,
                    help="|measured - expected| bound (MT5R points)")
    ap.add_argument("--override", action="append", default=[],
                    help="extra config overrides (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:K or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the check; returns the measured metric (None on a rank other
    than 0), exits 1 when it misses the expectation."""
    args = parse_args(argv)
    name = os.path.splitext(os.path.basename(args.expt))[0]
    metric, expected = EXPECTATIONS.get(name, (None, None))
    metric = args.metric or metric
    expected = args.expect if args.expect is not None else expected
    if metric is None or expected is None:
        raise ValueError(f"{name} has no published expectation; pass "
                         "--metric and --expect")

    from .. import resolve_device
    from ..config import CONF_DIR, compose
    from ..eval.evaluate import main as eval_main
    from ..parallel import mesh

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg = compose(CONF_DIR, build_overrides(args))
    try:
        accs = eval_main(cfg, device=device)
        rank = mesh.rank_and_world()[0]
    finally:
        mesh.shutdown()
    if rank != 0:
        return None
    if not isinstance(accs, dict):
        raise ValueError("the eval returned no accuracies (save_name set?)")
    measured = float(accs[metric])
    diff = abs(measured - expected)
    ok = diff <= args.tolerance  # a NaN metric is out of tolerance too
    print(f"[reproduce_reference] {name}: {metric} measured {measured:.2f} "
          f"expected {expected:.2f} |diff| {diff:.2f} "
          f"(tolerance {args.tolerance}) -> {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        sys.exit(1)
    return measured


if __name__ == "__main__":
    main()
