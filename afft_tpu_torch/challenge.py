"""Challenge / ensemble tool (the port's counterpart of challenge.py).

Loads per-model logits files (h5, or the npz the port's eval writes where
h5py does not import), marginalizes actions to verbs / nouns, late-fuses N
models with weights, and packages an EK100 challenge submission
(logits/test.json + logits/submit.zip).

Usage:
  python -m afft_tpu_torch.challenge --prefix_h5 {test,val} --models M1 M2
      --weights 1 0.5 [--override key=value ...]
"""

from __future__ import annotations

import argparse
import logging

from .config import CONF_DIR, compose
from .config.registry import instantiate
from .eval import challenge as C


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--prefix_h5", type=str, default="test",
                        choices=["test", "val"],
                        help="Prefix of h5 files to select")
    parser.add_argument("--models", type=str, nargs="+", required=True,
                        help="List of model logits dirs under logits/")
    parser.add_argument("--weights", type=str, nargs="+", required=True,
                        help="Late-fusion weight per model")
    parser.add_argument("--override", type=str, nargs="*", default=[],
                        help="Extra config overrides")
    return parser.parse_args(argv)


def get_dataset(overrides, prefix_h5):
    cfg = compose(CONF_DIR, list(overrides))
    ds_cfg = cfg.dataset_eval.to_container(resolve=True)
    ds_cfg["reader_fn"] = {}  # only annotations/mappings are needed
    if prefix_h5 == "test" and not any(
            "test" in p for p in ds_cfg["annotation_path"]):
        logging.warning("switching annotation path to test timestamps")
        ds_cfg["annotation_path"] = [
            p.replace("EPIC_100_validation.pkl", "EPIC_100_test_timestamps.pkl")
            for p in ds_cfg["annotation_path"]]
    return instantiate(ds_cfg, _recursive_=False)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    dataset = get_dataset(args.override, args.prefix_h5)
    resdirs = [f"{C.LOGITS_DIR}/{m}" for m in args.models]
    weights = [float(w) for w in args.weights]
    C.package_results_for_submission_ek100(
        resdirs, dataset, weights, prefix_h5=args.prefix_h5)


if __name__ == "__main__":
    main()
