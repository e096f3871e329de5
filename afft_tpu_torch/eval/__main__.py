"""Evaluation / logits-export entry point (the port's counterpart of
test.py).

Usage: python -m afft_tpu_torch.eval [--device cuda|cuda:K|cpu] <overrides>
(normally through ``python -m afft_tpu_torch.run -m test``; under torchrun
every process runs it on its shard of the eval set). With
``+save_name=foo.h5`` it exports the action logits to
``logits/<model>/foo.h5`` (``foo.npz`` where h5py does not import);
otherwise it prints the marginalized verb / noun / action accuracies. The
overrides compose over ``afft_tpu_torch/conf``. The default device is the
card; without CUDA the command fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .. import resolve_device
from ..config import CONF_DIR, compose


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
    from ..parallel import mesh
    from .evaluate import main as eval_main
    cfg = compose(CONF_DIR, args.overrides)
    print(cfg.to_yaml())
    try:
        return eval_main(cfg, device=device)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
