"""Training entry point (the port's counterpart of train.py).

Usage: python -m afft_tpu_torch.train [--device cuda|cuda:K|cpu]
<overrides> (normally through ``python -m afft_tpu_torch.run -m train``;
under torchrun every process runs it, data parallel). The overrides compose
over ``afft_tpu_torch/conf`` as hydra's would. The default device is the
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
    from .loop import main as train_main
    cfg = compose(CONF_DIR, args.overrides)
    print(cfg.to_yaml())
    try:
        return train_main(cfg, device=device)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
