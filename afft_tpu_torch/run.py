"""Launcher, interface-compatible with the reference's run.py.

``python -m afft_tpu_torch.run -c expts/X.txt -m train [--device cpu]
[override ...]`` reads the expt override file (the same files and
``_target_`` strings as run.py), appends the overrides given after it and
runs the training entry point in this process, on the card unless
``--device cpu`` is given. One process on one device: ``-n`` above 1 (data
parallelism) and ``-m test`` (the eval CLI) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

from .config import read_expt_file


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, required=True,
                        help="Overrides config file")
    parser.add_argument("-m", "--mode", type=str, required=True,
                        choices=["train", "test"],
                        help="Choose which entry point to run")
    parser.add_argument("-n", "--nproc_per_node", type=int, default=1,
                        help="processes; only 1 is ported")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*",
                        help="further overrides, applied after the file's")
    return parser.parse_intermixed_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "test":
        raise NotImplementedError(
            "-m test (the eval CLI) is not ported (ROADMAP.md §A.3)")
    if args.nproc_per_node > 1:
        raise NotImplementedError(
            f"-n {args.nproc_per_node}: data parallelism is not ported "
            "(ROADMAP.md §A.4)")
    overrides = read_expt_file(args.cfg) + list(args.overrides)
    print('>> Running "{} {}"'.format(args.mode, " ".join(overrides)),
          flush=True)
    from .train.__main__ import main as train_main
    return train_main(["--device", args.device, *overrides])


if __name__ == "__main__":
    main()
    sys.exit(0)
