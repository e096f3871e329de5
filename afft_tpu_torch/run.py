"""Launcher, interface-compatible with the reference's run.py.

``python -m afft_tpu_torch.run -c expts/X.txt -m {train,test} [-n N]
[--device cpu] [override ...]`` reads the expt override file (the same
files and ``_target_`` strings as run.py), appends the overrides given after
it and runs the entry point: ``-m train`` the training loop
(``afft_tpu_torch.train``), ``-m test`` the eval CLI (``afft_tpu_torch.eval``:
accuracies, or the logits export with ``+save_name``), ``-m
visualize_attention`` the attention dumps
(``afft_tpu_torch.visualize_attention``; one process). On the card unless
``--device cpu`` is given. With ``-n 1`` the entry point runs in this
process; with ``-n N`` above 1 the launcher starts N processes through
``torch.distributed.run`` on this host, as the reference does (reference
run.py:42-44), one card each (``--device cuda``: ``cuda:LOCAL_RANK``), over
NCCL, or over gloo with ``--device cpu`` or a pinned ``cuda:K``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from .config import read_expt_file

ENTRY_POINTS = {"train": "afft_tpu_torch.train",
                "test": "afft_tpu_torch.eval",
                "visualize_attention": "afft_tpu_torch.visualize_attention"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, required=True,
                        help="Overrides config file")
    parser.add_argument("-m", "--mode", type=str, required=True,
                        choices=sorted(ENTRY_POINTS),
                        help="Choose which entry point to run")
    parser.add_argument("-n", "--nproc_per_node", type=int, default=1,
                        help="processes on this host (data parallel)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:K or cpu")
    parser.add_argument("overrides", nargs="*",
                        help="further overrides, applied after the file's")
    return parser.parse_intermixed_args(argv)


def torchrun_command(module: str, nproc: int, args) -> list:
    """``python -m torch.distributed.run`` on this host with a free port
    (``--standalone``), starting ``nproc`` processes of ``module``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", "-m", module, *args]


def main(argv=None):
    args = parse_args(argv)
    if args.nproc_per_node < 1:
        raise ValueError(f"-n {args.nproc_per_node}: at least one process")
    overrides = read_expt_file(args.cfg) + list(args.overrides)
    print('>> Running "{} {}"'.format(args.mode, " ".join(overrides)),
          flush=True)
    entry_args = ["--device", args.device, *overrides]
    if args.mode == "visualize_attention":
        if args.nproc_per_node > 1:
            raise ValueError("-m visualize_attention runs in one process")
        from .visualize_attention import main as entry
        return entry(entry_args)
    if args.nproc_per_node > 1:
        cmd = torchrun_command(ENTRY_POINTS[args.mode], args.nproc_per_node,
                               entry_args)
        return subprocess.call(cmd)
    if args.mode == "test":
        from .eval.__main__ import main as entry
    else:
        from .train.__main__ import main as entry
    return entry(entry_args)


if __name__ == "__main__":
    rc = main()
    # an int is the launched processes' exit code; in-process entry points
    # return their result
    sys.exit(rc if type(rc) is int else 0)
