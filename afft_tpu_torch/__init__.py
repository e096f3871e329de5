"""afft_tpu_torch: the PyTorch/CUDA port of afft_tpu.

A package of its own beside the JAX one: it imports torch, numpy and yaml,
never jax and nothing of afft_tpu. Plain tensor code is PyTorch; the TPU
kernels of the serving path and of the fuser block's training are
hand-written CUDA kernels for Hopper (``afft_tpu_torch/csrc``, bound in
``afft_tpu_torch/ops``). ``serve.Server`` answers requests;
``train.runner.Runner`` takes training and eval steps; ``python -m
afft_tpu_torch.run -c expts/X.txt -m train`` trains an expt through the data
pipeline (``data``), the epoch loop, checkpoints and metric tracker
(``train.loop``), ``-m test`` evaluates or exports its logits (``eval``),
``python -m afft_tpu_torch.challenge`` packages them, and ``-n N`` runs
either on N data-parallel processes (``parallel``).

Entry points run on the card unless the caller asks for the CPU:
``resolve_device`` raises instead of falling back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.

    The default is the card. Without CUDA this raises unless the caller
    asked for ``"cpu"`` explicitly (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
