"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version.

- ``ops.fused_block``: one fuser block (replaces the TPU kernel
  ``afft_tpu/ops/pallas_block.py:fused_block``);
- ``ops.fused_gpt2``: one GPT-2 layer as two halves (replaces
  ``afft_tpu/ops/pallas_gpt2.py:fused_gpt2_block``).

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches, so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

from . import fused_block as _fused_block
from . import fused_gpt2 as _fused_gpt2

_COUNTERS = (_fused_block.LAUNCHES, _fused_gpt2.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launches() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
