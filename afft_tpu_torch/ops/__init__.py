"""Hand-written CUDA kernels of the serving and training paths, each beside
its plain PyTorch version.

- ``ops.fused_block``: one fuser block (replaces the TPU kernel
  ``afft_tpu/ops/pallas_block.py:fused_block``);
- ``ops.fused_gpt2``: one GPT-2 layer as two halves (replaces
  ``afft_tpu/ops/pallas_gpt2.py:fused_gpt2_block``);
- ``ops.attention``: attention over separate q, k, v (replaces
  ``afft_tpu/ops/pallas_attn.py:fused_attention``);
- ``ops.fused_seq_block``: the T-SA-Fuser block and the CA-Fuser decoder
  block (replace ``afft_tpu/ops/pallas_seq_block.py:fused_seq_block`` and
  ``:fused_decoder_block``);
- ``ops.fused_block_train``: one fuser block in training mode, forward and
  two backward kernels under autograd, and the dropout-mask generator
  (replace ``afft_tpu/ops/pallas_block_train.py:fused_block_train`` and
  ``:draw_masks``);
- ``ops.fused_gpt2_train``: one GPT-2 layer in training mode on the same
  autograd Function, and its mask generator (replace
  ``afft_tpu/ops/pallas_gpt2_train.py:fused_gpt2_block_train`` and
  ``:draw_masks_gpt2``);
- ``ops.gemm``: the entries' bf16 wgmma / TMA GEMM alone, C = A . W with a
  fused epilogue and the weight gradient A^T . B (its checks and timings; no
  model path calls it).

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches, so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

from . import _common
from . import attention as _attention
from . import fused_block as _fused_block
from . import fused_block_train as _fused_block_train
from . import fused_gpt2 as _fused_gpt2
from . import fused_gpt2_train as _fused_gpt2_train
from . import fused_seq_block as _fused_seq_block
from . import gemm as _gemm

_COUNTERS = (_fused_block.LAUNCHES, _fused_gpt2.LAUNCHES,
             _attention.LAUNCHES, _fused_seq_block.LAUNCHES,
             _fused_block_train.LAUNCHES, _fused_gpt2_train.LAUNCHES,
             _gemm.LAUNCHES, _common.PACK_LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def tp_launch_counts() -> dict:
    """The training entries' launches in shard mode (tensor parallelism)
    since the last reset; each is in ``launch_counts`` too."""
    return dict(_fused_block_train.TP_LAUNCHES)


def long_launch_counts() -> dict:
    """The launches since the last reset whose attention took the long
    route (``_common.check_length``), by wrapper; each is in
    ``launch_counts`` too."""
    return dict(_common.LONG_LAUNCHES)


def reset_launches() -> None:
    for counter in _COUNTERS + (_fused_block_train.TP_LAUNCHES,
                                _common.LONG_LAUNCHES):
        for name in counter:
            counter[name] = 0
