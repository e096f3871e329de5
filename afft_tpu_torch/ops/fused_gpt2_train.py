"""One GPT-2 layer of the future predictor in training mode: CUDA kernels
(forward and two backward halves), the mask generator, and their plain
versions.

Replaces ``afft_tpu/ops/pallas_gpt2_train.py``: ``fused_gpt2_block_train``
(``_attn_half_train_kernel`` and ``_mlp_half_train_kernel``: the forward
entry; ``_mlp_bwd1_kernel`` and ``_mlp_bwd2_kernel``: the MLP backward;
``_attn_bwd_kernel``: the attention backward) and ``draw_masks_gpt2``
(``_masks_gpt2_kernel``). The layer is the serving layer
(``ops.fused_gpt2``) with dropout on the attention probabilities
(``attn_pdrop``) and on both residual branches (``resid_pdrop``).

``params`` holds the layer's tensors under the state-dict names relative to
``gpt_model.h.N`` (``ln_1.weight``, ``attn.c_attn.weight``, ...): HF Conv1D
(in, out) weights, ``c_attn`` packed [q | k | v] with heads minor, as
``ops.fused_gpt2`` reads them. The JAX kernel packs qkv heads-major; here
every gradient comes out in its parameter's own layout
(``weights.grads_from_jax`` carries the JAX ones over).

``fused_gpt2_block_train`` is differentiable in ``x`` and the parameters. On
CUDA tensors it is ``ops.fused_block_train.BlockTrainFunction`` on the
entries of ``csrc/fused_gpt2_train.cu``: the forward saves ``x, y, qkv,
pre1`` in the working dtype, the backward runs the MLP half, then the
attention half, the weight and bias gradients included (the JAX package
computes those eight products in XLA, outside its kernels). On CPU tensors
it draws the masks with ``draw_masks_gpt2_plain`` and runs
``fused_gpt2_block_train_plain`` under autograd.

In bf16 every product runs on the Hopper GEMM (``csrc/gemm_sm90.cuh``):
the forward reads the Conv1D (in, out) weights as its (K, N) operand, the
backward's dX (dpre1, dg, dattn, dxn) reads them where they lie as its
K-major (N, K) operand, the weight gradients take its TN route. So a CUDA
call takes the GEMM's operand rules, which ``gpt2_operands`` applies and
raises on: one dtype (bf16, or fp32 for the parity checks, on the fp32
GEMM), contiguous and 16-byte aligned tensors, any C and hidden (packed
where a product's rows are off TMA's 16-byte grid); and the length rule of
``_common.check_length`` (past 32 tokens the attention and its backward
take ``csrc/long_attention.cuh``).

Masks: those of ``ops.fused_block_train`` (Philox4x32-10 of the two seed
words, the layer index, the site and the logical element index) at the TPU
kernel's sites 0 (attention), 1 (proj) and 3 (MLP). Element indices:
attention ``((b * H + h) * T + tq) * T + tk``; proj and MLP
``(b * T + t) * C + c``.

Cast chain (``pallas_gpt2_train.py:84-150``): qkv is rounded to the working
dtype (and stashed); the dropped probabilities are rounded before P . V; the
attention output is rounded; y = x + proj * mask is rounded, and the MLP half
works on that rounded y; pre1 is stashed rounded, gelu_new is taken from the
fp32 value in the forward and from the stash in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (add_bias, check_heads, check_length, check_operands,
                      check_shape, check_shard, launch, layer_norm32,
                      lead_only, mask_operand, matmul32, ptr_array)
from .fused_block_train import (BlockTrainFunction, Layer,
                                PlainBlockTrainFunction, ShardTrainFunction,
                                attention_drop_plain, check_row0,
                                check_seeds, masks_plain, rate_arrays)
from .fused_block_train import rates_operands as _rates_operands

LAUNCHES = {"fused_gpt2_train_fwd": 0, "fused_gpt2_train_bwd_mlp": 0,
            "fused_gpt2_train_bwd_attn": 0, "draw_masks_gpt2": 0}

GPT2 = Layer("fused_gpt2_train", "gpt2_train", LAUNCHES, False)

# the three mask sites (pallas_gpt2_train.py:45), in the order of every mask
# tuple, and the rate each draws with: 0 attention, 1 both residual branches
SITES = (0, 1, 3)
_RATE_OF_SITE = (0, 1, 1)

# the layer's tensors in the kernels' order
KEYS = ("ln_1.weight", "ln_1.bias", "attn.c_attn.weight", "attn.c_attn.bias",
        "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
        "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
        "mlp.c_proj.bias")
_WEIGHTS = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
            "mlp.c_proj.weight")


def rates_operands(attn_rate, resid_rate):
    """Rates -> (24-bit keep thresholds, 1 / keep scales): index 0 the
    attention probabilities, 1 both residual branches, 2 the fuser's
    drop-path slot, which keeps everything here."""
    return _rates_operands(attn_rate, resid_rate, 0.0)


def mask_shapes(B, T, C, num_heads):
    return ((B, num_heads, T, T), (B * T, C), (B * T, C))


def draw_masks_gpt2_plain(B, T, C, num_heads, seeds, layer_idx, attn_rate,
                          resid_rate, device="cpu", row0: int = 0):
    """The three masks of one layer, already scaled by 1 / keep, fp32:
    attention (B, H, T, T), proj (B * T, C), MLP (B * T, C), of rows ``row0
    .. row0 + B - 1`` of the global batch. The generator in torch ops, on
    any device."""
    seeds = check_seeds(seeds)
    thr, inv = rates_operands(attn_rate, resid_rate)
    shapes = mask_shapes(B, T, C, num_heads)
    # proj and MLP masks as (B, T * C): a row of the batch first
    masks = masks_plain((shapes[0], (B, T * C), (B, T * C)), SITES,
                        _RATE_OF_SITE, seeds, layer_idx, thr, inv,
                        check_row0(row0), device)
    return tuple(m.reshape(shape) for m, shape in zip(masks, shapes))


def draw_masks_gpt2(B, T, C, num_heads, seeds, layer_idx, attn_rate,
                    resid_rate, device="cuda", row0: int = 0):
    """The three masks as ``draw_masks_gpt2_plain``: the plain version on
    the CPU, the kernel on a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_masks_gpt2_plain(B, T, C, num_heads, seeds, layer_idx,
                                     attn_rate, resid_rate, row0=row0)
    if device.type != "cuda":
        raise ValueError(f"draw_masks_gpt2: unsupported device {device}")
    arrays = rate_arrays(seeds, layer_idx, attn_rate, resid_rate, 0.0, row0)
    masks = tuple(torch.empty(shape, dtype=torch.float32, device=device)
                  for shape in mask_shapes(B, T, C, num_heads))
    launch("draw_masks_gpt2", "afft_draw_masks_gpt2", *arrays,
           ptr_array(masks), B, T, C, num_heads, device=device)
    LAUNCHES["draw_masks_gpt2"] += 1
    return masks


# -- the plain version --------------------------------------------------------

def gpt2_attn_half_train_plain(x, params, mask, masks, *, num_heads: int,
                               eps: float = 1e-5):
    """x (B, T, C) -> (y (B * T, C) rounded to x.dtype, qkv as the forward
    rounds it): LN1, qkv, attention with dropout on the probabilities, proj
    with dropout, + x."""
    B, T, C = x.shape
    dt = x.dtype
    g = params.get
    x32 = x.reshape(B * T, C).float()
    xn = layer_norm32(x32, g("ln_1.weight"), g("ln_1.bias"), eps).to(dt)
    qkv = add_bias(matmul32(xn, params["attn.c_attn.weight"], True),
                   g("attn.c_attn.bias")).to(dt)
    attn = attention_drop_plain(qkv, mask, masks[0], T, num_heads,
                                round_to=dt).to(dt)
    proj = add_bias(matmul32(attn, params["attn.c_proj.weight"], True),
                    g("attn.c_proj.bias"))
    return (x32 + proj * masks[1]).to(dt), qkv


def gpt2_mlp_half_train_plain(y, params, masks, *, eps: float = 1e-5):
    """The rounded y (B * T, C) -> (out (B * T, C) in y.dtype, the fp32
    pre-activation): LN2, fc1, gelu_new, fc2 with dropout, + y."""
    dt = y.dtype
    g = params.get
    y32 = y.float()
    yn = layer_norm32(y32, g("ln_2.weight"), g("ln_2.bias"), eps).to(dt)
    pre1 = add_bias(matmul32(yn, params["mlp.c_fc.weight"], True),
                    g("mlp.c_fc.bias"))
    h1 = F.gelu(pre1, approximate="tanh").to(dt)
    h2 = add_bias(matmul32(h1, params["mlp.c_proj.weight"], True),
                  g("mlp.c_proj.bias"))
    return (y32 + h2 * masks[2]).to(dt), pre1


def _gpt2_train_fwd_plain(x, params, mask, masks, num_heads, eps):
    """The training layer's forward in PyTorch ops: (out (B, T, C), and the
    stashed y, qkv, pre1), all in x.dtype."""
    B, T, C = x.shape
    y, qkv = gpt2_attn_half_train_plain(x, params, mask, masks,
                                        num_heads=num_heads, eps=eps)
    out, pre1 = gpt2_mlp_half_train_plain(y, params, masks, eps=eps)
    return out.reshape(B, T, C), y, qkv, pre1.to(x.dtype)


def fused_gpt2_block_train_plain(x, params, mask, masks, *, num_heads: int,
                                 eps: float = 1e-5, return_residuals=False):
    """The training layer in PyTorch ops with the kernels' forward cast
    chain, given the three explicit masks of ``draw_masks_gpt2`` (the
    counterpart of ``pallas_gpt2_train.gpt2_block_reference_with_masks``).
    Returns (B, T, C) in x.dtype, differentiable in x and the parameters:
    its backward is ``fused_block_train.block_train_bwd_plain`` with the
    GPT-2 layer's cast chain, the backward kernels' plain version
    (``PlainBlockTrainFunction``). With ``return_residuals`` the forward
    alone, with the stashed ``y, qkv, pre1``."""
    if return_residuals:
        return _gpt2_train_fwd_plain(x, params, mask, masks, num_heads, eps)
    return PlainBlockTrainFunction.apply(
        x, mask, (_gpt2_train_fwd_plain, KEYS, masks, num_heads, eps, True),
        *[params.get(k) for k in KEYS])


# -- the shard mode's plain version (tensor parallelism) ----------------------

def gpt2_attn_half_shard_plain(x, params, mask, masks, *, num_heads: int,
                               rank: int, eps: float = 1e-5):
    """``gpt2_attn_half_train_plain`` on model rank ``rank``'s shard
    (``parallel.sharding``: c_attn's columns [q | k | v] of heads rank *
    H_l .. (rank + 1) * H_l - 1, c_proj's rows of them; ``num_heads`` the
    layer's H, ``masks`` the whole layer's): (the fp32 partial sum (B * T,
    C) of y, the local qkv as the forward rounds it). The residual x and
    c_proj's bias are added on rank 0 only; summed over the ranks and
    rounded it is the whole half's y."""
    B, T, C = x.shape
    dt = x.dtype
    g = params.get
    A = params["attn.c_proj.weight"].shape[0]
    local = num_heads * A // C
    x32 = x.reshape(B * T, C).float()
    xn = layer_norm32(x32, g("ln_1.weight"), g("ln_1.bias"), eps).to(dt)
    qkv = add_bias(matmul32(xn, params["attn.c_attn.weight"], True),
                   g("attn.c_attn.bias")).to(dt)
    mattn = masks[0][:, rank * local:(rank + 1) * local]
    attn = attention_drop_plain(qkv, mask, mattn, T, local,
                                round_to=dt).to(dt)
    proj = add_bias(matmul32(attn, params["attn.c_proj.weight"], True),
                    lead_only(g("attn.c_proj.bias"), rank))
    part = proj * masks[1]
    return (x32 + part if rank == 0 else part), qkv


def gpt2_mlp_half_shard_plain(y, params, masks, *, rank: int,
                              eps: float = 1e-5):
    """``gpt2_mlp_half_train_plain`` on rank ``rank``'s MLP columns: the
    fp32 partial sum (B * T, C) of the half's output (y and the bias of
    mlp.c_proj on rank 0 only)."""
    dt = y.dtype
    g = params.get
    y32 = y.float()
    yn = layer_norm32(y32, g("ln_2.weight"), g("ln_2.bias"), eps).to(dt)
    pre1 = add_bias(matmul32(yn, params["mlp.c_fc.weight"], True),
                    g("mlp.c_fc.bias"))
    h1 = F.gelu(pre1, approximate="tanh").to(dt)
    h2 = add_bias(matmul32(h1, params["mlp.c_proj.weight"], True),
                  lead_only(g("mlp.c_proj.bias"), rank))
    part = h2 * masks[2]
    return y32 + part if rank == 0 else part


def fused_gpt2_block_train_shard_plain(x, params, mask, masks, *,
                                       num_heads: int, shard,
                                       eps: float = 1e-5):
    """The training layer on model rank ``shard.rank``'s shard in
    differentiable PyTorch ops, the plain version of the entries' shard mode
    (``ShardTrainFunction``): Megatron's f (``shard.comm.f``: identity,
    the gradient summed over the model group) before each half, its partial
    sum, g (``shard.comm.g``: the sum over the group, identity backward)
    and one rounding after it. Under sequence parallelism
    (``shard.sp``) x and the result are T-shards: the first f is an
    all-gather over T (a reduce-scatter backward) and the last g a
    reduce-scatter over T (an all-gather backward). ``masks`` are the whole
    layer's (``draw_masks_gpt2``). The two halves alone
    (``gpt2_attn_half_shard_plain``, ``gpt2_mlp_half_shard_plain``) give
    the partial sums without a process group."""
    B, T, C = x.shape
    dt = x.dtype
    comm = shard.comm
    x = comm.f_seq(x) if shard.sp else comm.f(x)
    T = x.shape[1]
    part, _ = gpt2_attn_half_shard_plain(x, params, mask, masks,
                                         num_heads=num_heads,
                                         rank=shard.rank, eps=eps)
    y = comm.f(comm.g(part).to(dt))
    part = gpt2_mlp_half_shard_plain(y, params, masks, rank=shard.rank,
                                     eps=eps).reshape(B, T, C)
    out = comm.g_seq(part) if shard.sp else comm.g(part)
    return out.to(dt)


# -- the kernels under autograd -----------------------------------------------

def gpt2_operands(name, x, params, num_heads, count: int = 1):
    """Check a layer's tensors against x (B, T, C) for a CUDA launch
    (``count`` > 1: a shard of ``num_heads`` local heads, of width A = C /
    count); returns (the twelve tensors in the kernels' order, hidden)."""
    C = x.shape[-1]
    A = C // count
    tensors = [params[k] if k in _WEIGHTS else params.get(k) for k in KEYS]
    hidden = tensors[8].shape[-1]
    if count > 1:
        check_shard(name, C, num_heads * count, hidden * count, count)
    check_heads(name, A, num_heads)
    shapes = ((C,), (C,), (C, 3 * A), (3 * A,), (A, C), (C,), (C,), (C,),
              (C, hidden), (hidden,), (hidden, C), (C,))
    for key, t, shape in zip(KEYS, tensors, shapes):
        check_shape(name, key, t, shape)
    if (tensors[0] is None) != (tensors[1] is None) \
            or (tensors[6] is None) != (tensors[7] is None):
        raise ValueError(f"{name}: LayerNorm weight and bias go together")
    check_operands(name, x, dict(zip(KEYS, tensors)), differentiable=True)
    return tensors, hidden


def fused_gpt2_block_train(x, params, mask, seeds, *, num_heads: int,
                           layer_idx: int = 0, attn_rate: float = 0.0,
                           resid_rate: float = 0.0, eps: float = 1e-5,
                           row0: int = 0, shard=None):
    """One GPT-2 layer in training mode on x (B, T, C); returns (B, T, C) in
    x.dtype, differentiable in x and the parameters. ``seeds`` are two
    ints in [0, 2^31), ``layer_idx`` the layer's position in its stack,
    ``row0`` the global batch's row that x's first row is.

    ``shard`` (an ``ops._common.Shard``): ``params`` hold model rank
    ``shard.rank``'s shard (``parallel.sharding.shard_state``; ``num_heads``
    stays the layer's H), the call is the whole layer's on every rank of
    the model group, and the ln_1 / ln_2 gradients are partial sums. Under
    ``shard.sp`` x and the result are this rank's T-shard (B, T / count, C).

    CPU tensors take the plain version on masks from
    ``draw_masks_gpt2_plain``; CUDA tensors launch the kernels."""
    name = "fused_gpt2_train"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if shard is not None and shard.sp:
        T *= shard.count
    if x.device.type == "cpu":
        masks = draw_masks_gpt2_plain(B, T, C, num_heads, seeds, layer_idx,
                                      attn_rate, resid_rate, row0=row0)
        if shard is not None:
            return fused_gpt2_block_train_shard_plain(
                x, params, mask, masks, num_heads=num_heads, shard=shard,
                eps=eps)
        return fused_gpt2_block_train_plain(x, params, mask, masks,
                                            num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    count = 1 if shard is None else shard.count
    local = num_heads // count
    tensors, hidden = gpt2_operands(name, x, params, local, count)
    check_length(name, "gpt2", T, C // num_heads)
    mask32 = mask_operand(name, mask, T, x.device)
    if B == 0:
        return torch.empty_like(x)
    arrays = rate_arrays(seeds, layer_idx, attn_rate, resid_rate, 0.0, row0)
    if shard is not None:
        return ShardTrainFunction.apply(
            x, mask32, (local, hidden, eps, arrays, GPT2), shard, *tensors)
    return BlockTrainFunction.apply(x, mask32,
                                    (num_heads, hidden, eps, arrays, GPT2),
                                    *tensors)
