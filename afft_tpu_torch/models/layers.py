"""Primitives shared by the port's modules: the additive attention masks,
dropout and drop-path with an explicit generator, the fusers' attention
site (``attention``: row 4's kernel under autograd where the JAX package
takes its Pallas kernel, the plain arithmetic elsewhere), the
cross-attention layer and seeded initialisers.

The modules build their LayerNorms with an explicit eps (1e-6 in the fuser,
1e-5 in the GPT-2 predictor); the GELUs (exact erf in the fuser MLP, tanh
"gelu_new" in GPT-2) are applied in ``ops``. Initialisers draw from an
explicit ``torch.Generator`` with the same distributions as
afft_tpu/models/layers.py (not the same numbers).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from ..ops import attention as FA


def neg_inf_causal_mask(sz: int, dtype=torch.float32, device=None):
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(torch.full((sz, sz), float("-inf"), dtype=dtype,
                                 device=device), diagonal=1)


def cross_attention_diag_mask(sz: int, dtype=torch.float32, device=None):
    """-inf on the diagonal (each modality masks itself), 0 elsewhere."""
    eye = torch.eye(sz, dtype=torch.bool, device=device)
    return torch.zeros((sz, sz), dtype=dtype, device=device).masked_fill(
        eye, float("-inf"))


class RngStream:
    """The randomness of training steps, drawn from explicit generators (the
    port's counterpart of afft_tpu/models/layers.py RngStream): ``gen``, a
    generator on the model's device, feeds the dropout and drop-path masks
    that PyTorch ops draw; ``seed_words`` hands the fuser stack the two seed
    words from which the training kernels compute their masks. The seed
    words come from a host generator, so drawing them never waits for the
    device.

    Data parallelism: a step on ``world`` processes is the one-process step
    over the global batch, the processes' equal local batches in rank order.
    Every process holds the same generators (one seed), so each draw is the
    global batch's: ``_uniform_like`` draws the global rows and keeps this
    rank's, and the training kernels start their masks at ``row_offset``.
    Under pipeline parallelism ``rank`` and ``world`` are the data replica
    and the replica count (``parallel.mesh.Grid``'s ``data`` and
    ``replicas``): the stages of one replica hold the same rows and draw
    alike."""

    def __init__(self, seed: int, device="cpu", rank: int = 0,
                 world: int = 1):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self._host = torch.Generator()
        self._host.manual_seed(int(seed))
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world} processes")
        self.rank, self.world = int(rank), int(world)

    def seed_words(self):
        """Two ints in [0, 2^31 - 1), as the JAX fuser stack draws them."""
        return torch.randint(0, 2 ** 31 - 1, (2,),
                             generator=self._host).tolist()

    def row_offset(self, local_rows: int, part: int = 0,
                   parts: int = 1) -> int:
        """The global batch's row that this rank's first row is, or the
        first row of ``part`` of ``parts`` equal parts of its rows (a
        pipeline microbatch)."""
        return self.rank * int(local_rows) + part * (int(local_rows) // parts)

    @contextlib.contextmanager
    def microbatch(self, index: int, count: int):
        """Draws for microbatch ``index`` of ``count`` (``train.grad_accum``):
        each rank's local batch is cut into ``count`` equal chunks, and the
        step's global batch is ordered microbatch-major (chunk 0 of every
        rank in rank order, then chunk 1, ...). Inside, a draw covers that
        whole global batch and keeps the rows of this rank's chunk
        ``index``, and the training kernels' masks start at its first
        row. With the generators reset to the step's start before each
        microbatch, every row gets the mask it gets in one pass over the
        batch so ordered."""
        rank, world = self.rank, self.world
        self.rank, self.world = index * world + rank, count * world
        try:
            yield self
        finally:
            self.rank, self.world = rank, world


def _uniform_like(shape, x, rng):
    """U[0, 1) of ``shape`` (rows first): this rank's rows of one draw over
    the global batch."""
    if rng is None:
        raise ValueError("training with a dropout or drop-path rate > 0 "
                         "needs an RngStream")
    if rng.world == 1:
        return torch.rand(shape, generator=rng.gen, device=x.device)
    rows = shape[0]
    draw = torch.rand((rows * rng.world,) + tuple(shape[1:]),
                      generator=rng.gen, device=x.device)
    return draw[rng.rank * rows:(rng.rank + 1) * rows]


def dropout(x, rate: float, train: bool, rng):
    """Keep with probability 1 - rate and scale by 1 / keep
    (afft_tpu/models/layers.py:145)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform_like(x.shape, x, rng) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x, rate: float, train: bool, rng):
    """Stochastic depth per sample (afft_tpu/models/layers.py:153)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.floor(keep + _uniform_like(shape, x, rng)).to(x.dtype)
    return x / keep * mask


def drop_path_schedule(drop_path_rate: float, depth: int):
    """Stochastic-depth decay: linspace(0, rate, depth) over the blocks
    (afft_tpu/models/blocks.py:161)."""
    if depth == 1:
        return [0.0]
    return [drop_path_rate * i / (depth - 1) for i in range(depth)]


def attention(q, k, v, mask=None, *, attn_drop=0.0, train=False, rng=None,
              return_weights=False, impl="kernel"):
    """An attention site of the fusers: q (B, Nq, H, hd), k, v (B, Nk, H,
    hd) -> (out (B, Nq, H, hd), weights (B, H, Nq, Nk) after their dropout,
    or None). Where the JAX package takes its Pallas kernel
    (``ops.attention.uses_kernel``) this is ``ops.attention``'s
    ``multihead_attention``: the differentiable ``FusedAttentionFn``
    (``impl="plain"``: the kernel's plain version, for the comparison on
    the card); elsewhere the plain arithmetic of the fuser's attention under
    autograd: scores in the operands' dtype, the fp32 mask promoting them,
    softmax, the weights' dropout drawn here."""
    if FA.uses_kernel(attn_drop=attn_drop, train=train,
                      return_weights=return_weights):
        return FA.multihead_attention(q, k, v, mask, impl=impl)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    weights = (q @ k.transpose(-2, -1)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        weights = weights + mask
    weights = dropout(weights.softmax(dim=-1), attn_drop, train, rng)
    out = (weights.to(v.dtype) @ v).permute(0, 2, 1, 3)
    return out, (weights if return_weights else None)


class CrossAttention(nn.Module):
    """Attention of x (B, N, C) into a memory stream mem (B, M, C) through
    separate projections ``w_q``, ``w_k``, ``w_v`` and ``proj`` (port of
    afft_tpu/models/blocks.py cross_attention_init / cross_attention_apply;
    reference models/transformerblock.py CrossAttention). The attention is
    ``attention``: ``fused_attention`` (the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors) unless attention dropout is in force;
    in training mode under autograd, with the dropouts of
    ``cross_attention_apply`` (:60-76): on the attention weights and on the
    projected output.

    This is the general layer: mem may have another length and width than
    x. In eval mode the DecoderBlock runs ``ops.fused_decoder_block`` on
    this layer's parameters; its training path calls this forward."""

    def __init__(self, dim, num_heads, mem_dim=None, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        mem_dim = mem_dim or dim
        self.w_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.w_k = nn.Linear(mem_dim, dim, bias=qkv_bias)
        self.w_v = nn.Linear(mem_dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, gen):
        for lin in (self.w_q, self.w_k, self.w_v, self.proj):
            init_normal_linear(lin.weight, lin.bias, 0.02, gen)

    def forward(self, x, mem, mask=None, *, attn_drop=0.0, proj_drop=0.0,
                rng=None, impl="kernel"):
        B, N, C = x.shape
        M = mem.shape[1]
        hd = C // self.num_heads
        q = self.w_q(x).reshape(B, N, self.num_heads, hd)
        k = self.w_k(mem).reshape(B, M, self.num_heads, hd)
        v = self.w_v(mem).reshape(B, M, self.num_heads, hd)
        out, _ = attention(q, k, v, mask, attn_drop=attn_drop,
                           train=self.training, rng=rng, impl=impl)
        out = self.proj(out.reshape(B, N, C))
        return dropout(out, proj_drop, self.training, rng)


# -- seeded initialisers ------------------------------------------------------

@torch.no_grad()
def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """N(0, std): timm's trunc_normal_(std=.02) truncates at +-2, i.e. at
    +-100 sigma, so the plain normal is the same distribution in practice."""
    return t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                               dtype=torch.float32) * std)


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    return t.copy_((torch.rand(t.shape, generator=gen, device=t.device,
                               dtype=torch.float32) * 2 - 1) * bound)


@torch.no_grad()
def init_torch_linear(lin: nn.Linear, gen: torch.Generator):
    """torch.nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(lin.in_features)
    uniform_(lin.weight, bound, gen)
    if lin.bias is not None:
        uniform_(lin.bias, bound, gen)


@torch.no_grad()
def init_normal_linear(weight, bias, std: float, gen: torch.Generator):
    """Fuser and GPT-2 init: N(0, std) weight, zero bias."""
    normal_(weight, std, gen)
    if bias is not None:
        bias.zero_()


@torch.no_grad()
def init_layer_norm(norm: nn.LayerNorm):
    if norm.weight is not None:
        norm.weight.fill_(1.0)
        norm.bias.zero_()
