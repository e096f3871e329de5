"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors ``afft_tpu_torch.ops`` runs each kernel's plain version. It is
held against the JAX Pallas kernel in interpret mode (as tests/test_ops.py
runs it) and against the JAX XLA path, on the same numpy-seeded inputs and
the same weights carried across by ``afft_tpu_torch.weights``. Tolerances
are tests/test_ops.py's: 2e-5 for a fuser block, 3e-5 for a GPT-2 layer
(fp32; only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.models import blocks as JB
from afft_tpu.models import layers as JL
from afft_tpu.models.predictor import BaseFuturePredictor as JaxPredictor
from afft_tpu.ops.pallas_block import fused_block as jax_fused_block
from afft_tpu.ops.pallas_gpt2 import fused_gpt2_block as jax_fused_gpt2
from afft_tpu_torch import weights as W
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_gpt2 as FG
from afft_tpu_torch.ops import launch_counts, reset_launches

BLOCK_TOL = 2e-5
GPT2_TOL = 3e-5


def _perturbed(tree, rng):
    """numpy copy of a JAX param tree with random biases and LN affines
    (the inits are zero / one, which would hide a dropped term)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k == "b":
            out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        elif k == "g":
            out[k] = (1 + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("mask_kind,affine,qkv_bias", [
    (None, True, False), ("diag", True, True), (None, False, True),
    ("diag", False, False)])
def test_fused_block_matches_jax(mask_kind, affine, qkv_bias):
    R, N, C, H = 24, 5, 256, 2
    rng = np.random.default_rng(1)
    p = _perturbed(JB.block_init(jax.random.key(0), C, H, qkv_bias=qkv_bias,
                                 norm_affine=affine), rng)
    x = rng.standard_normal((R, N, C)).astype(np.float32)
    mask = JL.cross_attention_diag_mask(N) if mask_kind else None
    want_pallas = jax_fused_block(jnp.asarray(x), _as_jax(p), mask,
                                  num_heads=H, interpret=True, block_r=16)
    want_xla, _ = JB.block_apply(_as_jax(p), jnp.asarray(x), H, mask,
                                 norm_eps=1e-6, need_weights=False)

    reset_launches()
    got = FB.fused_block(
        torch.from_numpy(x), W.block_from_jax(p),
        None if mask is None else torch.tensor(np.asarray(mask)),
        num_heads=H, eps=1e-6)
    assert launch_counts() == {"fused_block": 0, "gpt2_attn_half": 0,
                               "gpt2_mlp_half": 0}
    assert got.shape == (R, N, C) and got.dtype == torch.float32
    _close(got, want_pallas, BLOCK_TOL, "vs pallas interpret")
    _close(got, want_xla, BLOCK_TOL, "vs block_apply")


def test_fused_gpt2_block_matches_jax():
    B, T, C, H = 8, 16, 256, 2
    fp = JaxPredictor(in_features=128, inter_dim=C, n_layer=1, n_head=H,
                      embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    rng = np.random.default_rng(2)
    blk = _perturbed(fp.init(jax.random.key(0))["blocks"][0], rng)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = JL.neg_inf_causal_mask(T, jnp.float32)
    want_pallas = jax_fused_gpt2(jnp.asarray(x), _as_jax(blk), mask,
                                 num_heads=H, interpret=True, block_b=4)
    want_xla, _ = fp._block(_as_jax(blk), jnp.asarray(x), mask, train=False,
                            rng=None, collect_attn=False)

    reset_launches()
    params = W.gpt2_block_from_jax(blk, H)
    mask_t = torch.tensor(np.asarray(mask))
    got = FG.fused_gpt2_block(torch.from_numpy(x), params, mask_t,
                              num_heads=H, eps=1e-5)
    assert sum(launch_counts().values()) == 0
    _close(got, want_pallas, GPT2_TOL, "vs pallas interpret")
    _close(got, want_xla, GPT2_TOL, "vs predictor._block")

    # the heads-major -> [q|k|v] re-interleave is what makes this agree:
    # the JAX packing read as it is passes every shape check and is wrong
    raw = dict(params)
    raw["attn.c_attn.weight"] = torch.tensor(blk["c_attn"]["w"])
    raw["attn.c_attn.bias"] = torch.tensor(blk["c_attn"]["b"])
    wrong = FG.fused_gpt2_block(torch.from_numpy(x), raw, mask_t,
                                num_heads=H)
    assert np.abs(wrong.numpy() - np.asarray(want_xla)).max() > 1e-2


def test_gpt2_halves_compose():
    B, T, C, H = 3, 6, 64, 2
    g = torch.Generator().manual_seed(3)
    shapes = {"ln_1.weight": (C,), "ln_1.bias": (C,),
              "attn.c_attn.weight": (C, 3 * C), "attn.c_attn.bias": (3 * C,),
              "attn.c_proj.weight": (C, C), "attn.c_proj.bias": (C,),
              "ln_2.weight": (C,), "ln_2.bias": (C,),
              "mlp.c_fc.weight": (C, 4 * C), "mlp.c_fc.bias": (4 * C,),
              "mlp.c_proj.weight": (4 * C, C), "mlp.c_proj.bias": (C,)}
    params = {k: torch.randn(s, generator=g) * 0.05
              for k, s in shapes.items()}
    x = torch.randn((B, T, C), generator=g)
    mask = torch.triu(torch.full((T, T), float("-inf")), 1)
    y = FG.gpt2_attn_half(x, params, mask, num_heads=H)
    torch.testing.assert_close(
        FG.gpt2_mlp_half(y, params),
        FG.fused_gpt2_block(x, params, mask, num_heads=H), rtol=0, atol=0)


def test_bf16_plain_keeps_dtype_and_cast_chain():
    """In bf16 the plain version returns bf16 and sits within bf16
    resolution of the fp32 computation on the same (rounded) inputs."""
    R, N, C, H = 6, 3, 64, 4
    rng = np.random.default_rng(5)
    p = W.block_from_jax(_perturbed(JB.block_init(jax.random.key(5), C, H),
                                    rng))
    x = torch.from_numpy(rng.standard_normal((R, N, C)).astype(np.float32))
    p16 = {k: v.to(torch.bfloat16) for k, v in p.items()}
    got = FB.fused_block(x.to(torch.bfloat16), p16, num_heads=H)
    ref = FB.fused_block(x.to(torch.bfloat16).float(),
                         {k: v.float() for k, v in p16.items()}, num_heads=H)
    assert got.dtype == torch.bfloat16
    # bf16 has 8 significant bits: 2^-7 relative, a few ulps of slack for
    # the rounded intermediates
    torch.testing.assert_close(got.float(), ref, rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("fn", ["fused_block", "gpt2_attn_half",
                                "gpt2_mlp_half"])
def test_wrappers_reject_other_devices(fn):
    x = torch.empty((2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        if fn == "fused_block":
            FB.fused_block(x, {}, num_heads=4)
        elif fn == "gpt2_attn_half":
            FG.gpt2_attn_half(x, {}, None, num_heads=4)
        else:
            FG.gpt2_mlp_half(x, {})
