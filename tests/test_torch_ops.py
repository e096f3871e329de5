"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors ``afft_tpu_torch.ops`` runs each kernel's plain version. It is
held against the JAX Pallas kernel in interpret mode (as tests/test_ops.py
runs it) and against the JAX XLA path, on the same numpy-seeded inputs and
the same weights carried across by ``afft_tpu_torch.weights``. Tolerances
are tests/test_ops.py's: 2e-5 for a fuser block, a sequence block, a decoder
block and the attention, 3e-5 for a GPT-2 layer (fp32; only the summation
order differs).
"""

import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.models import blocks as JB
from afft_tpu.models import layers as JL
from afft_tpu.models.predictor import BaseFuturePredictor as JaxPredictor
from afft_tpu.ops import pallas_seq_block as JPS
from afft_tpu.ops.attention import attention_reference
from afft_tpu.ops.pallas_attn import fused_attention as jax_fused_attention
from afft_tpu.ops.pallas_block import fused_block as jax_fused_block
from afft_tpu.ops.pallas_gpt2 import fused_gpt2_block as jax_fused_gpt2
from afft_tpu_torch import weights as W
from afft_tpu_torch.models.blocks import Block, DecoderBlock
from afft_tpu_torch.models.layers import CrossAttention
from afft_tpu_torch.ops import attention as FA
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_gpt2 as FG
from afft_tpu_torch.ops import fused_seq_block as FS
from afft_tpu_torch.ops import launch_counts, reset_launches

BLOCK_TOL = 2e-5
GPT2_TOL = 3e-5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
NO_LAUNCHES = {"fused_block": 0, "gpt2_attn_half": 0, "gpt2_mlp_half": 0,
               "fused_attention": 0, "fused_seq_block": 0,
               "fused_decoder_block": 0, "fused_block_train_fwd": 0,
               "fused_block_train_bwd_mlp": 0,
               "fused_block_train_bwd_attn": 0, "draw_masks": 0,
               "attention_drop": 0, "attention_drop_bwd": 0,
               "fused_gpt2_train_fwd": 0, "fused_gpt2_train_bwd_mlp": 0,
               "fused_gpt2_train_bwd_attn": 0, "draw_masks_gpt2": 0,
               "gemm": 0, "gemm_tn": 0, "pack_rows": 0,
               "draw_site_mask": 0, "drop_grad": 0}


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
    assert launch_counts() == NO_LAUNCHES
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
                                "gpt2_mlp_half", "fused_attention",
                                "fused_seq_block", "fused_decoder_block"])
def test_wrappers_reject_other_devices(fn):
    x = torch.empty((2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        if fn == "fused_block":
            FB.fused_block(x, {}, num_heads=4)
        elif fn == "gpt2_attn_half":
            FG.gpt2_attn_half(x, {}, None, num_heads=4)
        elif fn == "gpt2_mlp_half":
            FG.gpt2_mlp_half(x, {})
        elif fn == "fused_attention":
            q = x.reshape(2, 4, 2, 32)
            FA.fused_attention(q, q, q)
        elif fn == "fused_seq_block":
            FS.fused_seq_block(x, {}, num_heads=4)
        else:
            FS.fused_decoder_block(x, x, {}, num_heads=4)


# -- attention over separate q, k, v (pallas_attn.fused_attention) -----------

def _cache_mask(n_q, n_k, pos):
    """The rollout's mask: query i sits at position pos + i and sees the
    cache slots written so far."""
    key_pos = np.arange(n_k)[None, :]
    query_pos = pos + np.arange(n_q)[:, None]
    return np.where(key_pos <= query_pos, 0.0, -np.inf).astype(np.float32)


@pytest.mark.parametrize("n_q,n_k,mask_kind,hd", [
    pytest.param(6, 6, None, 128, id="6-6-None"),
    pytest.param(6, 6, "causal", 128, id="6-6-causal"),
    pytest.param(1, 19, "cache", 128, id="1-19-cache"),
    pytest.param(16, 19, "cache", 128, id="16-19-cache"),
    # the CA decoder's cross-attention (row 6: S 10, heads of 256)
    pytest.param(10, 10, "causal", 256, id="10-10-causal-256"),
    # more queries than keys
    pytest.param(24, 7, None, 128, id="24-7-None")])
def test_attention_matches_jax(n_q, n_k, mask_kind, hd):
    B, H = 4, 2  # the TPU kernel wants hd % 128 == 0
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, n_q, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_k, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_k, H, hd)).astype(np.float32)
    mask = {None: None,
            "causal": np.asarray(JL.neg_inf_causal_mask(n_q, jnp.float32)),
            "cache": _cache_mask(n_q, n_k, n_k - 3 - (n_q - 1))}[mask_kind]
    jmask = None if mask is None else jnp.asarray(mask)
    want_pallas = jax_fused_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jmask, interpret=True,
                                      block_b=2)
    want_xla, want_w = attention_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jmask)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.tensor(mask)

    reset_launches()
    got, none = FA.multihead_attention(tq, tk, tv, tmask)
    assert none is None and launch_counts() == NO_LAUNCHES
    assert got.shape == (B, n_q, H, hd) and got.dtype == torch.float32
    _close(got, want_pallas, BLOCK_TOL, "vs pallas interpret")
    _close(got, want_xla, BLOCK_TOL, "vs attention_reference")

    # asking for the weights is the plain path, counted as such
    before = FA.PLAIN_WEIGHTS_CALLS["attention_weights"]
    got2, weights = FA.multihead_attention(tq, tk, tv, tmask,
                                           return_weights=True)
    assert FA.PLAIN_WEIGHTS_CALLS["attention_weights"] == before + 1
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    _close(weights, want_w, BLOCK_TOL, "weights")


def test_attention_takes_strided_views_and_rejects_bad_operands():
    """q as a column slice of a packed projection and k / v as caches with
    slots beyond the mask give what contiguous copies give; a masked slot's
    content never reaches the result."""
    B, S, T_max, H, hd = 3, 2, 7, 2, 16
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, 3, H, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal(
        (B, T_max, H, hd)).astype(np.float32))
    vc = kc.flip(1).clone()
    mask = torch.from_numpy(_cache_mask(S, T_max, 3))
    q = qkv[:, :, 0]
    assert not q.is_contiguous()
    got = FA.fused_attention(q, kc, vc, mask)
    want = FA.fused_attention(q.contiguous(), kc[:, :5].contiguous(),
                              vc[:, :5].contiguous(), mask[:, :5])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="k has shape"):
        FA.fused_attention(q, kc[:, :, :1], vc)
    with pytest.raises(TypeError, match="v is"):
        FA.fused_attention(q, kc, vc.double())
    with pytest.raises(ValueError, match=r"\(B, N, H, hd\)"):
        FA.fused_attention(q[0], kc, vc)


# -- the temporal fusers' blocks (pallas_seq_block) --------------------------

def _tiled_causal(frames, mods):
    return np.tile(np.asarray(JL.neg_inf_causal_mask(frames, jnp.float32)),
                   (mods, mods))


@pytest.mark.parametrize("masked,affine,qkv_bias", [
    (True, True, False), (True, False, True), (False, True, True)])
def test_fused_seq_block_matches_jax(masked, affine, qkv_bias):
    B, S, C, H = 4, 12, 256, 2  # 3 modalities x 4 frames
    rng = np.random.default_rng(13)
    p = _perturbed(JB.block_init(jax.random.key(1), C, H, qkv_bias=qkv_bias,
                                 norm_affine=affine), rng)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = _tiled_causal(4, 3) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want_pallas = JPS.fused_seq_block(jnp.asarray(x), _as_jax(p), jmask,
                                      num_heads=H, interpret=True, block_b=2)
    want_xla, _ = JB.block_apply(_as_jax(p), jnp.asarray(x), H, jmask,
                                 norm_eps=1e-6, need_weights=False)
    reset_launches()
    got = FS.fused_seq_block(
        torch.from_numpy(x), W.block_from_jax(p),
        None if mask is None else torch.from_numpy(mask), num_heads=H)
    assert launch_counts() == NO_LAUNCHES
    assert got.shape == (B, S, C) and got.dtype == torch.float32
    _close(got, want_pallas, BLOCK_TOL, "vs pallas interpret")
    _close(got, want_xla, BLOCK_TOL, "vs block_apply")


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_fused_decoder_block_matches_jax(qkv_bias):
    B, S, C, H = 4, 10, 256, 2
    rng = np.random.default_rng(14)
    p = _perturbed(JB.decoder_block_init(jax.random.key(2), C, None, H,
                                         qkv_bias=qkv_bias), rng)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    mem = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = JL.neg_inf_causal_mask(S, jnp.float32)
    want_pallas = JPS.fused_decoder_block(
        jnp.asarray(x), jnp.asarray(mem), _as_jax(p), mask, num_heads=H,
        interpret=True, block_b=2)
    want_xla = JB.decoder_block_apply(_as_jax(p), jnp.asarray(x),
                                      jnp.asarray(mem), H, mask)
    params = W.decoder_block_from_jax(p)
    assert ("cross_attn.w_q.bias" in params) == qkv_bias
    reset_launches()
    got = FS.fused_decoder_block(
        torch.from_numpy(x), torch.from_numpy(mem), params,
        torch.tensor(np.asarray(mask)), num_heads=H)
    assert launch_counts() == NO_LAUNCHES
    _close(got, want_pallas, BLOCK_TOL, "vs pallas interpret")
    _close(got, want_xla, BLOCK_TOL, "vs decoder_block_apply")
    with pytest.raises(ValueError, match="share a shape"):
        FS.fused_decoder_block(torch.from_numpy(x),
                               torch.from_numpy(mem[:, :5]), params,
                               num_heads=H)


@pytest.mark.parametrize("name", ["block_causal", "decoder_block"])
@torch.no_grad()
def test_seq_blocks_match_reference_fixtures(name):
    """The reference's own Block (with a causal mask) and DecoderBlock:
    the module path and the ops path both reproduce the golden output
    (tests/test_parity.py's tolerance, torch-default LN eps 1e-5)."""
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    sd = {k[4:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    x, mask = (torch.from_numpy(data[f"in::{k}"]) for k in ("x", "mask"))
    want = data["out::y"]
    if name == "block_causal":
        blk = Block(64, 4, norm_eps=1e-5)
        blk.load_state_dict(sd, strict=True)
        via_module, attn = blk(x, mask)
        np.testing.assert_allclose(attn.numpy(), data["out::attn"],
                                   rtol=1e-5, atol=2e-5)
        via_ops = FS.fused_seq_block(x, dict(blk.named_parameters()), mask,
                                     num_heads=4, eps=1e-5)
    else:
        mem = torch.from_numpy(data["in::mem"])
        blk = DecoderBlock(64, None, 4, norm_eps=1e-5)
        blk.load_state_dict(sd, strict=True)
        via_module = blk(x, mem, mask)
        via_ops = FS.fused_decoder_block(
            x, mem, dict(blk.named_parameters()), mask, num_heads=4,
            eps=1e-5)
    for got in (via_module, via_ops):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
@torch.no_grad()
def test_cross_attention_layer_matches_jax(masked):
    """The general layer, which no DecoderBlock forward runs: a memory
    stream of another length and width, against cross_attention_apply."""
    B, N, M, C, mem_dim, H = 2, 5, 9, 64, 40, 4
    rng = np.random.default_rng(16)
    p = _perturbed(JB.cross_attention_init(jax.random.key(7), C, mem_dim,
                                           qkv_bias=True), rng)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    mem = rng.standard_normal((B, M, mem_dim)).astype(np.float32)
    mask = None
    if masked:  # every query keeps a key
        mask = np.where(rng.random((N, M)) < 0.3, -np.inf, 0.0).astype(
            np.float32)
        mask[:, 0] = 0.0
    want = JB.cross_attention_apply(
        _as_jax(p), jnp.asarray(x), jnp.asarray(mem), H,
        None if mask is None else jnp.asarray(mask))
    layer = CrossAttention(C, H, mem_dim, qkv_bias=True)
    layer.load_state_dict(
        {f"{k}.{n}": torch.tensor(p[k][j]).T.contiguous() if n == "weight"
         else torch.tensor(p[k][j])
         for k in ("w_q", "w_k", "w_v", "proj")
         for n, j in (("weight", "w"), ("bias", "b"))}, strict=True)
    reset_launches()
    got = layer(torch.from_numpy(x), torch.from_numpy(mem),
                None if mask is None else torch.from_numpy(mask))
    assert launch_counts() == NO_LAUNCHES
    _close(got, want, BLOCK_TOL, "vs cross_attention_apply")


def test_seq_block_bf16_plain_keeps_dtype_and_cast_chain():
    """In bf16 the plain sequence block returns bf16 within bf16 resolution
    of the fp32 computation on the same (rounded) inputs."""
    B, S, C, H = 2, 12, 64, 4
    rng = np.random.default_rng(15)
    p = W.decoder_block_from_jax(_perturbed(
        JB.decoder_block_init(jax.random.key(6), C, None, H), rng))
    x, mem = (torch.from_numpy(rng.standard_normal((B, S, C))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    mask = torch.from_numpy(_tiled_causal(4, 3))
    p16 = {k: v.to(torch.bfloat16) for k, v in p.items()}
    p32 = {k: v.float() for k, v in p16.items()}
    got = FS.fused_decoder_block(x, mem, p16, mask, num_heads=H)
    ref = FS.fused_decoder_block(x.float(), mem.float(), p32, mask,
                                 num_heads=H)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=4e-2, atol=4e-2)
