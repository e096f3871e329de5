"""ops.gemm on the CPU: the plain versions of the Hopper GEMM
(csrc/gemm_sm90.cuh) that the entries run on the card, for each of its
epilogues and the fp32 output on the (K, N) weight route, for its (N, K)
route (the weight read where it lies: bias with a bf16 or fp32 out, the
exact GELU with or without the pre-activation stash, the gelu_new
derivative, the residual add and the residual add with dropout, each with
an fp32 residual or output), and of its weight-gradient route gemm_tn,
against the same arithmetic in JAX on the same numpy-made operands: the
fuser block's serving products (pallas_block.py) and training forward
products (pallas_block_train.py), the serving MLP half (pallas_gpt2.py),
and the MLP backward products of the fuser (pallas_block_train.py) and of
the GPT-2 layer (pallas_gpt2_train.py) with their own dimension numbers, at
ragged shapes; the dropout masks are the training forward's proj-site
masks; the wrappers refuse what the kernels do not take. The kernels
themselves run on the card only (chip_smoke.py's gemm phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.ops.pallas_block import _dot, _gelu_exact
from afft_tpu.ops.pallas_block_train import _gelu_grad
from afft_tpu.ops.pallas_gpt2 import _gelu_new
from afft_tpu.ops.pallas_gpt2_train import _gelu_new_grad
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import gemm as G

SEEDS = (20240607, 1234567)


def _operands(M, N, K, seed):
    rng = np.random.default_rng(seed)

    def bf16(*shape, std=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32)).bfloat16()
    return bf16(M, K), bf16(K, N, std=K ** -0.5), bf16(N, std=0.1), \
        bf16(M, N)


def _jax_epilogue(epi, a, w, b, r, masks):
    """acc + bias and the epilogue in fp32 (jnp), rounded to bf16."""
    f32 = [jnp.asarray(t.float().numpy()) for t in (a, w, b, r)]
    v = jnp.dot(f32[0], f32[1], precision=jax.lax.Precision.HIGHEST) + f32[2]
    if epi in ("gelu_erf", "pre_gelu"):
        v = jax.nn.gelu(v, approximate=False)
    elif epi in ("gelu_tanh", "pre_gelu_tanh"):
        v = jax.nn.gelu(v, approximate=True)
    elif epi == "gelu_bwd":
        v = v * _gelu_grad(f32[3])
    elif epi == "gelu_tanh_bwd":
        v = v * _gelu_new_grad(f32[3])
    elif epi == "res_drop":
        v = f32[3] + (v * jnp.asarray(masks[0].numpy())) * jnp.asarray(
            masks[1].numpy())
    elif epi == "bias_res":
        v = f32[3] + v
    return np.asarray(v.astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("M,N,K", [(1, 72, 24), (15, 136, 40),
                                   (33, 64, 96)])
@pytest.mark.parametrize("epi", list(G.ROUTE_EPILOGUES[True]))
def test_gemm_plain_matches_jax(epi, M, N, K):
    a, w, b, r = _operands(M, N, K, seed=M + N + K)
    kw = dict(seeds=SEEDS, block_idx=2, drop_rate=0.3, dp_rate=0.2,
              tokens=4)
    out, out2 = G.gemm(a, w, epi, b, r, stash=True, **kw)
    masks = G.drop_masks(M, N, 4, SEEDS, 2, 0.3, 0.2)
    want = _jax_epilogue(epi, a, w, b, r, masks)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    # both round one fp32 value to bf16; the summation orders differ, which
    # may flip a rounding by one ulp (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    if epi in ("pre_gelu_tanh", "res_drop"):
        pre = want if epi == "res_drop" else _jax_epilogue("bias", a, w, b,
                                                          r, None)
        np.testing.assert_allclose(out2.float().numpy(), pre, rtol=2 ** -7,
                                   atol=1e-6)
    else:
        assert out2 is None


@pytest.mark.parametrize("M,N,K", [(1, 72, 24), (15, 136, 40),
                                   (33, 64, 96)])
@pytest.mark.parametrize("epi", list(G.ROUTE_EPILOGUES[False]))
def test_nk_route_plain_matches_jax(epi, M, N, K):
    """The (N, K) route: w given as the (N, K) transpose of the (K, N)
    operand gives the (K, N) arithmetic, in bf16 throughout; res_drop on
    the training forward's proj-site masks, pre_gelu and res_drop with
    their stashes."""
    a, w, b, r = _operands(M, N, K, seed=M + N + K + 1)
    # res_drop in its proj form, into the fp32 residual stream: its fp32
    # out is within one bf16 rounding of JAX's rounded value
    out_dtype = torch.float32 if epi == "res_drop" else None
    kw = dict(seeds=SEEDS, block_idx=2, drop_rate=0.3, dp_rate=0.2,
              tokens=4, out_dtype=out_dtype)
    out, out2 = G.gemm(a, w.t().contiguous(), epi, b, r, stash=True,
                       w_in_out=False, **kw)
    masks = G.drop_masks(M, N, 4, SEEDS, 2, 0.3, 0.2)
    want = _jax_epilogue(epi, a, w, b, r, masks)
    assert out.dtype == (out_dtype or torch.bfloat16)
    assert out.shape == (M, N)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    if epi in ("pre_gelu", "res_drop"):
        pre = want if epi == "res_drop" else _jax_epilogue("bias", a, w, b,
                                                          r, None)
        np.testing.assert_allclose(out2.float().numpy(), pre, rtol=2 ** -7,
                                   atol=1e-6)
    else:
        assert out2 is None


@pytest.mark.parametrize("route", ["kn", "nk out32", "nk res32"])
def test_res_drop_masks_are_the_training_forwards_proj_masks(route):
    """The GEMM draws at the proj site (1) and the first drop-path site (2)
    of the training block: its masks equal draw_masks_plain's, and the
    elements it drops are exactly the zeros of their product, on the (K,
    N) route and on both (N, K) forms of the fuser's training forward (proj
    into the fp32 residual stream, fc2 adding it)."""
    R, N_TOK, C, H = 6, 4, 16, 2
    M = R * N_TOK
    masks = FT.draw_masks_plain(R, N_TOK, C, H, SEEDS, 3, 0.0, 0.3, 0.5)
    elem, rows = G.drop_masks(M, C, N_TOK, SEEDS, 3, 0.3, 0.5)
    assert torch.equal(elem, masks[1])
    assert torch.equal(rows[:, 0], masks[2].repeat_interleave(N_TOK))
    a, w, b, _ = _operands(M, C, 24, seed=5)
    zero = torch.zeros(M, C)
    kw = {}
    if route != "kn":
        w, kw = w.t().contiguous(), dict(w_in_out=False)
        if route == "nk out32":
            kw["out_dtype"] = torch.float32
    # a zero residual and the bias shifted by 64: no kept element is 0
    out, _ = G.gemm(a, w, "res_drop", (b.float() + 64).bfloat16(),
                    zero if route == "nk res32" else zero.bfloat16(),
                    seeds=SEEDS, block_idx=3, drop_rate=0.3, dp_rate=0.5,
                    tokens=N_TOK, **kw)
    assert out.dtype == kw.get("out_dtype", torch.bfloat16)
    assert torch.equal(out == 0, (elem * rows) == 0)
    assert 0 < int((out == 0).sum()) < out.numel()


def _bf16(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32).astype(
        jnp.bfloat16)


def _t(x):
    """A numpy bf16 (or fp32) array as a torch tensor of the same dtype."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


def _close_bf16(got, want):
    # both round one fp32 value to bf16; the summation orders differ, which
    # may flip a rounding by one ulp (2^-8 relative)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)


def _close_f32(got, want):
    # fp32 sums of the same exact bf16 products in another order
    want = np.asarray(want, dtype=np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# (rows, C, hidden): rows not a multiple of 128, widths multiples of 8 that
# are not multiples of 64
RAGGED = [(150, 40, 72), (33, 24, 96), (257, 136, 200)]


@pytest.mark.parametrize("M,C,hidden", RAGGED)
def test_mlp_half_epilogues_match_pallas_gpt2(M, C, hidden):
    """The serving MLP half's two products (pallas_gpt2.py:149-152):
    gelu_new(yn . W_fc + b_fc) rounded, then y + (h . W_proj + b_proj), on
    the Conv1D (in, out) weights, which both packages keep in that
    layout."""
    rng = np.random.default_rng(M + C)
    yn, y = _bf16(rng, M, C), _bf16(rng, M, C)
    wfc, bfc = _bf16(rng, C, hidden, std=C ** -0.5), _bf16(rng, hidden,
                                                          std=0.1)
    wproj, bproj = _bf16(rng, hidden, C, std=hidden ** -0.5), _bf16(
        rng, C, std=0.1)
    h1 = _dot(yn, wfc) + bfc.astype(jnp.float32)
    h1 = _gelu_new(h1).astype(jnp.bfloat16)
    want = y.astype(jnp.float32) + _dot(h1, wproj) + bproj.astype(
        jnp.float32)
    h, none = G.gemm(_t(yn), _t(wfc), "gelu_tanh", _t(bfc))
    assert none is None
    _close_bf16(h, h1)
    # the second product on JAX's rounded h1, so each check sees one rounding
    out, _ = G.gemm(_t(h1), _t(wproj), "bias_res", _t(bproj), _t(y))
    _close_bf16(out, want.astype(jnp.bfloat16))


@pytest.mark.parametrize("forward", ["serving", "training", "decoder_cross"])
@pytest.mark.parametrize("M,C,hidden", RAGGED)
def test_nk_route_matches_pallas_block(M, C, hidden, forward):
    """The fuser block's four forward products: serving
    (pallas_block.py:141-188), qkv rounded, proj + x into the fp32 residual
    stream y, fc1 under the exact GELU (_gelu_exact) rounded, fc2 + y
    rounded; training (pallas_block_train.py:217-238), proj and fc2 with
    their dropout and drop-path (here both on the proj-site masks the GEMM
    draws), y stashed rounded, fc1 with the pre-activation stashed rounded;
    the CA decoder block's cross stage (pallas_seq_block.py:104-132,
    183-186), w_q, w_k, w_v rounded after their bias, and x2 = x1 + (cross
    . W_cproj + b) in fp32, which the port writes into x1 in place (out is
    res), bit for bit what it writes out of place. On the JAX (in, out)
    weights, which the port reads as their nn.Linear (out, in) transposes,
    the (N, K) operand."""
    rng = np.random.default_rng(M + 3 * C)
    f32 = jnp.float32
    xn, attn, x, yn = (_bf16(rng, M, C) for _ in range(4))
    wqkv = _bf16(rng, C, 3 * C, std=C ** -0.5)
    wproj = _bf16(rng, C, C, std=C ** -0.5)
    wfc1 = _bf16(rng, C, hidden, std=C ** -0.5)
    wfc2 = _bf16(rng, hidden, C, std=hidden ** -0.5)
    bqkv, bproj, bfc1, bfc2 = (_bf16(rng, n, std=0.1)
                               for n in (3 * C, C, hidden, C))
    train = forward == "training"
    tokens, rates = 5, dict(seeds=SEEDS, block_idx=4, drop_rate=0.3,
                            dp_rate=0.2)
    elem, rows = G.drop_masks(M, C, tokens, SEEDS, 4, 0.3, 0.2)
    mproj, dp = jnp.asarray(elem.numpy()), jnp.asarray(rows.numpy())

    def nk(w):
        return _t(np.ascontiguousarray(np.asarray(w).T))
    if forward == "decoder_cross":
        # qn = xn, kn = yn, cross = attn; x1 the fp32 residual stream
        x1 = rng.standard_normal((M, C)).astype(np.float32)
        for a, w, b in ((xn, wqkv[:, :C], bqkv[:C]),
                        (yn, wqkv[:, C:2 * C], bqkv[C:2 * C]),
                        (yn, wqkv[:, 2 * C:], bqkv[2 * C:])):
            got, _ = G.gemm(_t(a), nk(w), "bias", _t(b), w_in_out=False)
            _close_bf16(got, (_dot(a, w) + b.astype(f32)).astype(
                jnp.bfloat16))
        x2 = x1 + (_dot(attn, wproj) + bproj.astype(f32))
        y = _t(x1.copy())
        kw = dict(out_dtype=torch.float32, w_in_out=False)
        apart, _ = G.gemm(_t(attn), nk(wproj), "bias_res", _t(bproj), y,
                          **kw)
        got, _ = G.gemm(_t(attn), nk(wproj), "bias_res", _t(bproj), y,
                        out=y, **kw)
        assert got is y and torch.equal(y, apart)
        _close_f32(y, x2)
        return

    def branch(v):
        return dp * (v * mproj) if train else v
    qkv = (_dot(xn, wqkv) + bqkv.astype(f32)).astype(jnp.bfloat16)
    y = x.astype(f32) + branch(_dot(attn, wproj) + bproj.astype(f32))
    pre1 = _dot(yn, wfc1) + bfc1.astype(f32)
    h1 = _gelu_exact(pre1).astype(jnp.bfloat16)
    out = (y + branch(_dot(h1, wfc2) + bfc2.astype(f32))).astype(
        jnp.bfloat16)

    kw = dict(w_in_out=False, **(dict(tokens=tokens, **rates) if train
                                 else {}))
    got, _ = G.gemm(_t(xn), nk(wqkv), "bias", _t(bqkv), w_in_out=False)
    _close_bf16(got, qkv)
    got, stash = G.gemm(_t(attn), nk(wproj), "res_drop" if train else
                        "bias_res", _t(bproj), _t(x), stash=train,
                        out_dtype=torch.float32, **kw)
    _close_f32(got, y)
    if train:
        _close_bf16(stash, y.astype(jnp.bfloat16))
    got, stash = G.gemm(_t(yn), nk(wfc1), "pre_gelu" if train else
                        "gelu_erf", _t(bfc1), **kw)
    _close_bf16(got, h1)
    if train:
        _close_bf16(stash, pre1.astype(jnp.bfloat16))
    # fc2 on JAX's y and h1, so the check sees one rounding
    got, _ = G.gemm(_t(h1), nk(wfc2), "res_drop" if train else "bias_res",
                    _t(bfc2), _t(np.array(y)), **kw)
    _close_bf16(got, out)


@pytest.mark.parametrize("layer", ["fuser", "gpt2"])
@pytest.mark.parametrize("M,C,hidden", RAGGED)
def test_mlp_backward_products_match_pallas_block_train(M, C, hidden, layer):
    """The MLP backward products, jax.lax.dot_general with the kernels'
    dimension numbers on their (in, out) weights: the fuser's
    (pallas_block_train.py:283-296), where the port reads the nn.Linear
    (out, in) weights, their transposes, as the (K, N) operand, and the
    GPT-2 layer's (pallas_gpt2_train.py:180-183, 206-208: dpre1 under the
    gelu_new derivative, dg in fp32), where the port reads the Conv1D (in,
    out) weights where they lie as the (N, K) operand. Each weight gradient
    comes out in its weight's layout (the fuser's dy^T . x, the GPT-2
    layer's x^T . dy)."""
    rng = np.random.default_rng(M + hidden)
    f32 = jnp.float32
    dims_tn = (((0,), (0,)), ((), ()))
    dims_dx = (((1,), (1,)), ((), ()))
    h1, g_c = _bf16(rng, M, hidden), _bf16(rng, M, C)
    dh2, pre1 = _bf16(rng, M, C), _bf16(rng, M, hidden)
    wfc1 = _bf16(rng, C, hidden, std=C ** -0.5)       # JAX (in, out)
    wfc2 = _bf16(rng, hidden, C, std=hidden ** -0.5)
    gelu_grad = _gelu_grad if layer == "fuser" else _gelu_new_grad

    dw2 = jax.lax.dot_general(h1, dh2, dims_tn, preferred_element_type=f32)
    dh1 = jax.lax.dot_general(dh2, wfc2, dims_dx, preferred_element_type=f32)
    dpre1 = (dh1 * gelu_grad(pre1.astype(f32))).astype(jnp.bfloat16)
    dw1 = jax.lax.dot_general(g_c, dpre1, dims_tn, preferred_element_type=f32)
    dg = jax.lax.dot_general(dpre1, wfc1, dims_dx, preferred_element_type=f32)

    if layer == "gpt2":
        _close_f32(G.gemm_tn(_t(h1), _t(dh2)), dw2)
        got, _ = G.gemm(_t(dh2), _t(wfc2), "gelu_tanh_bwd", res=_t(pre1),
                        w_in_out=False)
        _close_bf16(got, dpre1)
        _close_f32(G.gemm_tn(_t(g_c), _t(dpre1)), dw1)
        got, _ = G.gemm(_t(dpre1), _t(wfc1), "bias",
                        out_dtype=torch.float32, w_in_out=False)
        _close_f32(got, dg)
        return
    _close_f32(G.gemm_tn(_t(dh2), _t(h1)), np.asarray(dw2).T)   # fuser
    _close_f32(G.gemm_tn(_t(h1), _t(dh2)), dw2)                 # GPT-2
    w2_port = _t(np.ascontiguousarray(np.asarray(wfc2).T))    # (C, hidden)
    got, _ = G.gemm(_t(dh2), w2_port, "gelu_bwd", res=_t(pre1))
    _close_bf16(got, dpre1)
    _close_f32(G.gemm_tn(_t(dpre1), _t(g_c)), np.asarray(dw1).T)
    w1_port = _t(np.ascontiguousarray(np.asarray(wfc1).T))    # (hidden, C)
    got, _ = G.gemm(_t(dpre1), w1_port, "bias", out_dtype=torch.float32)
    _close_f32(got, dg)


def test_cpu_tensors_take_the_plain_versions():
    a, w, b, _ = _operands(24, 16, 40, seed=3)
    before = dict(G.LAUNCHES)
    out, _ = G.gemm(a, w, "bias", b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, G.gemm_plain(a, w, "bias", b,
                                         out_dtype=torch.float32)[0])
    assert torch.equal(G.gemm_tn(a, a[:, :8]),
                       G.gemm_tn_plain(a, a[:, :8]))
    assert G.LAUNCHES == before


def test_cpu_tensors_take_the_plain_versions_on_the_nk_route():
    a, w, b, r = _operands(24, 16, 40, seed=4)
    w_nk = w.t().contiguous()
    before = dict(G.LAUNCHES)
    for epi, res, out_dtype in (("gelu_erf", None, None),
                                ("bias_res", r, torch.float32),
                                ("bias_res", r.float(), None),
                                ("bias_res", r.float(), torch.float32),
                                ("bias", None, torch.float32),
                                ("pre_gelu", None, None),
                                ("gelu_tanh_bwd", r, None),
                                ("res_drop", r, torch.float32),
                                ("res_drop", r.float(), None)):
        got, _ = G.gemm(a, w_nk, epi, b, res, out_dtype=out_dtype,
                        w_in_out=False)
        # gemm's default rates keep every element: masks of ones
        masks = G.drop_masks(24, 16, 1, (0, 0), 0, 0.0, 0.0) \
            if epi == "res_drop" else None
        want, _ = G.gemm_plain(a, w_nk, epi, b, res, masks,
                               out_dtype=out_dtype, w_in_out=False)
        assert got.dtype == (out_dtype or torch.bfloat16)
        assert torch.equal(got, want)
    assert G.LAUNCHES == before


def test_nk_route_refuses_what_the_kernel_does_not_take():
    """Each weight layout takes its own epilogues; the fp32 output and the
    fp32 residual only where the fuser block, the decoder block's cross
    proj and the GPT-2 layer's backward use them; ``out`` only of the
    output's shape and dtype."""
    a, w, b, r = _operands(4, 16, 8, seed=2)
    w_nk = w.t().contiguous()
    for epi in ("gelu_tanh", "pre_gelu_tanh", "gelu_bwd"):
        with pytest.raises(ValueError, match=r"w \(N, K\) route"):
            G.gemm(a, w_nk, epi, b, r, w_in_out=False)
    for epi in ("gelu_erf", "pre_gelu", "gelu_tanh_bwd"):
        with pytest.raises(ValueError, match=r"w \(K, N\) route"):
            G.gemm(a, w, epi, b, r)
    for epi in ("gelu_erf", "pre_gelu", "gelu_tanh_bwd"):
        with pytest.raises(ValueError, match="fp32 output"):
            G.gemm(a, w_nk, epi, b, r, out_dtype=torch.float32,
                   w_in_out=False)
    with pytest.raises(ValueError, match="fp32 output"):
        G.gemm(a, w, "bias_res", b, r, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="fp32 output"):
        G.gemm(a, w, "res_drop", b, r, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="fp32 residual"):
        G.gemm(a, w, "bias_res", b, r.float())
    with pytest.raises(ValueError, match="fp32 residual"):
        G.gemm(a, w_nk, "res_drop", b, r.float(), out_dtype=torch.float32,
               w_in_out=False)
    for out in (r, torch.zeros(4, 8)):
        with pytest.raises(ValueError, match="out"):
            G.gemm(a, w_nk, "bias_res", b, r.float(),
                   out_dtype=torch.float32, w_in_out=False, out=out)
    with pytest.raises(ValueError, match="fp32 residual"):
        G.gemm(a, w_nk, "gelu_tanh_bwd", b, r.float(), w_in_out=False)
    with pytest.raises(ValueError, match="res_drop on the w"):
        G.gemm(a, w_nk, "res_drop", b, r, w_in_out=False)
    with pytest.raises(ValueError, match=r"w \(N, K\), got"):
        G.gemm(a, w, "bias", b, w_in_out=False)
    # K 4, off the 16-byte grid: taken (the kernel packs the operands)
    a4, w4 = a[:, :4].contiguous(), w_nk[:, :4].contiguous()
    got, _ = G.gemm(a4, w4, "bias", b, w_in_out=False)
    np.testing.assert_allclose(
        got.float().numpy(), _jax_epilogue("bias", a4, w4.t(), b, r, None),
        rtol=2 ** -7, atol=1e-6)
    # the fp32 residual on CUDA: float32, contiguous and 16-byte aligned
    r32 = r.float()
    with pytest.raises(TypeError, match="expected torch.float32"):
        G.check_kernel_operands("gemm", a, {"w": w_nk}, fp32={"res": r})
    shifted = torch.zeros(4 * 16 + 1)[1:].view(4, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.check_kernel_operands("gemm", a, {"w": w_nk}, fp32={"res": shifted})
    with pytest.raises(ValueError, match="contiguous"):
        G.check_kernel_operands("gemm", a, {"w": w_nk},
                                fp32={"res": r32.t()})
    G.check_kernel_operands("gemm", a, {"w": w_nk}, fp32={"res": r32})


def test_gemm_refuses_what_the_kernel_does_not_take():
    a, w, b, r = _operands(4, 16, 8, seed=0)
    with pytest.raises(ValueError, match="unknown"):
        G.gemm(a, w, "gelu")
    with pytest.raises(ValueError, match="needs res"):
        G.gemm(a, w, "bias_res", b)
    with pytest.raises(ValueError, match="needs res"):
        G.gemm(a, w, "gelu_bwd")
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        G.gemm(a, w.t(), "bias", b)
    with pytest.raises(ValueError, match="bias has shape"):
        G.gemm(a, w, "bias", b[:8])
    with pytest.raises(ValueError, match="fp32 output"):
        G.gemm(a, w, "gelu_tanh", b, out_dtype=torch.float32)


@pytest.mark.parametrize("M,N,K", [(4, 16, 12), (4, 12, 8), (4, 4, 8)])
def test_gemm_refuses_widths_off_the_16_byte_grid(M, N, K):
    """Widths off the 16-byte grid (K or N not a multiple of 8), which the
    wrapper refused while the kernel took only those on it, are taken on
    both weight layouts (the kernel packs such an operand first, and its
    epilogue goes element by element) and computed as JAX computes them;
    only widths below 1 are refused."""
    a, w, b, r = _operands(M, N, K, seed=1)
    for w_in_out in (True, False):
        got, _ = G.gemm(a, w if w_in_out else w.t().contiguous(), "bias", b,
                        w_in_out=w_in_out)
        np.testing.assert_allclose(got.float().numpy(),
                                   _jax_epilogue("bias", a, w, b, r, None),
                                   rtol=2 ** -7, atol=1e-6)
    with pytest.raises(ValueError, match="M, N, K and tokens >= 1"):
        G.gemm(a[:, :0], w[:0], "bias", b)


@pytest.mark.parametrize("M,I,J", [(4, 12, 16), (4, 16, 20), (0, 16, 16)])
def test_gemm_tn_refuses_what_the_kernel_does_not_take(M, I, J):
    """I and J off the 16-byte grid are taken (the kernel packs A and B)
    and give JAX's product; M = 0 and mismatched rows are refused."""
    rng = np.random.default_rng(M + I + J)
    a, b = (torch.from_numpy(rng.standard_normal((M, n)).astype(
        np.float32)).bfloat16() for n in (I, J))
    if M == 0:
        with pytest.raises(ValueError, match="M, I and J >= 1"):
            G.gemm_tn(a, b)
    else:
        want = jnp.dot(jnp.asarray(a.float().numpy()).T,
                       jnp.asarray(b.float().numpy()),
                       precision=jax.lax.Precision.HIGHEST)
        np.testing.assert_allclose(G.gemm_tn(a, b).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match=r"\(M, I\)"):
        G.gemm_tn(a, torch.zeros(M + 1, J).bfloat16())


def test_kernel_operand_checks_refuse_fp32_and_misaligned_operands():
    """What the CUDA path checks before it launches: bf16 operands (fp32
    stays on gemm_f32 / gemm_tn_f32 inside the entries), 16-byte aligned
    (TMA and the epilogue's vectors), contiguous, of one dtype."""
    a = torch.zeros(8, 16).bfloat16()
    with pytest.raises(TypeError, match="bfloat16 only"):
        G.check_kernel_operands("gemm", a.float(), {"w": a.float()})
    shifted = torch.zeros(8 * 16 + 1).bfloat16()[1:].view(8, 16)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.check_kernel_operands("gemm", a, {"w": shifted})
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.check_kernel_operands("gemm_tn", shifted, {"b": a})
    with pytest.raises(ValueError, match="contiguous"):
        G.check_kernel_operands("gemm", a, {"w": a.t()})
    with pytest.raises(TypeError, match="b is torch.float32"):
        G.check_kernel_operands("gemm_tn", a, {"b": a.float()})
    G.check_kernel_operands("gemm", a, {"w": a, "bias": None})
