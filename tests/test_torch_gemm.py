"""ops.gemm on the CPU: the plain version of the GEMM that the GPT-2
entries run on the card (csrc/gemm_sm90.cuh), for each of its four
epilogues, against the same arithmetic in JAX on the same numpy-made
operands; its dropout masks are the training forward's proj-site masks.
The kernels themselves run on the card only (chip_smoke.py's gemm phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    if epi == "pre_gelu_tanh":
        v = jax.nn.gelu(v, approximate=True)
    elif epi == "res_drop":
        v = f32[3] + (v * jnp.asarray(masks[0].numpy())) * jnp.asarray(
            masks[1].numpy())
    elif epi == "bias_res":
        v = f32[3] + v
    return np.asarray(v.astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("M,N,K", [(1, 72, 24), (15, 136, 40),
                                   (33, 64, 96)])
@pytest.mark.parametrize("epi", list(G.EPILOGUES))
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


def test_res_drop_masks_are_the_training_forwards_proj_masks():
    """The GEMM draws at the proj site (1) and the first drop-path site (2)
    of the training block: its masks equal draw_masks_plain's, and the
    elements it drops are exactly the zeros of their product."""
    R, N_TOK, C, H = 6, 4, 16, 2
    M = R * N_TOK
    masks = FT.draw_masks_plain(R, N_TOK, C, H, SEEDS, 3, 0.0, 0.3, 0.5)
    elem, rows = G.drop_masks(M, C, N_TOK, SEEDS, 3, 0.3, 0.5)
    assert torch.equal(elem, masks[1])
    assert torch.equal(rows[:, 0], masks[2].repeat_interleave(N_TOK))
    a, w, b, _ = _operands(M, C, 24, seed=5)
    # a zero residual and the bias shifted by 64: no kept element is 0
    out, _ = G.gemm(a, w, "res_drop", (b.float() + 64).bfloat16(),
                    torch.zeros(M, C).bfloat16(),
                    seeds=SEEDS, block_idx=3, drop_rate=0.3, dp_rate=0.5,
                    tokens=N_TOK)
    assert torch.equal(out == 0, (elem * rows) == 0)
    assert 0 < int((out == 0).sum()) < out.numel()


def test_gemm_refuses_what_the_kernel_does_not_take():
    a, w, b, r = _operands(4, 16, 8, seed=0)
    with pytest.raises(ValueError, match="unknown"):
        G.gemm(a, w, "gelu")
    with pytest.raises(ValueError, match="needs res"):
        G.gemm(a, w, "bias_res", b)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        G.gemm(a, w.t(), "bias", b)
    with pytest.raises(ValueError, match="bias has shape"):
        G.gemm(a, w, "bias", b[:8])
