"""The port's ``-m visualize_attention`` against visualize_attention.py.

Mirrors tests/test_visualize.py: on tests/fixtures/synth with expt 99, the
JAX entry point's ``main()`` runs on a JAX checkpoint of seeded weights and
the port's ``python -m afft_tpu_torch.run -m visualize_attention --device
cpu`` on a port checkpoint of the same weights
(``weights.state_dict_from_jax``); the dumps hold the same keys and uids,
every array within 2e-5 (fp32; the summation order differs), softmax rows
that sum to 1, and the heatmap is written where matplotlib imports. Also
``BaseModel(fuser_need_weights=True)``'s attention outputs against the JAX
model's (afft_tpu/models/cmfp.py:175-215) for the fusers that give
weights, and the entry point's refusal without a checkpoint.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu_torch import run as RUN
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models.base_model import BaseModel
from afft_tpu_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "tests", "fixtures", "synth")
SMOKE_VAL = os.path.join(REPO, "expts", "99_synth_smoke_val.txt")
JAX_CONF = os.path.join(REPO, "afft_tpu", "conf")
ATOL, RTOL = 2e-5, 0.0


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both entry points on the same weights: (JAX dump dir, port dump
    dir)."""
    if not os.path.exists(os.path.join(SYNTH, "annotations")):
        pytest.skip("synthetic dataset missing; run tools/synthetic.py")
    sys.path.insert(0, REPO)
    import visualize_attention
    from afft_tpu.data.loader import get_dataset
    from afft_tpu.train.checkpoint import save_checkpoint as jax_save
    from afft_tpu.train.loop import DATASET_EVAL_CFG_KEY, get_transforms

    tmp = tmp_path_factory.mktemp("attn")
    overrides = read_expt_file(SMOKE_VAL)
    cfg = jax_compose(JAX_CONF, overrides)
    ds = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                     get_transforms(cfg, train=False), None)
    num_classes = {k: len(v) for k, v in ds.classes.items()}
    model = JaxBaseModel(cfg.model, num_classes=num_classes,
                         class_mappings=ds.class_mappings)
    params = model.init(jax.random.key(42))
    jax_save(tmp / "jax_ckpt", params, {"none": np.zeros(1)}, epoch=0,
             step=0, best_metric=0.0)
    with torch.device("cpu"):
        port_model = BaseModel(
            compose(CONF_DIR, overrides).model, num_classes=num_classes,
            class_mappings=ds.class_mappings)
    sd = W.state_dict_from_jax(port_model, jax.tree.map(np.asarray, params))
    port_model.load_state_dict(sd, strict=True)
    save_checkpoint(tmp / "port_ckpt", port_model.state_dict(), {}, epoch=0,
                    step=0, best_metric=0.0)

    common = ["+attn_max_batches=2", "eval.batch_size=8"]
    old_argv = sys.argv
    sys.argv = ["visualize_attention.py"] + overrides + common + [
        f"init_from_model={tmp / 'jax_ckpt'}",
        f"+attn_out_dir={tmp / 'jax_maps'}"]
    try:
        visualize_attention.main()
    finally:
        sys.argv = old_argv
    rc = RUN.main(["-c", SMOKE_VAL, "-m", "visualize_attention",
                   "--device", "cpu", *common,
                   f"init_from_model={tmp / 'port_ckpt'}",
                   f"+attn_out_dir={tmp / 'port_maps'}"])
    assert rc is not None  # the mean modality-token attention
    return tmp / "jax_maps", tmp / "port_maps"


@pytest.mark.parametrize("batch", [0, 1])
def test_dumps_equal_the_jax_entry_points(dumps, batch):
    jax_dir, port_dir = dumps
    name = f"batch_{batch:04d}.npz"
    want = np.load(jax_dir / name, allow_pickle=False)
    got = np.load(port_dir / name, allow_pickle=False)
    assert sorted(got.files) == sorted(want.files)
    assert got["uids"].dtype.kind == "U"
    np.testing.assert_array_equal(got["uids"], want["uids"])
    for key in want.files:
        if key == "uids":
            continue
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    ma = got["all-fused/modality_attns"]
    # (B, depth, T, H, n+1, n+1): 2 modalities + the token
    assert ma.ndim == 6 and ma.shape[-2:] == (3, 3)
    np.testing.assert_allclose(ma.sum(axis=-1), 1.0, atol=1e-3)
    assert any(k.startswith("all-fused/temporal_attns/gpt2_att_")
               for k in got.files)


def test_heatmap_is_written(dumps):
    pytest.importorskip("matplotlib")
    png = dumps[1] / "modality_attention.png"
    assert png.exists() and png.stat().st_size > 0


def test_refuses_to_run_without_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="init_from_model"):
        RUN.main(["-c", SMOKE_VAL, "-m", "visualize_attention", "--device",
                  "cpu", "init_from_model=null",
                  f"+attn_out_dir={tmp_path}"])


@pytest.mark.parametrize("fuser", ["SA-Fuser", "SA-Fuser_wo_token"])
def test_fuser_need_weights_equals_jax(fuser):
    """The early-fusion CMFP with ``fuser_need_weights`` returns the
    fuser's weights, (B, depth, T, H, n, n), as the JAX model does; without
    it, None (and the same logits)."""
    lines = ["model.modal_dims={rgb: 16, flow: 16}", "model.common_dim=16",
             f"model/fuser={fuser}", "model.fuser.depth=2",
             "model.fuser.num_heads=2", "model.common.fp_inter_dim=16",
             "model.common.fp_layers=1", "model.common.fp_heads=2",
             "model.dropout=0.0"]
    num_classes = {"action": 11}
    jax_model = JaxBaseModel(jax_compose(JAX_CONF, lines).model, num_classes,
                             fuser_need_weights=True)
    params = jax_model.init(jax.random.key(3))
    rng = np.random.default_rng(0)
    feats = {m: rng.standard_normal((3, 5, 16)).astype(np.float32)
             for m in ("rgb", "flow")}
    want, _ = jax_model.apply(params, feats, train=False)
    sds = {}
    for need in (True, False):
        model = BaseModel(compose(CONF_DIR, lines).model, num_classes,
                          fuser_need_weights=need).eval()
        sds[need] = W.state_dict_from_jax(model,
                                          jax.tree.map(np.asarray, params))
        model.load_state_dict(sds[need], strict=True)
        with torch.no_grad():
            out = model({m: torch.from_numpy(x) for m, x in feats.items()})
        attn = out["attentions"]["all-fused"]["modality_attns"]
        logits = out["logits/action"]["all-fused"].numpy()
        np.testing.assert_allclose(
            logits, np.asarray(want["logits/action"]["all-fused"]),
            atol=ATOL, rtol=1e-5)
        if not need:
            assert attn is None
            continue
        ref = np.asarray(want["attentions"]["all-fused"]["modality_attns"])
        assert tuple(attn.shape) == ref.shape
        np.testing.assert_allclose(attn.numpy(), ref, atol=ATOL, rtol=1e-5)
