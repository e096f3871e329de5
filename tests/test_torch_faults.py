"""Repairs of the port's faults against the reference, on the CPU.

- The kernels' shape rule (``ops._common.check_heads``): H * hd == C with any
  head width hd >= 1 and any C and MLP width (the GEMM packs an operand off
  its 16-byte grid), as every wrapper of a fused block applies it before a
  CUDA launch. The synthetic smoke expt (C 24, 2 heads of 12) passes it, and one step through ``Runner`` (on the CPU the plain
  versions run, and no kernel is launched) equals the JAX runner's.
- ``Runner.from_config`` refuses the train.* keys that the JAX loop reads and
  the port does not honour yet, naming the roadmap; ``class_weight_beta``
  and ``watch_gradients`` are honoured, each held against the JAX runner.
- Host batches reach the runner's device through pinned, non-blocking
  copies with their contents unchanged.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train import optim as JO
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import serve
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import read_expt_file
from afft_tpu_torch.ops import (fused_block, fused_gpt2, fused_gpt2_train,
                                fused_seq_block, launch_counts,
                                reset_launches)
from afft_tpu_torch.ops._common import check_heads
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
CLASSES = {"action": 7, "verb": 3, "noun": 5}
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]

# each wrapper that applies the rule, and whether it has an MLP width
WRAPPERS = {"fused_block": True, "gpt2_attn_half": False,
            "fused_gpt2_train": True, "fused_decoder_block": True}


@pytest.mark.parametrize("C,H,hidden", [(24, 2, 96), (24, 4, 96),
                                        (32, 2, 128), (2048, 4, 8192)])
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_shape_rule_takes_any_head_width(wrapper, C, H, hidden):
    got = check_heads(wrapper, C, H)
    assert got == C // H


@pytest.mark.parametrize("C,H", [(24, 5), (24, 0), (20, 2), (12, 2)])
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_shape_rule_rejects_heads_that_do_not_divide_c_or_c_off_8(wrapper, C,
                                                                  H):
    """Heads that do not divide C are refused; a C off the 8-column grid
    (20 and 12, refused while the GEMM needed it) is taken."""
    if H > 0 and C % H == 0:
        assert check_heads(wrapper, C, H) == C // H
    else:
        with pytest.raises(ValueError, match=wrapper):
            check_heads(wrapper, C, H)


@pytest.mark.parametrize("wrapper",
                         [w for w, hidden in WRAPPERS.items() if hidden])
def test_shape_rule_rejects_an_mlp_width_off_8(wrapper):
    """An MLP width off the 8-column grid (hidden 100), refused while the
    GEMM needed it, no longer enters the rule; the layers of such a width
    run through the wrappers (here the plain versions, as on the CPU)."""
    assert check_heads(wrapper, 24, 2) == 12
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 4, 24)).astype(np.float32))
    params = _block_params(24, 100)
    out = fused_block.fused_block(x, params, num_heads=2)
    want = fused_block.fused_block_plain(x, params, num_heads=2)
    assert out.shape == (3, 4, 24) and torch.equal(out, want)


@pytest.mark.parametrize("fn", [fused_block.block_operands,
                                fused_gpt2.gpt2_attn_half,
                                fused_gpt2_train.gpt2_operands,
                                fused_seq_block.fused_decoder_block])
def test_wrappers_apply_the_shared_rule(fn):
    src = inspect.getsource(fn)
    assert "check_heads(" in src and "hd % 8" not in src


def _block_params(C, hidden):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return {"norm1.weight": t(C), "norm1.bias": t(C),
            "attn.qkv.weight": t(3 * C, C), "attn.proj.weight": t(C, C),
            "attn.proj.bias": t(C), "norm2.weight": t(C), "norm2.bias": t(C),
            "mlp.mlp.0.weight": t(hidden, C), "mlp.mlp.0.bias": t(hidden),
            "mlp.mlp.2.weight": t(C, hidden), "mlp.mlp.2.bias": t(C)}


@pytest.mark.parametrize("H", [2, 4])
def test_block_operands_take_the_smoke_expts_heads(H):
    """C 24 with 2 heads of 12 (expt 99) or 4 of 6: the operand check that
    fused_block, fused_block_train and fused_seq_block run before a launch
    passes; 5 heads do not divide C."""
    x = torch.zeros(3, 5, 24)
    params = _block_params(24, 96)
    tensors, hidden = fused_block.block_operands("fused_block", x, params, H)
    assert hidden == 96 and len(tensors) == 12
    with pytest.raises(ValueError, match="H\\*hd == C"):
        fused_block.block_operands("fused_block", x, params, 5)


def test_gpt2_operands_take_the_smoke_expts_heads():
    rng = np.random.default_rng(1)
    C, hidden = 32, 128
    shapes = ((C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,),
              (C, hidden), (hidden,), (hidden, C), (C,))
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in zip(fused_gpt2_train.KEYS, shapes)}
    x = torch.zeros(2, 10, C)
    for H in (2, 4):                      # hd 16, 8; C 24 gives hd 12 / 6
        tensors, got = fused_gpt2_train.gpt2_operands("fused_gpt2_train", x,
                                                      params, H)
        assert got == hidden and len(tensors) == 12
    with pytest.raises(ValueError, match="H\\*hd == C"):
        fused_gpt2_train.gpt2_operands("fused_gpt2_train", x, params, 3)


def _smoke_batch(cfg, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    dims = cfg.model.modal_dims.to_container()
    sub = {t: rng.integers(0, c, (batch, T, 1)) for t, c in CLASSES.items()}
    sub["action"][1, :3] = -1              # one row with ignored frames
    return {"data_dict": {m: rng.standard_normal((batch, T, int(d)))
                          .astype(np.float32) for m, d in dims.items()},
            "target": {t: rng.integers(0, c, (batch,))
                       for t, c in CLASSES.items()},
            "target_subclips": sub, "valid": np.ones((batch,), bool),
            "mixup_lam": np.float32(0.35)}


def test_smoke_expt_trains_one_step_on_the_plain_path():
    """expts/99_synth_smoke_train.txt (fuser C 24, 2 heads of 12; GPT-2 C 32)
    builds through Runner.from_config and takes one step on the CPU that
    equals the JAX runner's from the same weights (carried by
    ``weights.state_dict_from_jax``), batch and mixup lambda, every dropout
    rate 0 (the two packages draw different masks): every loss component
    (rtol 1e-5, atol 1e-6) and the weights after the step (rtol 1e-4, atol
    2e-5), the tolerances of test_torch_train_slice's five steps. On the CPU
    the plain versions run and no kernel is launched."""
    cfg = serve.load_config(SMOKE_TRAIN, NO_DROPOUT)
    assert int(cfg.model.common_dim) == 24
    assert int(cfg.model.fuser.num_heads) == 2
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                       read_expt_file(SMOKE_TRAIN) + NO_DROPOUT)
    batch, lr = _smoke_batch(cfg), float(cfg.opt.lr)

    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    params = jmodel.init(jax.random.key(3))
    params0 = jax.tree.map(np.asarray, params)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    jrunner = JaxRunner(
        jmodel, joptimizer, groups,
        loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False)
    params, _, want, _, _ = jrunner.train_step(
        params, joptimizer.init(params, groups),
        {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])}, lr, lr,
        jax.random.key(0))

    runner = Runner.from_config(cfg, CLASSES, device="cpu",
                                iters_per_epoch=1)
    runner.model.load_state_dict(
        W.state_dict_from_jax(runner.model, params0), strict=True)
    assert runner.mixup is not None
    reset_launches()
    got, _ = runner.train_step(batch, lr, lr, check_nan=True)
    assert not any(launch_counts().values())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want_sd = W.state_dict_from_jax(runner.model,
                                    jax.tree.map(np.asarray, params))
    first_sd = W.state_dict_from_jax(runner.model, params0)
    got_sd = runner.model.state_dict()
    assert set(got_sd) == set(want_sd)
    moved = 0
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        moved += not np.allclose(w.numpy(), first_sd[k].numpy(), atol=1e-6)
    assert moved > len(want_sd) // 2       # the step did move the weights


PER_LAYER_RULE = ("opt.lr_wd=[[future_predictor.future_predictor.gpt_model"
                  ".h.1,0.0,0.0]] train.pipeline_stages=2")


@pytest.mark.parametrize("override", [
    "train.pipeline_stages=2", "train.pipeline_stages=4",
    "train.master_dtype=bfloat16", "train.grad_accum=0", PER_LAYER_RULE])
def test_unported_train_keys_raise_naming_the_roadmap(override):
    """The train.* values the JAX loop refuses raise alike: two pipeline
    stages in one process (the stages must divide the process count), four
    stages over the smoke expt's 2 predictor layers (checked from the
    config, before the process count), a per-layer opt.lr_wd rule under
    pipelining (JAX's message), bf16 masters without bf16 compute and a
    grad_accum below 1."""
    cfg = serve.load_config(SMOKE_TRAIN, override.split())
    if override == "train.pipeline_stages=2":
        with pytest.raises(ValueError, match="must divide the process "
                           "count 1"):
            Runner.from_config(cfg, CLASSES, device="cpu")
    elif override == "train.pipeline_stages=4":
        with pytest.raises(ValueError, match=r"fp_layers=2 must divide "
                           r"over pipeline_stages=4"):
            Runner.from_config(cfg, CLASSES, device="cpu")
    elif override == PER_LAYER_RULE:
        with pytest.raises(ValueError, match=r"opt\.lr_wd assigns different "
                           r"lr/wd groups to individual predictor layers "
                           r"\(future_predictor\.future_predictor\.gpt_model"
                           r"\.h\.1\)"):
            Runner.from_config(cfg, CLASSES, device="cpu")
    elif override.startswith("train.master_dtype"):
        with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
            Runner.from_config(cfg, CLASSES, device="cpu")
    else:
        with pytest.raises(ValueError, match="grad_accum"):
            Runner.from_config(cfg, CLASSES, device="cpu")


@pytest.mark.parametrize("override", [
    "train.class_weight_beta=null", "train.watch_gradients=false",
    "train.zero_sharding=false", "train.pipeline_stages=1",
    "train.grad_accum=2", "train.zero_sharding=true"])
def test_train_keys_at_their_defaults_build(override):
    """The defaults, one pipeline stage (the JAX loop pipelines only
    above 1), gradient accumulation and ZeRO-1 (one process: its own
    slice is everything) are what the port runs."""
    cfg = serve.load_config(SMOKE_TRAIN, [override])
    assert Runner.from_config(cfg, CLASSES, device="cpu") is not None


def _jax_runner(jcfg, params, **kw):
    model = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    optimizer = jax_instantiate(jcfg.opt.optimizer)
    runner = JaxRunner(
        model, optimizer, groups, loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False, **kw)
    return runner, optimizer.init(params, groups)


def _jax_smoke(overrides=()):
    cfg = serve.load_config(SMOKE_TRAIN, NO_DROPOUT + list(overrides))
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                       read_expt_file(SMOKE_TRAIN) + NO_DROPOUT
                       + list(overrides))
    params = JaxBaseModel(jcfg.model, num_classes=CLASSES).init(
        jax.random.key(3))
    return cfg, jcfg, params


def test_runner_class_weights_train_only():
    """train.class_weight_beta: the class weights weigh the training loss
    and not the eval loss, as in the JAX runner (tests/test_train.py
    test_runner_class_weights_train_only): one step's losses with weights,
    and eval losses with and without them, against the JAX runner's from
    the same weights, batch and mixup lambda."""
    cfg, jcfg, params = _jax_smoke(["train.class_weight_beta=0.999"])
    with pytest.raises(ValueError, match="class weights"):
        Runner.from_config(cfg, CLASSES, device="cpu")
    rng = np.random.default_rng(5)
    weights = {t: rng.uniform(0.2, 3.0, c).astype(np.float32)
               for t, c in CLASSES.items()}
    batch = _smoke_batch(cfg)
    sd = W.state_dict_from_jax(
        Runner.from_config(cfg, CLASSES, device="cpu",
                           class_weights=weights).model,
        jax.tree.map(np.asarray, params))
    got = {}
    for name, cw in (("weighted", weights), ("plain", None)):
        jrunner, opt_state = _jax_runner(jcfg, params, class_weights=cw)
        _, _, want, _, _ = jrunner.train_step(
            params, opt_state,
            {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])},
            0.0, float(cfg.opt.lr), jax.random.key(0))
        want_eval = jrunner.eval_step(params, batch)[0]
        runner = Runner.from_config(
            cfg if cw else serve.load_config(SMOKE_TRAIN, NO_DROPOUT),
            CLASSES, device="cpu", class_weights=cw, weights=sd)
        train_losses, _ = runner.train_step(batch, 0.0, float(cfg.opt.lr))
        eval_losses = runner.eval_step(batch)[0]
        for k, v in want.items():
            np.testing.assert_allclose(float(train_losses[k]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for k, v in want_eval.items():
            np.testing.assert_allclose(float(eval_losses[k]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        got[name] = (train_losses, eval_losses)
    key = "cls_action_all-fused"
    assert abs(float(got["weighted"][0][key])
               - float(got["plain"][0][key])) > 1e-4
    assert float(got["weighted"][1][key]) == float(got["plain"][1][key])


def test_watch_gradients_metrics():
    """train.watch_gradients: the global gradient norm (before clipping),
    the parameter norm and the norm per top-level module join the metrics,
    equal to the JAX runner's (tests/test_train.py
    test_watch_gradients_metrics) from the same weights and batch."""
    cfg, jcfg, params = _jax_smoke(["train.watch_gradients=true"])
    batch = _smoke_batch(cfg)
    jrunner, opt_state = _jax_runner(jcfg, params, watch_gradients=True)
    _, _, _, want, _ = jrunner.train_step(
        params, opt_state,
        {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])},
        float(cfg.opt.lr), float(cfg.opt.lr), jax.random.key(0))
    runner = Runner.from_config(cfg, CLASSES, device="cpu")
    assert runner.watch_gradients
    runner.model.load_state_dict(
        W.state_dict_from_jax(runner.model, jax.tree.map(np.asarray,
                                                         params)))
    _, got = runner.train_step(batch, float(cfg.opt.lr), float(cfg.opt.lr))
    norms = [k for k in want if k.startswith(("grad_norm", "param_norm"))]
    assert {"grad_norm", "param_norm",
            "grad_norm_future_predictor"} <= set(norms)
    for k in norms:
        assert float(got[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_host_batches_reach_the_device_unchanged():
    """Runner._to_device (pinned, non-blocking copies on a card): the
    contents, shapes and dtypes of a host batch are unchanged on the
    runner's device, and ``valid`` defaults to all rows."""
    cfg = serve.load_config(SMOKE_TRAIN)
    runner = Runner.from_config(cfg, CLASSES, device="cpu")
    batch = _smoke_batch(cfg)
    moved = runner._to_device(batch)
    for m, v in batch["data_dict"].items():
        assert moved["data_dict"][m].dtype == torch.float32
        np.testing.assert_array_equal(moved["data_dict"][m].numpy(), v)
    for key in ("target", "target_subclips"):
        for t, v in batch[key].items():
            assert moved[key][t].dtype == torch.long
            np.testing.assert_array_equal(moved[key][t].numpy(), v)
    np.testing.assert_array_equal(moved["valid"].numpy(), batch["valid"])
    del batch["valid"]
    assert runner._to_device(batch)["valid"].all()
