"""The port's flagship training check (afft_tpu_torch/tools/train_check.py)
against tools/tpu_train_check.py, on the CPU, narrow and shallow: the
flagship's lines with four modalities of 24 / 16 / 24 / 24 features, the
fuser at C 32 (2 heads) and 2 blocks, a 2-layer GPT-2 of width 32 (2
heads), 106 actions, 10 frames.

- The tool's first step equals the JAX ``Runner`` built as
  tools/tpu_train_check.py:61-85 builds it (one parameter group, SGD with
  Nesterov momentum, mixup α 0.1 with label smoothing 0.4 on ``action`` and
  on the backbone, loss weights 1 / 1 / 1), from the same weights (the JAX
  init carried across through ``afft_tpu.train.torch_export``) on the same
  numpy batch, with the randomness pinned: every dropout rate 0 and the
  mixup λ given. In fp32 compute (bf16 rounds differently in the two
  packages): the losses within 1e-5 relative, then every updated weight
  within 1e-5, and its update within 1e-5 of the step's largest.
- Thirty steps lower the loss at fp32 and at bf16 masters (bf16 compute),
  and at ``--grad-accum 2`` (``main``, which writes the record).
- ``--against`` adds ``trace_delta``, the JAX artifact's comparison of two
  loss traces (TRAIN_LONG_r05.json), computed here from two JSON files and
  checked against that artifact's own numbers.
- The record carries every key of the JAX tool's.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train import optim as JO
from afft_tpu.train import torch_export as TE
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch.tools import train_check as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["model.modal_dims={rgb:24, objects:16, audio:24, flow:24}",
          "model.common_dim=32", "model.fuser.depth=2",
          "model.fuser.num_heads=2", "model.common.fp_layers=2",
          "model.common.fp_inter_dim=32", "model.common.fp_heads=2"]
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
CLASSES, FRAMES, BATCH, STEPS = 106, 10, 8, 30
LAM = 0.7
TOL = 1e-5


def _narrow(**kw):
    return dict(n_classes=CLASSES, frames=FRAMES, batch=BATCH,
                device="cpu", **kw)


def _jax_runner(overrides, compute_dtype=jnp.float32):
    """tools/tpu_train_check.py:53-85 with ``overrides`` after its lines:
    (config, model, params, runner, optimizer state)."""
    cfg = jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                      list(TC.FLAGSHIP) + list(overrides))
    num_classes = {"action": CLASSES}
    model = JaxBaseModel(cfg.model, num_classes=num_classes)
    params = model.init(jax.random.key(0))
    groups = JO.build_group_tree(params, None, cfg.opt.lr, cfg.opt.wd)
    optimizer = JO.sgd(momentum=0.9, nesterov=True, state_dtype=None)
    opt_state = optimizer.init(params, groups)
    mixup = JaxMixUp(alpha=0.1, label_smoothing={"action": 0.4},
                     num_classes=num_classes)
    runner = JaxRunner(model, optimizer, groups,
                       loss_wts={"cls_action": 1.0, "past_cls_action": 1.0,
                                 "past_reg": 1.0},
                       mixup=mixup, mixup_backbone=True,
                       compute_dtype=compute_dtype, master_dtype=jnp.float32,
                       grad_accum=1, donate=False)
    return cfg, model, params, runner, opt_state


def test_first_step_equals_the_jax_tools_runner():
    overrides = NARROW + NO_DROPOUT
    _, jmodel, params, jrunner, opt_state = _jax_runner(overrides)
    weights = {k: torch.from_numpy(np.array(v)) for k, v in
               TE.export_base_model(jmodel, params).items()}
    got, runner = TC.run(overrides, steps=1, distinct_batches=1,
                         compute_dtype="float32", weights=weights,
                         mixup_lam=LAM, keep_runner=True, **_narrow())
    batch = TC.make_batches(TC.flagship_config(overrides), BATCH, 1, CLASSES,
                            FRAMES)[0]
    jbatch = {**jax.tree.map(jnp.asarray, batch),
              "mixup_lam": jnp.asarray(LAM, jnp.float32)}
    params, _, want, _, _ = jrunner.train_step(
        params, opt_state, jbatch, lr=TC.LR, base_lr=TC.LR,
        rng_key=jax.random.key(1))
    assert set(got["first_step_losses"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["first_step_losses"][k], float(v),
                                   rtol=TOL, atol=0, err_msg=k)
    assert got["loss_first"] == got["first_step_losses"]["total_loss"]
    after = TE.export_base_model(jmodel, params)
    state = runner.model.state_dict()
    assert set(state) == set(after)
    updates = {k: w - weights[k].numpy() for k, w in after.items()}
    scale = max(float(np.abs(u).max()) for u in updates.values())
    for k, w in after.items():
        np.testing.assert_allclose(state[k].numpy(), w, rtol=0, atol=TOL,
                                   err_msg=k)
        # the update itself, within 1e-5 of the step's largest (some
        # tensors move less than 1e-5)
        np.testing.assert_allclose(state[k].numpy() - weights[k].numpy(),
                                   updates[k], rtol=0, atol=TOL * scale,
                                   err_msg=k)
    assert sum(bool(np.abs(u).max() > 0) for u in updates.values()) \
        == len(updates)


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_thirty_steps_lower_the_loss(master_dtype):
    got = TC.run(NARROW, steps=STEPS, master_dtype=master_dtype,
                 **_narrow())
    assert got["loss_decreased"] and got["loss_last"] < got["loss_first"]
    assert np.isfinite(got["loss_last"]) and got["ms_per_step"] > 0
    assert got["master_dtype"] == master_dtype
    assert got["launches"] == {}  # the CPU runs the plain versions


def test_main_grad_accum_writes_the_record(tmp_path, monkeypatch):
    monkeypatch.setattr(TC, "FLAGSHIP", TC.FLAGSHIP + tuple(NARROW))
    out = tmp_path / "accum.json"
    argv = ["--steps", "50", "--batch", "8", "--grad-accum", "2",
            "--device", "cpu", "--out", str(out)]
    # the command line's defaults are the flagship's; the test narrows them
    monkeypatch.setattr(TC, "run", _narrow_frames(TC.run))
    got = TC.main(argv)
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert got["grad_accum"] == 2 and got["steps"] == 50
    assert got["loss_decreased"] and len(got["loss_every_50"]) == 1
    assert got["device"] == "cpu"


def _narrow_frames(run):
    def narrowed(**kw):
        return run(n_classes=CLASSES, frames=FRAMES, **kw)
    return narrowed


def _jax_tool_keys():
    """The keys of tools/tpu_train_check.py's ``result`` record."""
    with open(os.path.join(REPO, "tools", "tpu_train_check.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "result":
            return {k.value for k in node.value.keys}
    raise AssertionError("no result record in tools/tpu_train_check.py")


def test_record_has_the_jax_tools_keys():
    keys = _jax_tool_keys()
    assert {"model_params", "batch", "steps", "ms_per_step",
            "clips_per_sec", "loss_first", "loss_last", "loss_every_50",
            "loss_decreased", "master_dtype", "grad_accum",
            "device"} <= keys
    got = TC.run(NARROW, steps=2, distinct_batches=2, **_narrow())
    assert keys <= set(got), keys - set(got)


def test_against_adds_the_trace_delta_of_two_files(tmp_path):
    """Two runs' records written as the JAX artifact's fp32 and bf16m
    traces: ``trace_delta`` from the two files gives the artifact's own
    numbers (its ``mean`` is the signed mean of bf16m minus fp32; its late
    window the last fifth, 20 of 100 entries)."""
    with open(os.path.join(REPO, "TRAIN_LONG_r05.json")) as f:
        art = json.load(f)
    files = {}
    for key, dtype in (("fp32", "float32"), ("bf16m", "bfloat16")):
        files[key] = tmp_path / f"{key}.json"
        files[key].write_text(json.dumps(
            {"master_dtype": dtype,
             "loss_every_50": art[key]["loss_every_50"]}))
    delta = TC.trace_delta(json.loads(files["bf16m"].read_text()),
                           json.loads(files["fp32"].read_text()))
    for k, v in art["trace_delta"].items():
        assert delta[k] == pytest.approx(v, abs=5e-5), k
    assert delta["late_window_entries"] == 20
    assert delta["max_abs"] >= delta["mean_abs"] >= abs(delta["mean"])
    # the same master dtype on both sides, and traces of other lengths
    same = TC.trace_delta(json.loads(files["fp32"].read_text()),
                          json.loads(files["fp32"].read_text()))
    assert same["max_abs"] == 0.0 and "late_window_mean_this" in same
    with pytest.raises(ValueError, match="same steps"):
        TC.trace_delta({"master_dtype": "float32", "loss_every_50": [1.0]},
                       json.loads(files["fp32"].read_text()))


def test_main_against_writes_trace_delta(tmp_path, monkeypatch):
    monkeypatch.setattr(TC, "FLAGSHIP", TC.FLAGSHIP + tuple(NARROW))
    monkeypatch.setattr(TC, "run", _narrow_frames(TC.run))
    first, second = tmp_path / "fp32.json", tmp_path / "bf16m.json"
    common = ["--steps", "100", "--batch", "4", "--device", "cpu"]
    TC.main(common + ["--out", str(first)])
    got = TC.main(common + ["--master-dtype", "bfloat16", "--against",
                            str(first), "--out", str(second)])
    assert got["against"] == {"file": str(first), "master_dtype": "float32"}
    want = TC.trace_delta(got, json.loads(first.read_text()))
    assert json.loads(second.read_text())["trace_delta"] == want
    assert {"late_window_mean_fp32", "late_window_std_bf16m"} <= set(want)
