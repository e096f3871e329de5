"""The training slice of the port end to end against the JAX package, on the
CPU: ``Runner.train_step`` over the flagship at depth 2 and narrow widths.

- Five steps in both packages from the same weights (carried by
  ``weights.state_dict_from_jax``), batches and pinned mixup lambdas, every
  dropout rate 0, SGD with Nesterov momentum, warmup + cosine: every loss
  component and the total per step (rtol 1e-5, atol 1e-6: the two
  frameworks differ only in summation order, and five small steps do not
  amplify it), the lr trace (exact), the weights after the last step (atol
  2e-5, rtol 1e-4).
- The 30 recorded training steps of tests/fixtures/train_trajectory.npz
  (the reference's own loop; tests/test_trajectory.py gives its
  configuration), replayed with the recorded lambdas: losses, lr trace and
  weights at that test's tolerances.
- With the expt's dropout rates on: finite losses and gradients, seeds
  decide the masks, eval mode ignores the rates.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_trajectory as TT
from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train import loop as JLP
from afft_tpu.train import optim as JO
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.ops import launch_counts, reset_launches
from afft_tpu_torch.train import optim as O
from afft_tpu_torch.train.mixup import MixUp
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_EXPT = os.path.join(REPO, "expts", "01_SA-Fuser_ek100_train.txt")
NARROW = ["model.modal_dims={rgb:32, objects:20, audio:32, flow:32}",
          "model.common_dim=32", "model.fuser.depth=2",
          "model.common.fp_inter_dim=64", "model.common.fp_layers=2"]
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
NUM_CLASSES = {"action": 23, "verb": 7, "noun": 9}
ITERS = 2  # iterations an epoch: one epoch of warmup, then the cosine


def _overrides(more=()):
    return read_expt_file(TRAIN_EXPT) + NARROW + [
        "opt.lr=0.05", "opt.warmup.num_epochs=1",
        "opt.scheduler.num_epochs=3"] + list(more)


def _batches(cfg, n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    dims = cfg.model.modal_dims.to_container()
    out = []
    for i in range(n):
        sub = {t: rng.integers(0, c, (batch, T, 1))
               for t, c in NUM_CLASSES.items()}
        for t in sub:              # one row with ignored frames: not mixed
            sub[t][1, :3] = -1
        out.append({
            "data_dict": {m: rng.standard_normal((batch, T, int(d)))
                          .astype(np.float32) for m, d in dims.items()},
            "target": {t: rng.integers(0, c, (batch,))
                       for t, c in NUM_CLASSES.items()},
            "target_subclips": sub, "valid": np.ones((batch,), bool),
            "mixup_lam": np.float32(0.3 + 0.1 * i)})
    return out


def test_five_train_steps_match_jax():
    more = NO_DROPOUT + ["opt.grad_clip=5.0"]
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"), _overrides(more))
    tcfg = compose(CONF_DIR, _overrides(more))
    batches = _batches(tcfg, 5)

    jmodel = JaxBaseModel(jcfg.model, num_classes=NUM_CLASSES)
    params = jmodel.init(jax.random.key(7))
    params0 = jax.tree.map(np.asarray, params)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    assert joptimizer.nesterov
    opt_state = joptimizer.init(params, groups)
    jsched = JLP.build_schedule(jcfg, ITERS, 1)
    jrunner = JaxRunner(
        jmodel, joptimizer, groups,
        loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=NUM_CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False)
    want_losses, want_lr = [], []
    for i, batch in enumerate(batches):
        lr = jsched(i, jcfg.opt.lr)
        jbatch = {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])}
        params, opt_state, losses, _, _ = jrunner.train_step(
            params, opt_state, jbatch, lr, jcfg.opt.lr, jax.random.key(i))
        want_losses.append({k: float(v) for k, v in losses.items()})
        want_lr.append(lr)

    runner = Runner.from_config(tcfg, NUM_CLASSES, device="cpu",
                                iters_per_epoch=ITERS)
    runner.model.load_state_dict(
        W.state_dict_from_jax(runner.model, params0), strict=True)
    assert runner.grad_clip == 5.0 and runner.mixup is not None
    reset_launches()
    got_lr = []
    for i, batch in enumerate(batches):
        lr = runner.lr_schedule(i, runner.base_lr)
        losses, metrics = runner.train_step(batch, lr, runner.base_lr,
                                            check_nan=True)
        got_lr.append(lr)
        assert set(losses) == set(want_losses[i]) and len(losses) == 8
        for k, v in want_losses[i].items():
            np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        assert not losses["total_loss"].requires_grad
        assert "mt5r_action_all-fused" in metrics
    assert sum(launch_counts().values()) == 0      # CPU: plain versions
    assert got_lr == want_lr and len(set(got_lr)) == 5
    want_sd = W.state_dict_from_jax(runner.model,
                                    jax.tree.map(np.asarray, params))
    first_sd = W.state_dict_from_jax(runner.model, params0)
    got_sd = runner.model.state_dict()
    assert set(got_sd) == set(want_sd)
    moved = 0
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
        moved += not np.allclose(want.numpy(), first_sd[k].numpy(),
                                 atol=1e-4)
    assert moved > len(want_sd) // 2    # the steps did move the weights


def _trajectory_runner(d):
    model = BaseModel(TT._model_cfg("early"), num_classes=TT.NUM_CLASSES,
                      class_mappings={})
    # the fixture's state dict loads with no adapter
    model.load_state_dict({k[5:]: torch.tensor(d[k]) for k in d.files
                           if k.startswith("sd0::")}, strict=True)
    named = list(model.named_parameters())
    groups = O.build_groups(named, [["future_predictor.fuser", 0.01, 0.0]],
                            TT.LR, TT.WD)
    assert {g.lr for g in groups.values()} == {0.01, TT.LR}
    mixup = MixUp(alpha=0.1, label_smoothing={"action": 0.4, "verb": 0.01,
                                              "noun": 0.03},
                  num_classes=TT.NUM_CLASSES)
    return Runner(model, O.sgd(momentum=0.9, nesterov=False), groups,
                  loss_wts=TT.LOSS_WTS, mixup=mixup, mixup_backbone=True,
                  grad_clip=1.0)


def test_recorded_trajectory_replays():
    """30 training steps of the reference loop: per-iteration losses (first
    step rtol 1e-4 / atol 1e-5, total 1e-5; the trajectory 2e-3 on the
    total and 5e-3 on the components), the lr trace (rtol 1e-6), the
    weights after steps 1-3 (relative L2 < 1e-5) and after step 30
    (relative L2 < 2e-4): the tolerances of tests/test_trajectory.py."""
    d = np.load(os.path.join(REPO, "tests", "fixtures",
                             "train_trajectory.npz"))
    n_steps = TT.EPOCHS * TT.ITERS
    runner = _trajectory_runner(d)
    schedule = O.warmup_wrap(
        O.cosine_schedule(TT.EPOCHS, TT.ITERS, world_size=1, eta_min=1e-6),
        init_lr_ratio=0.01, num_epochs=1, iters_per_epoch=TT.ITERS)
    batches = TT._batches(d, "batch", n_steps, lam=d["lam"])
    got, lrs = [], []

    def rel_l2(prefix):
        worst = 0.0
        sd = runner.model.state_dict()
        keys = [k for k in d.files if k.startswith(prefix)]
        assert len(keys) == len(sd)
        for k in keys:
            want = d[k]
            diff = np.linalg.norm(sd[k[len(prefix):]].numpy() - want)
            worst = max(worst, diff / max(np.linalg.norm(want), 1e-8))
        return worst

    for i, batch in enumerate(batches):
        lr = schedule(i, TT.LR)
        losses, _ = runner.train_step(batch, lr, TT.LR)
        got.append({k: float(v) for k, v in losses.items()})
        lrs.append(lr)
        if i < 3:
            assert rel_l2(f"step{i}::") < 1e-5, f"weights after step {i + 1}"
    np.testing.assert_allclose(lrs, d["lr::rest"], rtol=1e-6, atol=1e-9)
    keys = [k[6:] for k in d.files if k.startswith("iter::")
            and "total_loss" not in k and "acc" not in k]
    assert len(keys) == 7
    for k in keys:
        np.testing.assert_allclose(got[0][k], d[f"iter::{k}"][0], rtol=1e-4,
                                   atol=1e-5, err_msg=f"iter 0 loss {k}")
        np.testing.assert_allclose([r[k] for r in got], d[f"iter::{k}"],
                                   rtol=5e-3, atol=5e-3, err_msg=k)
    np.testing.assert_allclose(got[0]["total_loss"],
                               d["iter::total_loss"][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([r["total_loss"] for r in got],
                               d["iter::total_loss"], rtol=2e-3, atol=2e-3)
    assert rel_l2("sdF::") < 2e-4


def test_eval_step_matches_recorded_validation_losses():
    """``eval_step`` on the fixture's first validation batch with the
    initial weights equals the JAX runner's eval step (rtol 1e-5)."""
    d = np.load(os.path.join(REPO, "tests", "fixtures",
                             "train_trajectory.npz"))
    runner = _trajectory_runner(d)
    batch = TT._batches(d, "val", 1)[0]
    losses, metrics, logits = runner.eval_step(batch)
    assert logits.shape == (TT.B, TT.NUM_CLASSES["action"])
    assert runner.model.training is False

    from afft_tpu.train import torch_import as TI
    jmodel = JaxBaseModel(TT._model_cfg("early"),
                          num_classes=TT.NUM_CLASSES, class_mappings={})
    params = TI.import_base_model(
        jmodel, {k[5:]: d[k] for k in d.files if k.startswith("sd0::")})
    groups = JO.build_group_tree(params, None, TT.LR, TT.WD)
    jrunner = JaxRunner(jmodel, JO.sgd(), groups, loss_wts=TT.LOSS_WTS,
                        donate=False)
    want, _, want_logits, _ = jrunner.eval_step(params, batch)
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=2e-5)
    assert float(metrics["acc5_action_all-fused"]) >= 0.0


def _dropout_runner(seed, more=()):
    cfg = compose(CONF_DIR, _overrides([f"seed={seed}", *more]))
    return cfg, Runner.from_config(cfg, NUM_CLASSES, device="cpu",
                                   iters_per_epoch=ITERS)


def test_training_with_the_expt_dropout_rates():
    """Two steps with dropout 0.1 at every fuser and GPT-2 site, drop-path
    0.1, classifier dropout 0.2 and a drawn mixup lambda: finite losses,
    a finite gradient for every parameter, the same seed gives the same
    losses and another seed others."""
    cfg, runner = _dropout_runner(11)
    fuser = runner.model.future_predictor.fuser
    assert fuser.drop_rate == 0.1 and fuser.dpr == [0.0, 0.1]
    assert runner.model.future_predictor.dropout_rate == 0.2
    batches = _batches(cfg, 2, seed=3)
    for b in batches:
        del b["mixup_lam"]

    def two_steps(r):
        out = []
        for b in batches:
            losses, _ = r.train_step(b, 1e-3, 1e-3, check_nan=True)
            out.append(float(losses["total_loss"]))
        return out
    first = two_steps(runner)
    assert np.isfinite(first).all()
    for name, p in runner.model.named_parameters():
        assert p.grad is not None and bool(p.grad.isfinite().all()), name
        assert float(p.grad.abs().max()) > 0, name
    state0 = Runner.from_config(cfg, NUM_CLASSES, device="cpu",
                                iters_per_epoch=ITERS)
    assert two_steps(state0) == first            # same seed, same masks
    _, other = _dropout_runner(12)
    other.model.load_state_dict(_dropout_runner(11)[1].model.state_dict())
    assert two_steps(other)[0] != first[0]       # other seeds, other masks


def test_eval_mode_ignores_the_dropout_rates():
    cfg, runner = _dropout_runner(11)
    _, plain = _dropout_runner(11, NO_DROPOUT)
    batch = _batches(cfg, 1, seed=4)[0]
    with_rates = runner.eval_step(batch)
    without = plain.eval_step(batch)
    assert torch.equal(with_rates[2], without[2])
    assert float(with_rates[0]["total_loss"]) == \
        float(without[0]["total_loss"])
    # and in training mode without a generator the rates are refused
    model = runner.model.train()
    feats = {m: torch.tensor(v) for m, v in batch["data_dict"].items()}
    with pytest.raises(ValueError, match="RngStream"):
        model(feats)


def test_bf16_compute_keeps_fp32_masters():
    """compute_dtype=bfloat16: forward and backward on a bf16 copy, the
    update on the fp32 masters, the copy refreshed from them."""
    cfg = compose(CONF_DIR, _overrides(NO_DROPOUT))
    runner = Runner.from_config(cfg, NUM_CLASSES, device="cpu",
                                iters_per_epoch=ITERS,
                                compute_dtype="bfloat16")
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    batch = _batches(cfg, 1, seed=5)[0]
    losses, _ = runner.train_step(batch, 0.05, 0.05, check_nan=True)
    assert losses["total_loss"].dtype == torch.float32
    for (name, p), c in zip(runner.model.named_parameters(),
                            runner.compute):
        assert p.dtype == torch.float32 and c.dtype == torch.bfloat16
        assert torch.equal(c, p.to(torch.bfloat16)), name
        assert not torch.equal(p, before[name]), name
    # train.grad_accum builds (tests/test_torch_train_options.py trains it)
    accum = Runner.from_config(compose(CONF_DIR, _overrides(
        ["train.grad_accum=2"])), NUM_CLASSES, device="cpu")
    assert accum.grad_accum == 2


def test_grads_from_jax_round_trips_against_state_dict_from_jax():
    """On a tree of distinct values every leaf lands under the right name in
    the right layout: ``grads_from_jax`` equals ``state_dict_from_jax`` on
    the names of ``named_parameters`` (one name for the shared classifier),
    keeps every value, and re-interleaves ``c_attn`` from the JAX
    heads-major packing to [q | k | v]."""
    more = ["model.mapping.use_layernorm=true",
            "model.mapping.sparse_mapping=false",
            "model.fuser.modal_encoding=true"]
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"), _overrides(more))
    tcfg = compose(CONF_DIR, _overrides(more))
    jmodel = JaxBaseModel(jcfg.model, num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    leaves, treedef = jax.tree.flatten(shapes)
    offsets = np.cumsum([0] + [int(np.prod(leaf.shape)) for leaf in leaves])
    tree = jax.tree.unflatten(treedef, [
        np.arange(lo, hi, dtype=np.float64).reshape(leaf.shape)
        for leaf, lo, hi in zip(leaves, offsets[:-1], offsets[1:])])
    model = BaseModel(tcfg.model, num_classes=NUM_CLASSES)
    grads = W.grads_from_jax(model, tree)
    sd = W.state_dict_from_jax(model, tree)
    names = [n for n, _ in model.named_parameters()]
    assert list(grads) == names and set(names) <= set(sd)
    values = []
    for name, p in model.named_parameters():
        assert tuple(grads[name].shape) == tuple(p.shape), name
        assert torch.equal(grads[name], sd[name]), name
        values.append(grads[name].reshape(-1))
    # a permutation of the tree: every value exactly once
    assert torch.equal(torch.cat(values).sort().values,
                       torch.arange(offsets[-1], dtype=torch.float64))
    blk = tree["future_predictor"]["future_predictor"]["shared"]["blocks"][1]
    n_head, C = 4, 64
    hd = C // n_head
    got = grads["future_predictor.future_predictor.gpt_model.h.1.attn."
                "c_attn.weight"].numpy()
    packed = blk["c_attn"]["w"].reshape(C, n_head, 3, hd)
    for part in range(3):           # q, k, v blocks, heads minor
        np.testing.assert_array_equal(
            got[:, part * C:(part + 1) * C],
            packed[:, :, part, :].reshape(C, C))
    np.testing.assert_array_equal(
        grads["future_predictor.fuser.blocks.0.attn.qkv.weight"].numpy(),
        tree["future_predictor"]["fuser"]["blocks"][0]["attn"]["qkv"]["w"].T)


def test_whole_model_gradients_match_jax():
    """One backward through the narrow flagship in both packages (no
    dropout, no mixup): every parameter's gradient, carried over by
    ``grads_from_jax``, at rtol 1e-4 plus an atol of 2e-6 of that
    gradient's largest magnitude. A gradient is an fp32 sum over 64 rows
    whose terms cancel where it is small: the two frameworks' summation
    orders then differ by a share of the terms' size, which is the
    gradient's scale (up to 1e2 here), not by a fixed amount."""
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"),
                       _overrides(NO_DROPOUT))
    tcfg = compose(CONF_DIR, _overrides(NO_DROPOUT))
    jmodel = JaxBaseModel(jcfg.model, num_classes=NUM_CLASSES)
    params = jmodel.init(jax.random.key(3))
    batch = _batches(tcfg, 1, seed=6)[0]
    feats = {m: jnp.asarray(v) for m, v in batch["data_dict"].items()}

    def scalar(out):
        return sum((out[k]["all-fused"] ** 2).sum() for k in out
                   if "logits/" in k or k == "past_futures")
    want = jax.grad(lambda p: scalar(jmodel.apply(
        p, feats, train=True, rng=None)[0]))(params)
    model = BaseModel(tcfg.model, num_classes=NUM_CLASSES).train()
    model.load_state_dict(W.state_dict_from_jax(
        model, jax.tree.map(np.asarray, params)), strict=True)
    scalar(model({m: torch.tensor(v) for m, v in
                  batch["data_dict"].items()})).backward()
    want = W.grads_from_jax(model, jax.tree.map(np.asarray, want))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=2e-6 * np.abs(ref).max(),
                                   err_msg=name)
