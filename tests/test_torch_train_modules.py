"""The training modules of the port against the JAX package, on the CPU:
``train/losses.py`` (the reference's fixtures and the JAX functions),
``train/mixup.py`` (JAX ``MixUp.mix`` with a pinned lambda), ``train/optim.py``
(five steps of SGD / Adam / AdamW against the JAX optimizers on the same
gradients, and every schedule's lr trace against ``afft_tpu.train.optim``).
Inputs come from numpy seeds; fp32. Tolerances are stated at each check.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.train import losses as JLO
from afft_tpu.train import optim as JO
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu_torch.config import instantiate
from afft_tpu_torch.train import losses as LO
from afft_tpu_torch.train import optim as O
from afft_tpu_torch.train.mixup import MixUp

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    return np.load(os.path.join(FIXTURES, f"{name}.npz"))


def _outputs(d, conv):
    return {
        "logits/action": {"all-fused": conv(
            d["in::logits/action::all-fused"])},
        "past_logits/action": {"all-fused": conv(
            d["in::past_logits/action::all-fused"])},
        "orig_past": {"all-fused": conv(d["in::orig_past::all-fused"])},
        "past_futures": {"all-fused": conv(d["in::past_futures::all-fused"])},
    }


def test_losses_match_reference_fixture():
    """loss_basic.npz, at the JAX test's tolerances (rtol 1e-5, atol 1e-6;
    accuracies rtol 1e-6; top-5 ids exact)."""
    d = _load("loss_basic")
    losses, metrics = LO.compute_losses_metrics(
        _outputs(d, torch.tensor), {"action": torch.tensor(d["in::target"])},
        {"action": torch.tensor(d["in::subclips"])}, mixup_enable=False)
    for key in ("cls_action_all-fused", "past_cls_action_all-fused",
                "past_reg_all-fused"):
        np.testing.assert_allclose(losses[key].numpy(), d[f"loss::{key}"],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(metrics["acc1_action_all-fused"].numpy(),
                               d["metric::acc1"], rtol=1e-6)
    np.testing.assert_allclose(metrics["acc5_action_all-fused"].numpy(),
                               d["metric::acc5"], rtol=1e-6)
    payload = metrics["mt5r_action_all-fused"]
    np.testing.assert_array_equal(
        payload["top5"].numpy(), np.argsort(-d["mt5r::logits"], axis=1)[:, :5])
    np.testing.assert_array_equal(payload["labels"].numpy().reshape(-1),
                                  d["mt5r::labels"].reshape(-1))
    total = LO.reduce_losses(losses, {"cls_action": 1.0, "past_cls": 0.5,
                                      "past_reg": 0.0})
    np.testing.assert_allclose(
        float(total), float(d["loss::cls_action_all-fused"])
        + 0.5 * float(d["loss::past_cls_action_all-fused"]), rtol=1e-6)
    with pytest.raises(ValueError, match="not contained"):
        LO.reduce_losses(losses, {"cls_action": 1.0})


def test_mixup_and_losses_match_reference_fixture():
    """loss_mixup.npz: the mixed features and soft labels (1e-6), then the
    losses on them (rtol 1e-5, atol 1e-6)."""
    d = _load("loss_mixup")
    mix = MixUp(alpha=0.5, label_smoothing={"action": 0.4},
                num_classes={"action": 11})
    x_out, labels_out, subclips_out, ignore = mix.mix(
        0.3, {"rgb": torch.tensor(d["in::feats"])},
        {"action": torch.tensor(d["in::target"])},
        {"action": torch.tensor(d["in::subclips"])})
    np.testing.assert_allclose(x_out["rgb"].numpy(), d["out::feats"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(labels_out["action"].numpy(), d["out::labels"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        subclips_out["action"].numpy(),
        d["out::subclips"].reshape(subclips_out["action"].shape),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ignore["action"].numpy().reshape(-1),
                                  d["out::ignore"].reshape(-1))
    src = d if "in::logits/action::all-fused" in d else _load("loss_basic")
    losses, metrics = LO.compute_losses_metrics(
        _outputs(src, torch.tensor), {"action": labels_out["action"]},
        {"action": subclips_out["action"]}, mixup_enable=True,
        target_subclips_ignore_index={"action": ignore["action"]})
    for key in ("cls_action_all-fused", "past_cls_action_all-fused"):
        np.testing.assert_allclose(losses[key].numpy(), d[f"loss::{key}"],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(metrics["acc1_action_all-fused"].numpy(),
                               d["metric::acc1"], rtol=1e-6)


@pytest.mark.parametrize("mixup,weights,padded", [
    (False, False, False), (False, True, True), (True, False, True),
    (True, True, False)])
def test_losses_match_jax_functions(mixup, weights, padded):
    """Random outputs with three targets, T' = 2 future steps, ignore labels,
    padded rows and class weights through both packages: every loss and
    accuracy to rtol 1e-5 (atol 1e-6), the mt5r payload exactly."""
    rng = np.random.default_rng(5)
    B, T, Tp, F = 7, 4, 2, 6
    classes = {"action": 9, "verb": 4}
    valid = np.ones(B, bool)
    if padded:
        valid[-2:] = False
    outs = {"orig_past": {"all-fused": rng.standard_normal((B, T, F))},
            "past_futures": {"all-fused": rng.standard_normal((B, T, F))}}
    target, sub = {}, {}
    for t, c in classes.items():
        outs[f"logits/{t}"] = {"all-fused": rng.standard_normal((B, Tp, c))}
        outs[f"past_logits/{t}"] = {
            "all-fused": rng.standard_normal((B, T, c))}
        target[t] = rng.integers(0, c, (B,))
        sub[t] = rng.integers(-1, c, (B, T, 1))
    outs = {k: {m: v.astype(np.float32) for m, v in d.items()}
            for k, d in outs.items()}
    cw = {"action": rng.uniform(0.2, 3.0, 9).astype(np.float32)} \
        if weights else None
    ignore = None
    if mixup:
        # soft targets without ties (a tie's top-2 order is the framework's
        # own: torch.topk and lax.top_k break it differently)
        def soft(*shape):
            v = rng.uniform(0.05, 1.0, shape).astype(np.float32)
            return v / v.sum(-1, keepdims=True)
        ignore = {t: v.reshape(B, T) == -1 for t, v in sub.items()}
        target = {t: soft(B, c) for t, c in classes.items()}
        sub = {t: soft(B, T, c) for t, c in classes.items()}

    def run(mod, conv):
        tree = lambda d: None if d is None else {  # noqa: E731
            k: conv(v) for k, v in d.items()}
        return mod.compute_losses_metrics(
            {k: tree(d) for k, d in outs.items()}, tree(target), tree(sub),
            mixup_enable=mixup, target_subclips_ignore_index=tree(ignore),
            valid=conv(valid), class_weights=tree(cw))
    want_l, want_m = run(JLO, jnp.asarray)
    got_l, got_m = run(LO, torch.tensor)
    assert set(got_l) == set(want_l) and set(got_m) == set(want_m)
    assert len(got_l) == 5
    for k in want_l:
        np.testing.assert_allclose(got_l[k].numpy(), np.asarray(want_l[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want_m.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(got_m[k][kk].numpy(),
                                              np.asarray(v[kk]), err_msg=k)
        else:
            np.testing.assert_allclose(got_m[k].numpy(), np.asarray(v),
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["mixed", "one_mixable", "padded",
                                  "no_subclips"])
def test_mixup_matches_jax_with_pinned_lambda(case):
    """Features, soft labels, soft subclip labels and ignore masks against
    JAX ``MixUp.mix`` (1e-6): rows with an ignore label stay unmixed, padded
    rows never take part, and with at most one mixable row the batch passes
    through (lambda := 1)."""
    rng = np.random.default_rng(9)
    B, T = 6, 4
    classes = {"action": 7, "verb": 3}
    feats = {m: rng.standard_normal((B, T, 5)).astype(np.float32)
             for m in ("rgb", "flow")}
    labels = {t: rng.integers(0, c, (B,)) for t, c in classes.items()}
    sub = {t: rng.integers(0, c, (B, T, 1)) for t, c in classes.items()}
    valid = None
    if case == "mixed":
        sub["action"][1, 2] = -1
        sub["verb"][1, 2] = -1
    elif case == "one_mixable":
        sub["action"][1:, 0] = -1
    elif case == "padded":
        valid = np.array([1, 1, 1, 1, 0, 0], bool)
    elif case == "no_subclips":
        sub = None
    kw = dict(alpha=0.1, label_smoothing={"action": 0.4, "verb": 0.01},
              num_classes=classes)

    def run(mix, conv):
        tree = lambda d: None if d is None else {  # noqa: E731
            k: conv(v) for k, v in d.items()}
        return mix.mix(0.7, tree(feats), tree(labels), tree(sub),
                       None if valid is None else conv(valid))
    want = run(JaxMixUp(**kw), jnp.asarray)
    got = run(MixUp(**kw), torch.tensor)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        for k in (w or {}):
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    if case == "one_mixable":
        np.testing.assert_array_equal(got[0]["rgb"].numpy(), feats["rgb"])
    else:
        assert not np.allclose(got[0]["rgb"].numpy(), feats["rgb"])


def test_mixup_draws_lambda_from_the_generator():
    mix = MixUp(alpha=0.1, num_classes={"action": 5})
    feats = {"rgb": torch.arange(24.0).reshape(4, 3, 2)}
    labels = {"action": torch.tensor([0, 1, 2, 3])}

    def draw(seed):
        return mix(torch.Generator().manual_seed(seed), feats, labels, None)
    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a[0]["rgb"], b[0]["rgb"])
    assert not torch.equal(a[0]["rgb"], c[0]["rgb"])
    assert bool(a[0]["rgb"].isfinite().all())
    np.testing.assert_allclose(a[1]["action"].sum(-1).numpy(), 1.0, rtol=1e-6)


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = {
    "sgd": (JO.sgd, O.sgd, dict(momentum=0.9, nesterov=False)),
    "sgd_nesterov": (JO.sgd, O.sgd, dict(momentum=0.9, nesterov=True)),
    "adam": (JO.adam, O.adam, dict(betas=(0.9, 0.99), eps=1e-8)),
    "adamw": (JO.adamw, O.adamw, dict(betas=(0.9, 0.99), eps=1e-8)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_jax_over_five_steps(name):
    """Three parameters in three groups (own lr and wd, the overall ones, and
    frozen) with the schedule's factor changing every step, on the same
    numpy gradients: weights after five steps to rtol 1e-5, atol 1e-6 (Adam
    1e-4 / 1e-5, as the JAX package's own comparison with torch); the
    frozen parameter does not move."""
    jax_factory, factory, kw = OPTIMIZERS[name]
    rng = np.random.default_rng(2)
    shapes = {"fuser.w": (4, 3), "head.b": (5,), "frozen.w": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    factors = [0.1, 0.4, 1.0, 0.7, 0.2]
    rules = [["fuser", 0.05, 0.0], [["frozen"], 0.0, 0.0]]

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jgroups = JO.build_group_tree(jp, rules, 0.02, 0.01)
    jopt = jax_factory(**kw)
    state = jopt.init(jp, jgroups)
    for g, f in zip(grads, factors):
        state, upd = jopt.update(state, {k: jnp.asarray(v)
                                         for k, v in g.items()},
                                 jp, jgroups, jnp.float32(f))
        jp = JO.apply_updates(jp, upd)

    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    groups = O.build_groups(list(params.items()), rules, 0.02, 0.01)
    assert groups["fuser.w"] == O.GroupSpec(0.05, 0.0, False)
    assert groups["head.b"] == O.GroupSpec(0.02, 0.01, False)
    assert groups["frozen.w"].frozen
    opt = factory(**kw).bind(list(params.items()), groups)
    assert len(opt.param_groups) == 2
    for g, f in zip(grads, factors):
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step(f)
    tol = dict(rtol=1e-4, atol=1e-5) if "adam" in name \
        else dict(rtol=1e-5, atol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), err_msg=k, **tol)
    np.testing.assert_array_equal(params["frozen.w"].detach().numpy(),
                                  p0["frozen.w"])
    assert not np.allclose(params["head.b"].detach().numpy(), p0["head.b"])


def test_build_groups_prefix_rules():
    names = [("future_predictor.fuser.blocks.0.norm1.weight", None),
             ("future_predictor.mapping.rgb.mapping.0.weight", None)]
    groups = O.build_groups(names, [[["model.future_predictor.fuser"], 0.5,
                                     0.1]], 0.1, 0.01)
    assert groups[names[0][0]] == O.GroupSpec(0.5, 0.1, False)
    assert groups[names[1][0]] == O.GroupSpec(0.1, 0.01, False)
    assert all(g.lr == 0.3 for g in O.build_groups(
        names, [["__all__", 0.3, 0.0]], 0.1, 0.01).values())
    # opt.optimizer.state_dtype builds, and stores the state in it
    params = [(n[0], torch.nn.Parameter(torch.ones(3))) for n in names]
    opt = O.sgd(state_dtype="bfloat16").bind(
        params, O.build_groups(params, None, 0.1, 0.01))
    opt.step(1.0, [torch.full((3,), 0.5) for _ in params])
    assert {st["momentum_buffer"].dtype for st in opt.state} == \
        {torch.bfloat16}


# -- schedules ----------------------------------------------------------------

def _trace(fn, n, base_lr):
    return [fn(k, base_lr) for k in range(n)]


@pytest.mark.parametrize("name", ["warmup_cosine", "cosine_past_t_max",
                                  "multistep", "multistep_constant",
                                  "warmup_one_iter"])
def test_schedule_traces_equal_the_jax_package(name):
    """Every lr of the trace equals the JAX package's exactly (the same
    host arithmetic)."""
    iters = 7
    build = {
        "warmup_cosine": lambda m: m.warmup_wrap(
            m.cosine_schedule(3, iters, world_size=2, eta_min=1e-6),
            init_lr_ratio=0.01, num_epochs=2, iters_per_epoch=iters),
        "cosine_past_t_max": lambda m: m.cosine_schedule(2, iters),
        "multistep": lambda m: m.multistep_schedule(
            milestone_epochs=[2, 4], gamma=0.1, warmup_epochs=1,
            iters_per_epoch=iters),
        "multistep_constant": lambda m: m.multistep_schedule(
            milestones=[1, 3], warmup_method="constant", warmup_epochs=2,
            iters_per_epoch=iters),
        "warmup_one_iter": lambda m: m.warmup_wrap(
            m.cosine_schedule(4, iters), init_lr_ratio=0.5, num_epochs=0,
            iters_per_epoch=iters),
    }[name]
    want = _trace(build(JO), 6 * iters, 0.02)
    got = _trace(build(O), 6 * iters, 0.02)
    assert got == want
    assert len(set(got)) > 3
    if name == "cosine_past_t_max":
        assert got[2 * iters:] == [0.0] * (4 * iters)


def test_plateau_schedule_equals_the_jax_package():
    kw = dict(mode="min", factor=0.5, patience=2, threshold=1e-4,
              threshold_mode="rel", cooldown=1, min_lr=1e-3)
    want, got = JO.plateau_schedule(**kw), O.plateau_schedule(**kw)
    wrapped = O.warmup_wrap(got, init_lr_ratio=0.1, num_epochs=1,
                            iters_per_epoch=10)
    jwrapped = JO.warmup_wrap(want, init_lr_ratio=0.1, num_epochs=1,
                              iters_per_epoch=10)
    rng = np.random.default_rng(0)
    metric = 10.0
    for epoch in range(40):
        if epoch % 7 in (0, 1):
            metric *= 0.9
        obs = metric * (1 + 1e-6 * rng.standard_normal())
        want.observe(obs)
        wrapped.observe(obs)
        assert got(epoch, 0.5) == want(epoch, 0.5)
        assert wrapped(epoch, 0.5) == jwrapped(epoch, 0.5)
    assert got.scale < 1.0
    fresh = O.plateau_schedule(**kw)
    fresh.load_state_dict(got.state_dict())
    assert fresh(0, 0.5) == got(0, 0.5)
    with pytest.raises(ValueError, match="factor"):
        O.plateau_schedule(factor=1.0)


def test_registry_builds_the_configured_optimizer_and_schedule():
    from afft_tpu_torch.config import CONF_DIR, compose
    cfg = compose(CONF_DIR, [
        "opt/optimizer=sgd", "opt.optimizer.nesterov=true",
        "opt.warmup.num_epochs=2", "opt.scheduler.num_epochs=3"])
    opt = instantiate(cfg.opt.optimizer)
    assert isinstance(opt, O.SGD) and opt.defaults["nesterov"] is True
    sched = O.build_schedule(cfg.opt, iters_per_epoch=5)
    want = JO.warmup_wrap(JO.cosine_schedule(3, 5, eta_min=1e-6),
                          init_lr_ratio=0.01, num_epochs=2, iters_per_epoch=5)
    assert _trace(sched, 30, 1e-3) == _trace(want, 30, 1e-3)
    for group, decoupled in (("adam", False), ("adamW", True)):
        cfg = compose(CONF_DIR, [f"opt/optimizer={group}"])
        opt = instantiate(cfg.opt.optimizer)
        assert isinstance(opt, O.Adam) and opt.decoupled is decoupled


# -- dropout, drop-path and the training-mode modules -------------------------

def test_dropout_and_drop_path_draw_from_the_generator():
    from afft_tpu_torch.models import layers as L
    x = torch.ones(64, 50, 8)
    assert L.dropout(x, 0.3, False, None) is x
    assert L.dropout(x, 0.0, True, None) is x
    assert L.drop_path(x, 0.3, False, None) is x
    with pytest.raises(ValueError, match="RngStream"):
        L.dropout(x, 0.3, True, None)
    a = L.dropout(x, 0.3, True, L.RngStream(5))
    assert torch.equal(a, L.dropout(x, 0.3, True, L.RngStream(5)))
    assert not torch.equal(a, L.dropout(x, 0.3, True, L.RngStream(6)))
    assert set(np.unique(a.numpy())) == {np.float32(0),
                                         np.float32(1) / np.float32(0.7)}
    kept, n = float((a > 0).float().mean()), a.numel()
    assert abs(kept - 0.7) <= 4 * (0.21 / n) ** 0.5     # 4 binomial sigmas
    d = L.drop_path(x, 0.5, True, L.RngStream(7))
    rows = d.reshape(64, -1)
    assert bool(((rows == 0).all(1) | (rows == 2).all(1)).all())
    assert 0 < int((rows[:, 0] == 0).sum()) < 64
    assert L.drop_path_schedule(0.1, 1) == [0.0]
    np.testing.assert_allclose(L.drop_path_schedule(0.2, 3), [0.0, 0.1, 0.2])
    words = L.RngStream(3).seed_words()
    assert words == L.RngStream(3).seed_words() != L.RngStream(4).seed_words()
    assert all(0 <= w < 2 ** 31 - 1 for w in words)


def test_block_module_training_path():
    """``Block.forward`` in training mode (the path the fusers take when
    attention weights are asked for): rates 0 change nothing; with rates the
    returned weights carry their dropout, the seed decides the masks, and a
    gradient reaches every parameter."""
    from afft_tpu_torch.models import layers as L
    from afft_tpu_torch.models.blocks import Block
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 32, generator=gen)
    plain = Block(32, 4)
    plain.reset_parameters(gen)
    want, want_w = plain.eval()(x)
    got, got_w = plain.train()(x)
    assert torch.equal(got, want) and torch.equal(got_w, want_w)
    blk = Block(32, 4, drop=0.2, attn_drop=0.3, drop_path=0.25)
    blk.load_state_dict(plain.state_dict())
    y, w = blk(x, rng=L.RngStream(1))
    y2, _ = blk(x, rng=L.RngStream(1))
    y3, _ = blk(x, rng=L.RngStream(2))
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    assert 0 < float((w == 0).float().mean()) < 1
    assert torch.equal(blk.eval()(x)[0], want)
    y.sum().backward()
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in blk.parameters())


def test_fuser_training_dispatch():
    """The SA-Fuser in training mode: the kernel wrapper and the plain
    implementation see the same masks (on the CPU both are the plain
    version), the seed words come once per stack call, attention weights
    come from the module path, and the T-SA and CA fusers train (their
    blocks as modules under autograd)."""
    from afft_tpu_torch.models import layers as L
    from afft_tpu_torch.models.fusion import (ModalTokenCMFuser,
                                              TemporalCMFuser,
                                              TemporalCrossAttentFuser)
    mods = {"rgb": 32, "flow": 32}
    fuser = ModalTokenCMFuser(32, depth=3, num_heads=4, modalities=mods,
                              embd_drop_rate=0.1, drop_rate=0.1,
                              attn_drop_rate=0.1, drop_path_rate=0.2)
    fuser.reset_parameters(torch.Generator().manual_seed(0))
    assert fuser.dpr == [0.0, 0.1, 0.2]
    assert [b.drop_path for b in fuser.blocks] == fuser.dpr
    feats = {m: torch.randn(4, 6, 32) for m in mods}
    order = ["rgb", "flow"]
    a, none = fuser(feats, order, rng=L.RngStream(9))
    b, _ = fuser(feats, order, rng=L.RngStream(9), impl="plain")
    c, _ = fuser(feats, order, rng=L.RngStream(10))
    assert none is None and a.shape == (4, 6, 32)
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, w = fuser(feats, order, rng=L.RngStream(9), need_weights=True)
    assert w.shape == (4, 3, 6, 4, 3, 3)
    with pytest.raises(ValueError, match="RngStream"):
        fuser(feats, order)
    assert torch.equal(fuser.eval()(feats, order)[0],
                       fuser(feats, order, rng=L.RngStream(1))[0])
    for cls in (TemporalCMFuser, TemporalCrossAttentFuser):
        other = cls(32, modalities=mods, num_heads=4)
        y, _ = other(feats, order, rng=L.RngStream(0))
        assert y.shape == (4, 6, 32) and y.requires_grad


def test_predictor_training_path():
    """The GPT-2 predictor in training mode (plain ops under autograd):
    rates 0 equal the eval path; with rates the seed decides; a multi-step
    rollout re-runs the sequence."""
    from afft_tpu_torch.models import layers as L
    from afft_tpu_torch.models.predictor import BaseFuturePredictor
    kw = dict(in_features=32, inter_dim=32, n_layer=2, n_head=4)
    zero = BaseFuturePredictor(embd_pdrop=0.0, resid_pdrop=0.0,
                               attn_pdrop=0.0, **kw)
    zero.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(3, 6, 32)
    with torch.no_grad():
        want, _ = zero.eval()(x)
    got, _ = zero.train()(x)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-5, atol=2e-5)
    drop = BaseFuturePredictor(**kw)        # the config's 0.1 at every site
    drop.load_state_dict(zero.state_dict())
    a, _ = drop(x, rng=L.RngStream(1))
    b, _ = drop(x, rng=L.RngStream(1))
    c, _ = drop(x, rng=L.RngStream(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    roll, _ = drop(x, 3, rng=L.RngStream(1))
    assert roll.shape == (3, 8, 32) and roll.requires_grad
    roll.sum().backward()
    assert all(p.grad is not None for p in drop.parameters())
