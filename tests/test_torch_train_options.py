"""The port's training options against the JAX package, on the CPU:
``train.grad_accum``, ``opt.optimizer.state_dtype``,
``train.master_dtype=bfloat16`` with stochastic rounding, and resuming
across them (ZeRO-1 is held on processes in tests/test_torch_dp.py).

- ``grad_accum=2`` against the JAX runner's ``grad_accum=2`` on expt 99 at
  fp32, mixup off and every dropout rate 0: with every row valid, with a
  ragged ``valid``, with a microbatch that has no valid row, and with the
  class weights of ``train.class_weight_beta``; the losses of two steps
  (rtol 1e-5, atol 1e-6) and the weights after them (atol 2e-5, rtol 1e-4).
  In the port alone, M = 2 equals one pass with the expt's dropout rates on,
  and a batch that M does not divide raises.
- SGD (plain and Nesterov), Adam and AdamW with ``state_dtype=bfloat16``
  against the JAX optimizers for three steps on the same gradients: the
  weights at the same tolerances, the state within one bf16 ulp. Under the
  default state each equals ``torch.optim`` over five steps, and takes over
  a ``torch.optim`` state dict (the checkpoints of the port before it had
  its own step).
- ``stochastic_round_bf16`` bit for bit against the JAX function given the
  same bits (``jax.random.bits``) over normals, negatives, subnormals,
  exact values and infinities; unbiased over many draws. The optimizer
  step's write-back of a bf16 parameter bit for bit the JAX
  ``apply_updates`` without rounding bits, unbiased with them.
- One bf16-master step: each bf16 weight is one of the two bf16 neighbours
  of the fp32 ``p + u`` that the JAX optimizer computes from the step's
  gradients (the runner's update, rounded stochastically); the losses of
  that step equal the JAX bf16-master runner's at bf16's tolerance; without
  bf16 compute the option raises.
- The launcher resumes a bf16-master checkpoint at fp32 masters and an fp32
  one under bf16 masters, each cast to the resumed run's dtype, and a
  checkpoint whose optimizer state is ``torch.optim``'s resumes.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train import optim as JO
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import run as RUN
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.tools import dp_check as D
from afft_tpu_torch.train import checkpoint as CK
from afft_tpu_torch.train import optim as O
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
CLASSES = {"action": 106, "verb": 19, "noun": 51}  # the synthetic set's
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
RATES = [r.replace("=0.0", "=0.1") for r in NO_DROPOUT[1:]]
NO_MIXUP = ["train.use_mixup=false"]
BATCH, STEPS = 8, 2
WEIGHT_TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _configs(overrides):
    lines = read_expt_file(SMOKE_TRAIN) + list(overrides)
    return (compose(CONF_DIR, lines),
            jax_compose(os.path.join(REPO, "afft_tpu", "conf"), lines))


def _jax_runner(jcfg, params, **kw):
    model = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    optimizer = jax_instantiate(jcfg.opt.optimizer)
    runner = JaxRunner(model, optimizer, groups,
                       loss_wts=dict(jcfg.train.loss_wts.items()),
                       mixup=None, mixup_backbone=jcfg.train.mixup_backbone,
                       grad_clip=jcfg.opt.grad_clip, donate=False, **kw)
    return runner, optimizer.init(params, groups)


def _assert_weights(runner, params, **tol):
    want = W.state_dict_from_jax(runner.model,
                                 jax.tree.map(lambda x: np.asarray(
                                     x, np.float32), params))
    got = runner.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), w.float().numpy(),
                                   err_msg=k, **tol)


# -- train.grad_accum ---------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "ragged", "empty_microbatch",
                                  "class_weights"])
def test_grad_accum_matches_jax(case):
    """Two steps at grad_accum=2 in both packages from the same weights and
    batches: the n-weighted combination of the microbatches' gradients and
    losses, the microbatch without valid rows adding nothing, and each
    microbatch's class-weighted CE over its own weight sum."""
    more = NO_DROPOUT + NO_MIXUP + ["train.grad_accum=2"]
    weights = None
    if case == "class_weights":
        more.append("train.class_weight_beta=0.999")
        rng = np.random.default_rng(5)
        weights = {t: rng.uniform(0.2, 3.0, c).astype(np.float32)
                   for t, c in CLASSES.items()}
    cfg, jcfg = _configs(more)
    invalid = {"full": [], "ragged": [5, 6, 7], "empty_microbatch": [4, 5,
                                                                     6, 7],
               "class_weights": []}[case]
    batches = D.make_batches(cfg, CLASSES, BATCH, STEPS, 3, invalid)
    params = JaxBaseModel(jcfg.model, num_classes=CLASSES).init(
        jax.random.key(3))
    runner = Runner.from_config(cfg, CLASSES, device="cpu",
                                class_weights=weights,
                                weights=W.state_dict_from_jax(
                                    Runner.from_config(
                                        cfg, CLASSES, device="cpu",
                                        class_weights=weights).model,
                                    jax.tree.map(np.asarray, params)))
    jrunner, opt_state = _jax_runner(jcfg, params, grad_accum=2,
                                     class_weights=weights)
    lr = float(cfg.opt.lr)
    for i, batch in enumerate(batches):
        params, opt_state, want, _, _ = jrunner.train_step(
            params, opt_state, batch, lr, lr, jax.random.key(i))
        got, metrics = runner.train_step(batch, lr, lr, check_nan=True)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v),
                                       err_msg=f"step {i} {k}", **LOSS_TOL)
        # the MT5R payloads are the local batch's rows again
        assert metrics["mt5r_action_all-fused"]["top5"].shape[0] == BATCH
    _assert_weights(runner, params, **WEIGHT_TOL)


def _two_steps(overrides, batches, compute_dtype=None):
    cfg, _ = _configs(overrides)
    runner = Runner.from_config(cfg, CLASSES, device="cpu",
                                compute_dtype=compute_dtype)
    lr = float(cfg.opt.lr)
    losses = [runner.train_step(b, lr, lr)[0] for b in batches]
    return losses, runner.model.state_dict()


# fp32: only the summation order differs; bf16 compute (the gradients
# summed in fp32 from bf16 microbatch gradients): bf16's rounding (a CPU
# run reads 2.5e-4 and 8.3e-4; a microbatch left out would move the
# weights by lr * grad / 2, far past either)
ONE_PASS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 5e-3)}


@pytest.mark.parametrize("dtype", sorted(ONE_PASS_TOL))
def test_grad_accum_equals_one_pass_with_dropout(dtype):
    """Mixup off, the expt's dropout and drop-path rates on: the masks are
    drawn by the row's place in the whole step's batch, so two microbatches
    take the one-pass step: the losses (relative) and the weights after
    two steps (of max|w|) within ONE_PASS_TOL."""
    loss_tol, weight_tol = ONE_PASS_TOL[dtype]
    cfg, _ = _configs(RATES + NO_MIXUP)
    batches = D.make_batches(cfg, CLASSES, BATCH, STEPS, 4, [6])
    one, want = _two_steps(RATES + NO_MIXUP, batches, dtype)
    two, got = _two_steps(RATES + NO_MIXUP + ["train.grad_accum=2"],
                          batches, dtype)
    for a, b in zip(two, one):
        for k, v in b.items():
            np.testing.assert_allclose(float(a[k]), float(v), rtol=loss_tol,
                                       atol=0, err_msg=k)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(),
                                   v.float().numpy(),
                                   atol=weight_tol * scale, rtol=0,
                                   err_msg=k)
    # the rates act: without them the first loss differs
    plain, _ = _two_steps(NO_DROPOUT + NO_MIXUP, batches[:1])
    assert float(plain[0]["total_loss"]) != float(one[0]["total_loss"])


def test_grad_accum_must_divide_the_batch():
    cfg, _ = _configs(NO_DROPOUT + ["train.grad_accum=4"])
    runner = Runner.from_config(cfg, CLASSES, device="cpu")
    batch = D.make_batches(cfg, CLASSES, 6, 1, 0)[0]
    with pytest.raises(ValueError, match="grad_accum=4 must divide"):
        runner.train_step(batch, 0.01, 0.01)


# -- the optimizer step -------------------------------------------------------

OPTIMIZERS = {
    "sgd": (JO.sgd, O.sgd, torch.optim.SGD, dict(momentum=0.9,
                                                   nesterov=False)),
    "sgd_nesterov": (JO.sgd, O.sgd, torch.optim.SGD,
                     dict(momentum=0.9, nesterov=True)),
    "adam": (JO.adam, O.adam, torch.optim.Adam, dict(betas=(0.9, 0.99),
                                                      eps=1e-8)),
    "adamw": (JO.adamw, O.adamw, torch.optim.AdamW,
              dict(betas=(0.9, 0.99), eps=1e-8)),
}
SHAPES = {"fuser.w": (4, 3), "head.b": (5,), "frozen.w": (2, 2)}
RULES = [["fuser", 0.05, 0.0], [["frozen"], 0.0, 0.0]]
FACTORS = [0.1, 0.4, 1.0, 0.7, 0.2]


def _problem(seed, steps):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return p0, grads


def _bf16_ulp(x):
    """bf16's spacing at |x| (fp32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_bf16_state_matches_jax_over_three_steps(name):
    jax_factory, factory, _, kw = OPTIMIZERS[name]
    p0, grads = _problem(2, 3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jgroups = JO.build_group_tree(jp, RULES, 0.02, 0.01)
    jopt = jax_factory(state_dtype="bfloat16", **kw)
    jstate = jopt.init(jp, jgroups)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = factory(state_dtype="bfloat16", **kw).bind(
        list(params.items()), O.build_groups(list(params.items()), RULES,
                                             0.02, 0.01))
    for g, f in zip(grads, FACTORS):
        jstate, upd = jopt.update(jstate, {k: jnp.asarray(v)
                                           for k, v in g.items()},
                                  jp, jgroups, jnp.float32(f))
        jp = JO.apply_updates(jp, upd)
        opt.step(f, [torch.tensor(g[k]) for k, p in params.items()
                     if any(p is q for q in opt.params)])
    for k in SHAPES:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), err_msg=k,
                                   **WEIGHT_TOL)
    np.testing.assert_array_equal(params["frozen.w"].detach().numpy(),
                                  p0["frozen.w"])
    names = [k for k, p in params.items()
             if any(p is q for q in opt.params)]
    pairs = [("momentum", "momentum_buffer")] if "sgd" in name else \
        [("m", "exp_avg"), ("v", "exp_avg_sq")]
    for jname, tname in pairs:
        for i, k in enumerate(names):
            got = opt.state[i][tname]
            assert got.dtype == torch.bfloat16
            want = np.asarray(jstate[jname][k].astype(jnp.float32))
            diff = np.abs(got.float().numpy() - want)
            assert (diff <= _bf16_ulp(want)).all(), (tname, k, diff.max())


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_default_state_matches_torch_optim(name):
    """The port's step under the default (fp32) state against torch.optim
    over the same groups for five steps, then a torch.optim state dict
    loaded into a fresh port optimizer continues as torch.optim does. Like
    torch.optim, the step leaves ``.grad`` as it was given."""
    _, factory, torch_cls, kw = OPTIMIZERS[name]
    p0, grads = _problem(4, 7)
    named = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    ref = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    groups = O.build_groups(list(named.items()), RULES, 0.02, 0.01)
    opt = factory(**kw).bind(list(named.items()), groups)
    torch_groups = [{"params": [ref[k] for k, p in named.items()
                                if any(p is q for q in g["params"])],
                     "lr": g["lr"], "base_lr": g["base_lr"],
                     "weight_decay": g["weight_decay"]}
                    for g in opt.param_groups]
    topt = torch_cls(torch_groups, **kw)

    def step(optimizer, params, g, f):
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        if optimizer is topt:
            for group in topt.param_groups:
                group["lr"] = group["base_lr"] * f
            topt.step()
        else:
            optimizer.step(f)
        for k, p in params.items():
            np.testing.assert_array_equal(p.grad.numpy(), g[k], err_msg=k)

    for g, f in zip(grads[:5], FACTORS):
        step(opt, named, g, f)
        step(topt, ref, g, f)
    for k in SHAPES:
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   ref[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the state dicts have one layout
    mine, theirs = opt.state_dict(), topt.state_dict()
    assert set(mine["state"]) == set(theirs["state"])
    for i, st in theirs["state"].items():
        assert set(mine["state"][i]) == set(st), i
        for k, v in st.items():
            np.testing.assert_allclose(mine["state"][i][k].numpy(),
                                       v.numpy(), rtol=1e-6, atol=1e-7)
    # a torch.optim state dict resumes in the port's step
    resumed = {k: torch.nn.Parameter(p.detach().clone())
               for k, p in ref.items()}
    again = factory(**kw).bind(list(resumed.items()), groups)
    again.load_state_dict(theirs)
    for g, f in zip(grads[5:], [0.5, 0.3]):
        step(again, resumed, g, f)
        step(topt, ref, g, f)
    for k in SHAPES:
        np.testing.assert_allclose(resumed[k].detach().numpy(),
                                   ref[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# -- stochastic rounding ------------------------------------------------------

def _specials():
    rng = np.random.default_rng(0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    return np.concatenate([
        rng.standard_normal(4000).astype(np.float32),
        -np.abs(rng.standard_normal(1000)).astype(np.float32) * 1e3,
        (rng.uniform(-1, 1, 1000) * tiny).astype(np.float32),  # subnormals
        np.asarray([1.0, -2.0, 0.5, 0.0, -0.0, 3.0, 2.0 ** -100,
                    np.float32(65536.0)], np.float32),
        np.asarray([np.inf, -np.inf], np.float32),
        np.asarray([np.finfo(np.float32).max, -np.finfo(np.float32).max],
                   np.float32)])


def test_stochastic_round_matches_jax_bit_for_bit():
    x = _specials()
    for seed in range(3):
        key = jax.random.key(seed)
        bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
        want = np.asarray(JO.stochastic_round_bf16(jnp.asarray(x), key))
        got = O.stochastic_round_bf16(
            torch.from_numpy(x), torch.from_numpy(bits.view(np.int32).copy()))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    # exactly representable values pass through whatever the bits
    exact = torch.tensor([1.0, -2.0, 0.5, 0.0, 3.0, float("inf"),
                          -float("inf"), 2.0 ** -100])
    every = torch.randint(0, 1 << 16, (64, exact.numel()), dtype=torch.int32)
    for row in every:
        assert torch.equal(O.stochastic_round_bf16(exact, row),
                           exact.to(torch.bfloat16))


def test_stochastic_round_is_unbiased():
    """Values between two bf16 neighbours: the mean of 2^16 roundings with
    the port's own bits lies within 1e-2 ulp of the value (about five
    standard errors), and each rounding is one of the two neighbours."""
    gen = torch.Generator().manual_seed(7)
    lo = torch.tensor([1.0, -3.0, 0.15625, 1000.0])
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -6, 2.0 ** -10, 4.0])
    frac = torch.tensor([0.5, 0.25, 0.9, 0.01])
    x = lo + torch.sign(lo) * frac * ulp
    draws = 1 << 16
    rounded = O.stochastic_round_bf16(
        x.expand(draws, -1), O.random_bits((draws, x.numel()), gen)).float()
    hi = lo + torch.sign(lo) * ulp
    assert ((rounded == lo) | (rounded == hi)).all()
    err = (rounded.double().mean(0) - x.double()).abs() / ulp.double()
    assert (err < 1e-2).all(), err


def test_bf16_parameter_write_back_matches_jax_apply_updates():
    """The optimizer step's write-back of a bf16 parameter against
    afft_tpu/train/optim.py's ``apply_updates``: without a generator p + u
    rounded to nearest, bit for bit (and an fp32 parameter takes p + u
    exactly); with one, a sub-ulp update survives in expectation (the JAX
    package's tests/test_train.py test_apply_updates_bf16_master_stochastic)
    and every value is one of the two neighbours. SGD without momentum at
    lr 1 makes the update u the negated gradient."""
    rng = np.random.default_rng(11)
    p32 = rng.standard_normal(1000).astype(np.float32)
    p16 = jnp.asarray(p32).astype(jnp.bfloat16)
    u = (rng.standard_normal(1000) * 1e-2).astype(np.float32)
    want = JO.apply_updates({"a": jnp.asarray(p32), "b": p16},
                            {"a": jnp.asarray(u), "b": jnp.asarray(u)})

    def step(params, grads, gen=None):
        named = [(str(k), p) for k, p in enumerate(params)]
        opt = O.sgd(momentum=0.0).bind(
            named, {n: O.GroupSpec(1.0, 0.0, False) for n, _ in named})
        opt.step(1.0, grads, gen=gen)

    got = [torch.tensor(p32),
           torch.tensor(np.asarray(p16.astype(jnp.float32))).bfloat16()]
    step(got[:1], [torch.tensor(-u)])
    step(got[1:], [torch.tensor(-u)])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(
        got[1].view(torch.int16).numpy(),
        np.asarray(want["b"]).view(np.int16))
    w = torch.full((50_000,), 256.0, dtype=torch.bfloat16)  # ulp = 2.0
    step([w], [torch.full((50_000,), -0.125)],
         torch.Generator().manual_seed(0))
    assert set(w.float().unique().tolist()) == {256.0, 258.0}
    assert abs(float(w.float().mean()) - 256.125) < 0.03


# -- bf16 master weights ------------------------------------------------------

def _neighbours(want32):
    """The bf16 bit patterns next to each fp32 value of ``want32`` (and of
    the fp32 values one ulp either side, which the two packages' different
    fp32 operation order may give)."""
    out = []
    for x in (np.nextafter(want32, -np.inf), want32,
              np.nextafter(want32, np.inf)):
        bits = x.astype(np.float32).view(np.int32)
        toward = bits & -65536
        out += [toward, toward + 65536]
    return np.stack(out)


def test_bf16_master_step_is_a_neighbour_of_jax():
    """One step at train.master_dtype=bfloat16 (SGD with Nesterov momentum,
    bf16 compute): the gradients the runner hands its optimizer, applied by
    the JAX optimizer to the same bf16 weights, give JAX's fp32 p + u; each
    bf16 weight of the port is one of its two bf16 neighbours, and its
    rounding is not always to nearest. The losses equal the JAX
    bf16-master runner's from the same weights at bf16's tolerance."""
    more = NO_DROPOUT + NO_MIXUP + ["model.compute_dtype=bfloat16",
                                    "train.master_dtype=bfloat16"]
    cfg, jcfg = _configs(more)
    params = JaxBaseModel(jcfg.model, num_classes=CLASSES).init(
        jax.random.key(3))
    sd = W.state_dict_from_jax(
        Runner.from_config(cfg, CLASSES, device="cpu").model,
        jax.tree.map(np.asarray, params))
    runner = Runner.from_config(cfg, CLASSES, device="cpu", weights=sd)
    assert runner.masters[0].dtype == torch.bfloat16
    assert runner.compute is runner.masters and runner.net is runner.model
    names = {id(p): n for n, p in runner.model.named_parameters()}
    seen = {}
    real_step = runner.optimizer.step

    def spy(lr_factor, grads, gen=None):
        pairs = [(names[id(p)], p, g) for p, g in
                 zip(runner.optimizer.params, grads) if g is not None]
        seen.update(lr_factor=lr_factor,
                    grads={k: g.clone() for k, _, g in pairs},
                    before={k: p.detach().clone() for k, p, _ in pairs})
        assert gen is runner.sr_gen
        return real_step(lr_factor, grads, gen)

    runner.optimizer.step = spy
    batch = D.make_batches(cfg, CLASSES, BATCH, 1, 3, [7])[0]
    lr = float(cfg.opt.lr)
    got, _ = runner.train_step(batch, lr, lr)
    # JAX's optimizer on those gradients and bf16 weights
    groups = O.build_groups(list(runner.model.named_parameters()),
                            cfg.opt.lr_wd, cfg.opt.lr, cfg.opt.wd)
    before = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              for k, v in seen["before"].items()}
    jgroups = {k: JO.GroupSpec(groups[k].lr, groups[k].wd, False)
               for k in before}
    jopt = jax_instantiate(jcfg.opt.optimizer)
    assert jopt.nesterov
    _, upd = jopt.update(jopt.init(before, jgroups),
                         {k: jnp.asarray(v.numpy())
                          for k, v in seen["grads"].items()},
                         before, jgroups, jnp.float32(seen["lr_factor"]))
    after = dict(runner.model.named_parameters())
    up = total = 0
    for k, u in upd.items():
        want32 = np.asarray(before[k].astype(jnp.float32) + u, np.float32)
        bits = after[k].detach().view(torch.int16).numpy().astype(
            np.int32) << 16
        ok = (_neighbours(want32) == bits[None]).any(axis=0)
        assert ok.all(), (k, int((~ok).sum()))
        nearest = np.asarray(jnp.asarray(want32).astype(jnp.bfloat16)
                             .astype(jnp.float32)).view(np.int32)
        up += int((bits != nearest).sum())
        total += bits.size
    assert 0 < up < total
    # the JAX bf16-master runner's losses from the same weights
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    jrunner, opt_state = _jax_runner(jcfg, jparams,
                                     compute_dtype=jnp.bfloat16,
                                     master_dtype=jnp.bfloat16)
    _, _, want, _, _ = jrunner.train_step(jparams, opt_state, batch, lr, lr,
                                          jax.random.key(0))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-2,
                                   atol=1e-3, err_msg=k)


def test_bf16_masters_need_bf16_compute():
    cfg, _ = _configs(["train.master_dtype=bfloat16"])
    with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
        Runner.from_config(cfg, CLASSES, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
        Runner.from_config(cfg, CLASSES, device="cpu",
                           compute_dtype="float32")
    assert Runner.from_config(cfg, CLASSES, device="cpu",
                              compute_dtype="bfloat16").sr_gen is not None


# -- resume across the options ------------------------------------------------

@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory whose ``tests`` is the repo's (the expt resolves
    its data under ``${cwd}``); the loop's SIGTERM handler is undone."""
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    yield tmp_path
    signal.signal(signal.SIGTERM, handler)


BF16_MASTERS = ["model.compute_dtype=bfloat16", "train.master_dtype=bfloat16"]


@pytest.mark.parametrize("first, then", [
    (BF16_MASTERS + ["train.grad_accum=2"], ["model.compute_dtype=bfloat16"]),
    ([], BF16_MASTERS + ["opt.optimizer.state_dtype=bfloat16"])],
    ids=["bf16_masters_resumed_at_fp32", "fp32_resumed_under_bf16_masters"])
def test_launcher_resume_reconciles_the_master_dtype(workdir, first, then):
    """tests/test_checkpoint.py test_resume_reconciles_master_dtype for the
    port's launcher, both ways: an epoch under ``first``, the next resumed
    under ``then``; each checkpoint holds the weights and state in its own
    run's dtype (the resume casts them), and ``-m test`` loads the
    result."""
    base = ["--device", "cpu", "use_wandb=false", "workers=1"]
    RUN.main(["-c", SMOKE_TRAIN, "-m", "train", *base, "train.num_epochs=1",
              *first])
    ckpts = workdir / "checkpoints" / \
        "CMFPEarly_ModalTokenCMFuser_rgb_flow_synth-smoke"
    one = CK.load_checkpoint(ckpts / "checkpoint_last")
    dtype_one = torch.bfloat16 if "train.master_dtype=bfloat16" in first \
        else torch.float32
    assert {v.dtype for v in one["model"].values()
            if v.is_floating_point()} == {dtype_one}
    RUN.main(["-c", SMOKE_TRAIN, "-m", "train", *base, "train.num_epochs=2",
              "train.resume=true", *then])
    two = CK.load_checkpoint(ckpts / "checkpoint_last")
    dtype_two = torch.bfloat16 if "train.master_dtype=bfloat16" in then \
        else torch.float32
    assert two["epoch"] == 2
    assert {v.dtype for v in two["model"].values()
            if v.is_floating_point()} == {dtype_two}
    moms = [st["momentum_buffer"] for st in two["optimizer"]["state"]
            .values()]
    assert moms and {m.dtype for m in moms} == {dtype_two}
    assert set(two["model"]) == set(one["model"])
    RUN.main(["-c", os.path.join(REPO, "expts", "99_synth_smoke_val.txt"),
              "-m", "test", *base, "save_name=null"])


def test_a_checkpoint_in_the_torch_optim_layout_resumes(tmp_path):
    """A checkpoint whose optimizer state is torch.optim.SGD's (the layout
    of the port's checkpoints before it had its own step) resumes: the
    step after it equals the step of the run that wrote it."""
    cfg, _ = _configs(NO_DROPOUT)
    batches = D.make_batches(cfg, CLASSES, BATCH, 2, 6, [7])
    lr = float(cfg.opt.lr)
    runner = Runner.from_config(cfg, CLASSES, device="cpu")
    runner.train_step({**batches[0], "mixup_lam": 0.4}, lr, lr)
    # the same state as torch.optim.SGD writes it
    groups = [{"params": list(g["params"]), "lr": g["lr"],
               "base_lr": g["base_lr"], "weight_decay": g["weight_decay"]}
              for g in runner.optimizer.param_groups]
    topt = torch.optim.SGD(groups, momentum=0.9, nesterov=True)
    mine = runner.optimizer.state_dict()["state"]
    for i, p in enumerate(runner.optimizer.params):
        topt.state[p]["momentum_buffer"] = \
            mine[i]["momentum_buffer"].clone()
    CK.save_checkpoint(tmp_path / "ck", runner.model.state_dict(),
                       topt.state_dict(), 1, 1, 0.0,
                       rng_state=runner.rng_state())
    assert "foreach" in CK.load_checkpoint(tmp_path / "ck")[
        "optimizer"]["param_groups"][0]
    other = Runner.from_config(cfg, CLASSES, device="cpu")
    ckpt = CK.load_checkpoint(tmp_path / "ck")
    other.load_model_state(ckpt["model"])
    other.optimizer.load_state_dict(ckpt["optimizer"])
    other.load_rng_state(ckpt["rng"])
    want, _ = runner.train_step({**batches[1], "mixup_lam": 0.6}, lr, lr)
    got, _ = other.train_step({**batches[1], "mixup_lam": 0.6}, lr, lr)
    for k, v in want.items():
        assert float(got[k]) == float(v), k
    for (k, a), b in zip(runner.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
