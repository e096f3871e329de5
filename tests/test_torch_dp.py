"""Data parallelism of the port on the CPU: two gloo processes against one.

Each spawned run goes through ``python -m torch.distributed.run
--standalone`` (its rendezvous on a port the OS gives it, never a fixed
one: xdist runs test files side by side) with a timeout of its own. The
two-process jobs are ``afft_tpu_torch.tools.dp_check``'s; the one-process
references run in this process, which has no process group.

- (a) sharded eval: each rank forwards its strided, wrap-padded shard of the
  synthetic val set; ``collect_logits`` merges the shards into exactly the
  one-process logits, in dataset order.
- (b) expt 99 with its dropout, drop-path and mixup (rates 0.1, λ drawn):
  one global batch sequence of 2·b rows, split into contiguous halves, one
  padded row on rank 1 only; after 4 ``train_step``s on 2 ranks the losses
  are within 1e-5 relative and the parameters within 1e-5 of max|p| of the
  same 4 steps on one process at 2·b.
- (c) as (b) with every dropout rate 0 and the mixup λ pinned: the
  2-process steps equal the JAX runner's at 2·b (the tolerances of
  tests/test_torch_train_slice.py). (zc) and (zcb) are (c) under ZeRO-1,
  with fp32 and with bf16 optimizer state, against the JAX runner under
  its ``train.zero_sharding`` (``shard_opt_state`` on a 2-device mesh,
  the weights pinned replicated, as afft_tpu/train/loop.py places them) and
  the same ``state_dtype``, at the same tolerances.
- (d) the metric meters after ``synchronize_between_processes`` equal one
  tracker fed both ranks' updates; only rank 0 writes checkpoint files.
- (f) as (b) for the T-SA-Fuser and for ``CMFPScoreFusion`` with MATT
  (its dropout 0.8), at the smoke expt's widths: the losses of 4 steps on 2
  ranks within 1e-5 relative of one process over the same global batches
  (the global-batch rule for their dropouts and drop-path).
- (e) ``python -m afft_tpu_torch.run -c expts/99_synth_smoke_train.txt -m
  train -n 2 --device cpu`` for one epoch exits 0 with one writer of
  metrics.jsonl, and ``-m test -n 2`` exports the logits of one process.
- (g) as (b) at ``train.grad_accum=2``, with a ragged ``valid`` in which one
  rank's chunk has no valid row: the 2-process steps equal one process at
  ``grad_accum=2`` over the same global batches ordered microbatch-major
  (``dp_check.microbatch_major``), at (b)'s bound.
- (z) ZeRO-1 (``train.zero_sharding=true``) on 2 processes against plain
  data parallelism, as (b), with fp32 and with bf16 optimizer state, and
  at ``grad_accum=2`` against (g): losses
  and weights at (b)'s bound, each rank holding half the state; its
  checkpoint after 2 steps, resumed in one process for the other 2, lands
  where the 2 processes did.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from afft_tpu.parallel.sharding import shard_opt_state
from afft_tpu.train import optim as JO
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import run as RUN
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import (CONF_DIR, compose, expt_lines_without,
                                   read_expt_file)
from afft_tpu_torch.eval import challenge as PC
from afft_tpu_torch.tools import dp_check as D
from afft_tpu_torch.train import optim as O
from afft_tpu_torch.train.metrics import MetricTracker
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
SMOKE_VAL = os.path.join(REPO, "expts", "99_synth_smoke_val.txt")
CLASSES = {"action": 106, "verb": 19, "noun": 51}  # the synthetic set's
RATES = ["model.fuser.embd_drop_rate=0.1", "model.fuser.drop_rate=0.1",
         "model.fuser.attn_drop_rate=0.1", "model.fuser.drop_path_rate=0.1",
         "model.common.embd_pdrop=0.1", "model.common.resid_pdrop=0.1",
         "model.common.attn_pdrop=0.1"]
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
BF16_STATE = "opt.optimizer.state_dtype=bfloat16"
ZERO = "train.zero_sharding=true"
# the jobs held against the JAX runner: (c), and (c) under ZeRO-1
JAX_HELD = {"c": [], "zc": [ZERO], "zcb": [ZERO, BF16_STATE]}
GLOBAL_BATCH, STEPS = 8, 4
LAMS = [0.3, 0.45, 0.6, 0.75]
RUN_TIMEOUT = 300  # seconds a spawned run may take


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "2",
            "PYTHONPATH": os.pathsep.join(
                p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}


def _spawn(cmd, cwd, log_name):
    """Run ``cmd`` in ``cwd`` with its own timeout; its output goes to
    ``cwd/log_name``, whose tail a failure shows."""
    log = os.path.join(cwd, log_name)
    with open(log, "w") as out:
        proc = subprocess.run(cmd, cwd=cwd, env=_env(), stdout=out,
                              stderr=subprocess.STDOUT, timeout=RUN_TIMEOUT)
    with open(log) as f:
        tail = f.read()[-4000:]
    assert proc.returncode == 0, tail
    return tail


def _torchrun(nproc, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", *args]


def _lrs(overrides, expt=SMOKE_TRAIN):
    cfg = compose(CONF_DIR, read_expt_file(expt) + overrides)
    sched = O.build_schedule(cfg.opt, 2, 1)
    return [sched(i, float(cfg.opt.lr)) for i in range(STEPS)]


def _train_job(name, overrides, expt=SMOKE_TRAIN, **more):
    return {"kind": "train", "name": name, "expt": expt,
            "overrides": overrides, "classes": CLASSES,
            "batch": GLOBAL_BATCH, "steps": STEPS, "seed": 3,
            "lrs": _lrs(overrides, expt), "invalid": [GLOBAL_BATCH - 1],
            **more}


# (f): the smoke expt with another fuser / CMFP, the fuser lines that the
# choice does not take left out, and the rates on
VARIANTS = {
    "tsa": (["model/fuser=T-SA-Fuser"], (), RATES),
    "matt": (["model/fuser=MATT", "model/CMFP=scorefusion",
              "model.common.fusion_cls=false",
              "model.common.share_predictors=false",
              "model.common.share_classifiers=false"], ("model.fuser.",),
             [r for r in RATES if not r.startswith("model.fuser.")]
             + ["model.fuser.drop_rate=0.8", "model.dropout=0.2"]),
}


def _variant_job(work, variant):
    choices, dropped, rates = VARIANTS[variant]
    expt = work / f"variant_{variant}.txt"
    expt.write_text("\n".join(
        expt_lines_without(SMOKE_TRAIN, dropped) + choices) + "\n")
    return _train_job(f"f_{variant}", rates, expt=str(expt))


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX params for (c) and the port state dict carrying them."""
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"),
                       read_expt_file(SMOKE_TRAIN) + NO_DROPOUT)
    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    params = jmodel.init(jax.random.key(11))
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + NO_DROPOUT)
    model = Runner.from_config(tcfg, CLASSES, device="cpu").model
    path = tmp_path_factory.mktemp("init") / "init.pt"
    torch.save(W.state_dict_from_jax(model, jax.tree.map(np.asarray,
                                                         params)), path)
    return jcfg, jmodel, params, str(path)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_init):
    """The dp_check jobs (a)-(d) on two gloo processes; {job: [rank 0's
    record, rank 1's]}, and the jobs."""
    work = tmp_path_factory.mktemp("dp")
    (work / "tests").symlink_to(os.path.join(REPO, "tests"))
    jobs = [
        {"kind": "eval", "name": "a", "expt": SMOKE_VAL,
         "overrides": ["save_name=null"], "batch": 3, "seed": 0},
        _train_job("b", RATES),
        *(_train_job(name, NO_DROPOUT + more, weights=jax_init[3], lam=LAMS)
          for name, more in JAX_HELD.items()),
        {"kind": "meters", "name": "d", "classes": {"action": 11},
         "ckpt_dir": str(work / "ckpt")},
        _train_job("g", RATES + ["train.grad_accum=2"], invalid=[2, 3, 7]),
        _train_job("z", RATES + ["train.zero_sharding=true"],
                   save={"path": str(work / "zero.ckpt"), "after": 2}),
        _train_job("zb", RATES + ["train.zero_sharding=true", BF16_STATE]),
        _train_job("pb", RATES + [BF16_STATE]),
        _train_job("zg", RATES + ["train.zero_sharding=true",
                                  "train.grad_accum=2"], invalid=[2, 3, 7]),
        *(_variant_job(work, v) for v in sorted(VARIANTS))]
    spec = {"device": "cpu", "out": str(work / "out"), "jobs": jobs}
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)
    _spawn(_torchrun(2, "-m", "afft_tpu_torch.tools.dp_check",
                     str(work / "spec.json")), str(work), "dp_check.log")
    records = {job["name"]: [torch.load(work / "out" / f"{job['name']}"
                                        f".rank{r}.pt", weights_only=False)
                             for r in (0, 1)] for job in jobs}
    return records, {job["name"]: job for job in jobs}, work


def test_sharded_eval_merges_to_the_one_process_logits(two_ranks):
    records = two_ranks[0]["a"]
    for rec in records:
        np.testing.assert_array_equal(rec["merged_idx"], rec["whole_idx"])
        np.testing.assert_array_equal(rec["merged"], rec["whole"])
    assert len(records[0]["merged"]) == 16
    np.testing.assert_array_equal(records[0]["merged"], records[1]["merged"])


def test_two_ranks_equal_one_process_with_dropout_and_mixup(two_ranks):
    records, jobs, _ = two_ranks
    rank0, rank1 = records["b"]
    assert rank0["world"] == 2 and rank0["losses"] == rank1["losses"]
    one = D.run_train(jobs["b"], torch.device("cpu"))
    assert one["world"] == 1
    for i, (got, want) in enumerate(zip(rank0["losses"], one["losses"])):
        assert set(got) == set(want) and "total_loss" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
    # the steps moved the weights, and both runs alike
    scale = max(float(v.abs().max()) for v in one["state"].values())
    for k, v in one["state"].items():
        np.testing.assert_allclose(rank0["state"][k].numpy(), v.numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=k)
    # the rates acted: without them the first step's loss differs
    plain = D.run_train({**jobs["b"], "overrides": NO_DROPOUT, "steps": 1},
                        torch.device("cpu"))
    assert plain["losses"][0]["total_loss"] != \
        one["losses"][0]["total_loss"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_two_ranks_equal_one_process_with_dropout(two_ranks,
                                                          variant):
    records, jobs, _ = two_ranks
    job = jobs[f"f_{variant}"]
    rank0, rank1 = records[job["name"]]
    assert rank0["world"] == 2 and rank0["losses"] == rank1["losses"]
    one = D.run_train({**job, "keep_state": False}, torch.device("cpu"))
    assert one["world"] == 1
    for i, (got, want) in enumerate(zip(rank0["losses"], one["losses"])):
        assert set(got) == set(want) and "total_loss" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
    # the rates acted: without them the first step's loss differs
    zero = [r.split("=")[0] + "=0.0" for r in job["overrides"]]
    plain = D.run_train({**job, "overrides": zero, "steps": 1,
                         "keep_state": False}, torch.device("cpu"))
    assert plain["losses"][0]["total_loss"] != \
        one["losses"][0]["total_loss"]


@pytest.mark.parametrize("name", list(JAX_HELD),
                         ids=["plain_dp", "zero1", "zero1_bf16_state"])
def test_two_ranks_equal_the_jax_runner_with_randomness_pinned(two_ranks,
                                                               jax_init,
                                                               name):
    records, jobs, _ = two_ranks
    rank0 = records[name][0]
    _, jmodel, params, _ = jax_init
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"),
                       read_expt_file(SMOKE_TRAIN) + jobs[name]["overrides"])
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    opt_state = joptimizer.init(params, groups)
    if ZERO in jobs[name]["overrides"]:
        assert bool(jcfg.train.zero_sharding)
        if BF16_STATE in jobs[name]["overrides"]:
            assert {x.dtype for x in jax.tree.leaves(opt_state["momentum"])
                    } == {jnp.dtype(jnp.bfloat16)}
    jrunner = JaxRunner(
        jmodel, joptimizer, groups,
        loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False)
    zmesh = None
    if jcfg.train.zero_sharding:
        # ZeRO-1 as the JAX loop runs it, over two devices
        zmesh = make_mesh(jax.devices()[:2])
        params = replicate_tree(zmesh, params)
        opt_state = shard_opt_state(zmesh, opt_state)
        repl = NamedSharding(zmesh, PartitionSpec())
        jrunner.param_shardings = jax.tree.map(lambda _: repl, params)
        assert any(m.addressable_shards[0].data.shape != m.shape
                   for m in jax.tree.leaves(opt_state["momentum"]))
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + NO_DROPOUT)
    batches = D.make_batches(tcfg, CLASSES, GLOBAL_BATCH, STEPS, 3,
                             [GLOBAL_BATCH - 1])
    for i, batch in enumerate(batches):
        if zmesh is not None:
            batch = shard_batch(zmesh, {k: v for k, v in batch.items()
                                        if v is not None})
        jbatch = {**batch, "mixup_lam": jnp.asarray(LAMS[i], jnp.float32)}
        params, opt_state, losses, _, _ = jrunner.train_step(
            params, opt_state, jbatch, jobs[name]["lrs"][i], jcfg.opt.lr,
            jax.random.key(i))
        got = rank0["losses"][i]
        assert set(got) == set(losses)
        for k, v in losses.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    model = Runner.from_config(tcfg, CLASSES, device="cpu").model
    want = W.state_dict_from_jax(model, jax.tree.map(np.asarray, params))
    for k, v in want.items():
        np.testing.assert_allclose(rank0["state"][k].numpy(), v.numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def _assert_runs_agree(got, want, what):
    """Losses within 1e-5 relative and the final weights within 1e-5 of
    max|p|: (b)'s bound."""
    assert len(got["losses"]) == len(want["losses"]) > 0
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert set(a) == set(b) and "total_loss" in a
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=0,
                                       err_msg=f"{what}: step {i} {k}")
    scale = max(float(v.abs().max()) for v in want["state"].values())
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].float().numpy(),
                                   v.float().numpy(), atol=1e-5 * scale,
                                   rtol=0, err_msg=f"{what}: {k}")


def test_two_ranks_at_grad_accum_equal_one_process_in_microbatch_order(
        two_ranks):
    records, jobs, _ = two_ranks
    rank0, rank1 = records["g"]
    assert rank0["world"] == 2 and rank0["losses"] == rank1["losses"]
    one = D.run_train({**jobs["g"], "order": 2}, torch.device("cpu"))
    assert one["world"] == 1
    _assert_runs_agree(rank0, one, "grad_accum=2")
    # in rank order (not microbatch-major) the one process takes other
    # microbatches, and other steps
    other = D.run_train({**jobs["g"], "steps": 1}, torch.device("cpu"))
    assert other["losses"][0]["total_loss"] != one["losses"][0]["total_loss"]


@pytest.mark.parametrize("zero, plain", [("z", "b"), ("zb", "pb"),
                                         ("zg", "g"), ("zc", "c")],
                         ids=["fp32_state", "bf16_state", "grad_accum",
                              "pinned"])
def test_zero1_equals_plain_data_parallelism(two_ranks, zero, plain):
    records = two_ranks[0]
    z0, z1 = records[zero]
    p0, p1 = records[plain]
    assert z0["world"] == 2 and z0["losses"] == z1["losses"]
    _assert_runs_agree(z0, p0, f"ZeRO-1 {zero}")
    # the state is split between the ranks: each holds about half (a
    # bucket's slice is rounded up to whole elements), together all of it
    assert p0["state_bytes"] == p1["state_bytes"] > 0
    assert z0["state_bytes"] + z1["state_bytes"] == p0["state_bytes"]
    for rec in (z0, z1):
        assert abs(rec["state_bytes"] - p0["state_bytes"] / 2) <= 16


def test_zero1_checkpoint_resumes_in_one_process(two_ranks):
    records, jobs, work = two_ranks
    ckpt = torch.load(work / "zero.ckpt", weights_only=False)
    # the optimizer state was gathered into whole tensors, one a parameter
    params = Runner.from_config(compose(CONF_DIR, read_expt_file(
        SMOKE_TRAIN) + RATES), CLASSES, device="cpu").optimizer.params
    state = ckpt["optimizer"]["state"]
    assert sorted(state) == list(range(len(params)))
    for i, p in enumerate(params):
        mom = state[i]["momentum_buffer"]
        assert mom.dtype == torch.float32 and mom.shape == p.shape, i
    job = {k: v for k, v in jobs["z"].items() if k != "save"}
    one = D.run_train({**job, "overrides": RATES,
                       "resume": {"path": str(work / "zero.ckpt"),
                                  "after": 2}}, torch.device("cpu"))
    z0 = records["z"][0]
    _assert_runs_agree(one, {**z0, "losses": z0["losses"][2:]},
                       "ZeRO-1 checkpoint resumed in one process")


def test_synchronized_meters_and_one_checkpoint_writer(two_ranks):
    records, jobs, work = two_ranks
    tracker = MetricTracker({"action": 11})
    for rank in (0, 1):
        averages, mt5r = D.meter_updates(rank, {"action": 11})
        for name, value, n in averages:
            tracker.update({name: value}, n, True)
        for name, scores, labels in mt5r:
            tracker.update({name: {"logits": scores, "labels": labels}}, 1,
                           True)
    want = tracker.get_all_data(True)
    for rec in records["d"]:
        assert rec["world"] == 2 and set(rec["values"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(rec["values"][k], v, rtol=1e-12,
                                       err_msg=k)
    assert sorted(os.listdir(work / "ckpt")) == ["from_rank0", "shared"]
    ck = torch.load(work / "ckpt" / "shared", weights_only=False)
    assert torch.equal(ck["model"]["w"], torch.zeros(3))


def test_launcher_trains_and_evaluates_on_two_processes(tmp_path,
                                                       monkeypatch):
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    run = [sys.executable, "-m", "afft_tpu_torch.run", "--device", "cpu",
           "workers=2", "use_wandb=false"]
    _spawn(run + ["-c", SMOKE_TRAIN, "-m", "train", "-n", "2",
                  "train.num_epochs=1"], str(tmp_path), "train.log")
    ckpt = tmp_path / "checkpoints" / \
        "CMFPEarly_ModalTokenCMFuser_rgb_flow_synth-smoke"
    assert {"checkpoint_best", "checkpoint_last"} <= set(os.listdir(ckpt))
    with open(ckpt / "metrics.jsonl") as f:
        assert len(f.readlines()) == 1  # one epoch, one writer
    with open(ckpt / "summary.jsonl") as f:
        summary = [json.loads(line) for line in f]
    assert summary[-1]["run"]["world_size"] == 2
    # the sharded eval CLI exports the logits of one process
    logits_dir = tmp_path / "logits" / ckpt.name
    _spawn(run + ["-c", SMOKE_VAL, "-m", "test", "-n", "2",
                  "save_name=two.h5"], str(tmp_path), "eval2.log")
    RUN.main(["-c", SMOKE_VAL, "-m", "test", "--device", "cpu", "workers=2",
              "save_name=one.h5"])
    (two,) = PC.gen_load_resfiles(str(logits_dir), "two")
    (one,) = PC.gen_load_resfiles(str(logits_dir), "one")
    np.testing.assert_array_equal(two["logits/action_all-fused"],
                                  one["logits/action_all-fused"])
    assert len(one["logits/action_all-fused"]) == 16
