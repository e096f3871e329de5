"""The port's training loop, launcher and metric meters against the JAX
package's, on the CPU.

- ``afft_tpu_torch.train.loop.main`` against ``afft_tpu.train.loop.main`` on
  expts/99_synth_smoke_train.txt (tests/fixtures/synth) for two epochs from
  the same weights (one reference-layout ``.pth`` through
  ``init_from_model`` in both), every dropout rate 0 and mixup off (the two
  packages draw different random streams): the loss and lr of every
  iteration at rtol 1e-4, and the validation metrics at 1e-4;
- the metric meters and ranking metrics against afft_tpu.train.metrics on
  random scores (fp32, 1e-6), and the runner's device accumulator against
  the host meters;
- the loop's guards: a finished experiment is not rerun without
  ``train.resume`` / ``+overwrite``; the launcher starts ``-n 2`` through
  torchrun and ``-m test`` as the eval CLI, and a process count without a
  rendezvous raises;
- an epoch's clips/s counts its valid clips over its whole window;
- the port's accept-set generator writes files byte-identical to
  tools/make_accept_dataset.py's.
"""

import filecmp
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.train import loop as JLOOP
from afft_tpu.train import metrics as JM
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import run as RUN
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.train import loop as PLOOP
from afft_tpu_torch.train import metrics as PM
from afft_tpu_torch.train.runner import MetricAccum, Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory whose ``tests`` is the repo's (the expt resolves
    its data under ``${cwd}``); the loops' SIGTERM handlers are undone."""
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    yield tmp_path
    signal.signal(signal.SIGTERM, handler)


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_loop_matches_the_jax_loop_on_the_smoke_expt(workdir, monkeypatch):
    overrides = read_expt_file(SMOKE_TRAIN) + NO_DROPOUT + [
        "train.use_mixup=false", "init_from_model=init.pth",
        "use_wandb=false", "workers=2"]
    cfg = compose(CONF_DIR, overrides + ["experiment_name=port"])
    dataset = PLOOP.build_dataloaders(cfg)[0]
    classes = {k: len(v) for k, v in dataset.classes.items()}
    init = Runner.from_config(cfg, classes, device="cpu",
                              class_mappings=dataset.class_mappings)
    (workdir / "checkpoints").mkdir()
    torch.save({"model": init.model.state_dict()},
               workdir / "checkpoints" / "init.pth")

    steps = {"port": [], "jax": []}
    port_step, jax_step = Runner.train_step, JaxRunner.train_step

    def record_port(self, batch, lr, base_lr, **kw):
        out = port_step(self, batch, lr, base_lr, **kw)
        steps["port"].append((float(out[0]["total_loss"]), lr))
        return out

    def record_jax(self, params, opt_state, batch, lr, base_lr, key, **kw):
        out = jax_step(self, params, opt_state, batch, lr, base_lr, key, **kw)
        steps["jax"].append((float(out[2]["total_loss"]), lr))
        return out

    monkeypatch.setattr(Runner, "train_step", record_port)
    monkeypatch.setattr(JaxRunner, "train_step", record_jax)
    best = PLOOP.main(cfg, device="cpu", interactive=False)
    # the JAX loop's batch sizes are per device (the tests' CPU mesh has
    # several): the same global batches of 8
    per_device = 8 // jax.local_device_count()
    jax_best = JLOOP.main(jax_compose(
        os.path.join(REPO, "afft_tpu", "conf"),
        overrides + ["experiment_name=jax",
                     f"train.batch_size={per_device}",
                     f"eval.batch_size={per_device}"]), interactive=False)
    got, want = np.array(steps["port"]), np.array(steps["jax"])
    assert got.shape == want.shape == (16, 2)     # 2 epochs of 8 batches
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)
    np.testing.assert_allclose(best, jax_best, rtol=1e-4)
    ckpts = workdir / "checkpoints"
    port_log = _metrics(next(ckpts.glob("*_port")) / "metrics.jsonl")
    jax_log = _metrics(next(ckpts.glob("*_jax")) / "metrics.jsonl")
    assert len(port_log) == len(jax_log) == 2
    for p, j in zip(port_log, jax_log):
        keys = [k for k in j if k.startswith(("val_", "train_"))
                and " " not in k]
        assert keys and set(keys) <= set(p)
        for k in keys:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        assert p["ms_per_iter"] > 0 and p["iters"] == 8
    for name in ("checkpoint_best", "checkpoint_last"):
        assert (next(ckpts.glob("*_port")) / name).is_file()


def test_a_finished_experiment_needs_resume_or_overwrite(workdir):
    overrides = read_expt_file(SMOKE_TRAIN) + [
        "use_wandb=false", "train.num_epochs=1", "workers=1"]
    PLOOP.main(compose(CONF_DIR, overrides), device="cpu", interactive=False)
    with pytest.raises(ValueError, match="already done"):
        PLOOP.main(compose(CONF_DIR, overrides), device="cpu",
                   interactive=False)
    PLOOP.main(compose(CONF_DIR, overrides + ["+overwrite=true"]),
               device="cpu", interactive=False)


def test_more_than_one_process_and_test_mode_raise(workdir, monkeypatch):
    """Data parallelism and the eval CLI are ported: ``-n 2`` starts two
    processes through torchrun, ``-m test`` runs the eval CLI. What still
    raises is a process count without a rendezvous to join."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        PLOOP.main(compose(CONF_DIR, read_expt_file(SMOKE_TRAIN)),
                   device="cpu", interactive=False)
    monkeypatch.delenv("WORLD_SIZE")
    calls = []
    monkeypatch.setattr(RUN.subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    assert RUN.main(["-c", SMOKE_TRAIN, "-m", "train", "-n", "2",
                     "--device", "cpu", "workers=1"]) == 0
    (cmd,) = calls
    assert cmd[1:6] == ["-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=2", "-m"]
    assert cmd[6:9] == ["afft_tpu_torch.train", "--device", "cpu"]
    assert cmd[9:] == read_expt_file(SMOKE_TRAIN) + ["workers=1"]
    import afft_tpu_torch.eval.__main__ as EVAL_MAIN
    monkeypatch.setattr(EVAL_MAIN, "main", lambda argv: ("eval", argv))
    assert RUN.main(["-c", SMOKE_TRAIN, "-m", "test", "--device", "cpu"]) \
        == ("eval", ["--device", "cpu"] + read_expt_file(SMOKE_TRAIN))


class _SleepyEvalRunner:
    """What run_one_epoch needs of a runner, on the CPU: each eval step
    takes 5 ms of host time."""
    device = torch.device("cpu")

    def new_accum(self):
        return None

    def eval_step(self, batch, accum=None):
        import time
        time.sleep(0.005)

    def absorb_accum(self, tracker, accum, is_training):
        pass


def test_epoch_rate_counts_valid_clips_over_the_epoch_window():
    """clips_per_s is the epoch's valid clips (padding excluded) over the
    epoch's whole window, not a rate from the median iteration."""
    batches = [{"valid": np.array([1, 1, 1, 1], bool)},
               {"valid": np.array([1, 1, 0, 0], bool)},
               {"valid": np.array([1, 0, 0, 0], bool)}]
    _, timing = PLOOP.run_one_epoch(_SleepyEvalRunner(), batches,
                                    PM.MetricTracker({"action": 3}),
                                    is_training=False)
    assert timing["iters"] == 3
    assert timing["window_ms"] >= 3 * 5.0
    assert timing["clips_per_s"] == pytest.approx(
        7 / timing["window_ms"] * 1e3)


def _random_scores(seed, n=64, c=11):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((n, c)).astype(np.float32)
    labels = rng.integers(0, c, n)
    return scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_metrics_equal_the_jax_package(seed):
    scores, labels = _random_scores(seed)
    np.testing.assert_allclose(
        PM.topk_accuracy(scores, labels, (1, 5)),
        JM.topk_accuracy(scores, labels, (1, 5)), rtol=1e-6)
    np.testing.assert_allclose(PM.topk_recall(scores, labels, 5),
                               JM.topk_recall(scores, labels, 5), rtol=1e-6)
    np.testing.assert_allclose(PM.accuracy(scores, labels, (1, 3)),
                               JM.accuracy(scores, labels, (1, 3)),
                               rtol=1e-6)


def _payload(scores, labels, valid):
    top5 = torch.from_numpy(scores).topk(5, dim=-1).indices
    return {"top5": top5, "labels": torch.from_numpy(labels),
            "valid": torch.from_numpy(valid)}


def test_meters_and_tracker_equal_the_jax_package():
    """AverageMeter, MeanTopKRecallMeter (host logits and device top-5
    payloads) and MetricTracker over three batches of random scores."""
    trackers = {"port": PM.MetricTracker({"action": 11}),
                "jax": JM.MetricTracker({"action": 11})}
    for seed in range(3):
        scores, labels = _random_scores(seed, n=16)
        valid = np.arange(16) < 13 + seed
        for name, tracker in trackers.items():
            tracker.update({"loss": float(seed) + 0.5,
                            "mt5r_action_host": {"logits": scores,
                                                 "labels": labels,
                                                 "valid": valid}}, 13,
                           is_training=True)
        trackers["port"].update(
            {"mt5r_action_dev": _payload(scores, labels, valid)}, 13, False)
        trackers["jax"].update(
            {"mt5r_action_dev": {"logits": scores, "labels": labels,
                                 "valid": valid}}, 13, False)
    for training in (True, False):
        got = trackers["port"].get_all_data(training)
        want = trackers["jax"].get_all_data(training)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_runner_accumulator_equals_the_host_meters():
    """MetricAccum's on-device sums, absorbed once, equal the meters fed
    batch by batch: valid-weighted scalar means and per-class MT5R."""
    accum = MetricAccum({"action": 11})
    tracker = PM.MetricTracker({"action": 11})
    host = JM.MetricTracker({"action": 11})
    for seed in range(3):
        scores, labels = _random_scores(seed, n=16)
        valid = np.arange(16) < 10 + 2 * seed
        n = int(valid.sum())
        loss = torch.tensor(0.25 * seed + 1.0)
        accum.add({"total_loss": loss},
                  {"mt5r_action_all-fused": _payload(scores, labels, valid)},
                  torch.from_numpy(valid))
        host.update({"total_loss": float(loss),
                     "mt5r_action_all-fused": {"logits": scores,
                                               "labels": labels,
                                               "valid": valid}}, n, True)
    Runner.absorb_accum(tracker, accum, is_training=True)
    got, want = tracker.get_all_data(True), host.get_all_data(True)
    assert set(got) == set(want) == {"train_total_loss",
                                     "train_mt5r_action_all-fused"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_accept_generator_is_byte_identical_to_the_jax_tool(tmp_path,
                                                            monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_accept_dataset as jax_tool
    finally:
        sys.path.pop(0)
    from afft_tpu_torch.tools import make_accept_dataset as port_tool
    monkeypatch.setattr(jax_tool, "CLIPS_PER_VIDEO", 6)
    monkeypatch.setattr(port_tool, "CLIPS_PER_VIDEO", 6)
    jax_tool.make_accept_dataset(tmp_path / "jax", 2, 1)
    port_tool.main([str(tmp_path / "port"), "--train-videos", "2",
                    "--val-videos", "1"])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 16  # 4 csv + done + 4 stores x 3 files
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for rel in files:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel,
                           shallow=False), rel
