"""The port's checkpoints (afft_tpu_torch.train.checkpoint) and resume, on
the CPU.

- a round trip gives identical logits; the file is what
  ``weights.load_reference_checkpoint`` and the JAX package's torch import
  read;
- writes are atomic: an overwrite leaves no temporary behind, a crash
  between the swap's renames is recovered from ``.old-tmp``;
- the async writer coalesces saves to one path (newest wins), and a failed
  write surfaces on ``wait``;
- one payload saved to several paths is written once, the others hard
  links that a later save replaces alone;
- ``init_from_model`` merges by name and shape with a prefix filter, from
  the port's checkpoints and from reference ``.pth`` files; a file of
  another layout version is refused;
- a run resumed from ``checkpoint_last`` equals an uninterrupted one bit
  for bit (expts/99_synth_smoke_train.txt with its dropout and mixup).
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train.torch_import import import_base_model
from afft_tpu_torch import serve
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.train import checkpoint as CK
from afft_tpu_torch.train import loop as PLOOP
from afft_tpu_torch.train.runner import Runner
from afft_tpu_torch.weights import load_reference_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
CLASSES = {"action": 7}


def _runner(seed=42):
    cfg = serve.load_config(SMOKE_TRAIN, [f"seed={seed}"])
    return cfg, Runner.from_config(cfg, CLASSES, device="cpu",
                                   iters_per_epoch=4)


def _batch(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    return {"data_dict": {m: rng.standard_normal((n, T, int(d))).astype(
                np.float32)
                for m, d in cfg.model.modal_dims.to_container().items()},
            "target": {"action": rng.integers(0, 7, (n,))},
            "target_subclips": {"action": rng.integers(0, 7, (n, T, 1))}}


def _save(path, runner, epoch=1, **kw):
    CK.save_checkpoint(path, runner.model.state_dict(),
                       runner.optimizer.state_dict(), epoch, 4 * epoch,
                       0.5, rng_state=runner.rng_state(), **kw)


def test_round_trip_gives_identical_logits(tmp_path):
    cfg, runner = _runner()
    batch = _batch(cfg)
    runner.train_step(batch, 0.01, 0.01)
    _save(tmp_path / "ck", runner, schedule_state={"scale": 0.1})
    want = runner.eval_step(batch)[2]
    _, other = _runner(seed=7)
    assert not torch.equal(other.eval_step(batch)[2], want)
    ckpt = CK.load_checkpoint(tmp_path / "ck")
    assert (ckpt["epoch"], ckpt["step"], ckpt["best_metric"],
            ckpt["schedule"]) == (1, 4, 0.5, {"scale": 0.1})
    other.load_model_state(ckpt["model"])
    other.optimizer.load_state_dict(ckpt["optimizer"])
    assert torch.equal(other.eval_step(batch)[2], want)
    # the same file serves --weights and the JAX package's torch import
    sd = load_reference_checkpoint(str(tmp_path / "ck"))
    assert set(sd) == set(runner.model.state_dict())
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                       read_expt_file(SMOKE_TRAIN))
    params = import_base_model(JaxBaseModel(jcfg.model, num_classes=CLASSES),
                               {k: v.numpy() for k, v in sd.items()})
    assert "future_predictor" in params
    # the next step is identical too: optimizer state and randomness
    # (dropout, drop-path, mixup) are restored
    other.load_rng_state(ckpt["rng"])
    runner.train_step(batch, 0.01, 0.01)
    other.train_step(batch, 0.01, 0.01)
    for (k, a), b in zip(runner.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_overwrite_is_atomic_and_old_tmp_is_recovered(tmp_path):
    cfg, runner = _runner()
    path = tmp_path / "ck"
    _save(path, runner, epoch=1)
    _save(path, runner, epoch=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]
    assert CK.load_checkpoint(path)["epoch"] == 2
    # a crash between the two renames: only <path>.old-tmp is left
    path.rename(tmp_path / "ck.old-tmp")
    (tmp_path / "ck.new-tmp").write_bytes(b"half a file")
    assert CK.load_checkpoint(path)["epoch"] == 2
    assert path.exists() and not (tmp_path / "ck.old-tmp").exists()
    _save(path, runner, epoch=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]
    # a file of another layout version is refused
    ckpt = torch.load(path, weights_only=False)
    ckpt["format_version"] = 99
    torch.save(ckpt, tmp_path / "other")
    with pytest.raises(ValueError, match="format_version 99"):
        CK.load_checkpoint(tmp_path / "other")


def test_async_saves_coalesce_and_errors_surface(tmp_path, monkeypatch):
    writes, gate = [], threading.Event()
    real = CK._write_and_swap

    def slow(path, payload, epoch):
        gate.wait(10)
        writes.append((path.name, epoch))
        real(path, payload, epoch)

    monkeypatch.setattr(CK, "_write_and_swap", slow)
    _, runner = _runner()
    for epoch in (1, 2, 3):
        _save(tmp_path / "a", runner, epoch=epoch, block=False)
    _save(tmp_path / "b", runner, epoch=4, block=False)
    gate.set()
    CK.wait_for_pending_saves()
    # the first save may have been taken before the others queued; the
    # newest payload of a path is the one that lands
    assert writes[-2:] == [("a", 3), ("b", 4)] and len(writes) <= 3
    assert CK.load_checkpoint(tmp_path / "a")["epoch"] == 3

    (tmp_path / "file").write_text("not a directory")
    _save(tmp_path / "file" / "ck", runner, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        CK.wait_for_pending_saves()
    CK.wait_for_pending_saves()  # the error is reported once


def test_one_payload_to_several_paths_is_written_once(tmp_path,
                                                      monkeypatch):
    """An epoch that is both the best and the last is written once: the
    other path is a hard link to it, which a later save of either path
    replaces without touching the other; queued saves that share a path
    leave each path with its newest payload."""
    _, runner = _runner()
    best, last = tmp_path / "best", tmp_path / "last"
    _save([best, last], runner, epoch=1)
    assert os.stat(best).st_ino == os.stat(last).st_ino
    _save(last, runner, epoch=2)
    assert os.stat(best).st_ino != os.stat(last).st_ino
    assert CK.load_checkpoint(best)["epoch"] == 1
    assert CK.load_checkpoint(last)["epoch"] == 2

    writes, gate = [], threading.Event()
    real = CK._write_and_swap

    def slow(path, payload, epoch):
        gate.wait(10)
        writes.append((path.name, epoch))
        real(path, payload, epoch)

    monkeypatch.setattr(CK, "_write_and_swap", slow)
    _save(tmp_path / "x", runner, epoch=0, block=False)
    _save([best, last], runner, epoch=3, block=False)
    _save(last, runner, epoch=4, block=False)
    _save(best, runner, epoch=5, block=False)
    gate.set()
    CK.wait_for_pending_saves()
    assert CK.load_checkpoint(best)["epoch"] == 5
    assert CK.load_checkpoint(last)["epoch"] == 4
    assert ("best", 3) not in writes and ("last", 3) not in writes


def test_init_from_model_filters_by_prefix(tmp_path):
    _, src = _runner(seed=1)
    _, dst = _runner(seed=2)
    _save(tmp_path / "ck", src)
    torch.save({"model": src.model.state_dict()}, tmp_path / "ref.pth")
    prefix = "future_predictor.fuser."
    for path in (tmp_path / "ck", tmp_path / "ref.pth"):
        state, used = CK.init_from_model(dst.model.state_dict(), [path],
                                         modules_to_keep=[prefix])
        assert used and all(k.startswith(prefix) for k in used)
        for k, v in state.items():
            want = src.model.state_dict()[k] if k.startswith(prefix) \
                else dst.model.state_dict()[k]
            assert torch.equal(v, want), k
    # a shape mismatch is skipped, not loaded
    sd = {k: v.clone() for k, v in src.model.state_dict().items()}
    name = next(k for k in sd if k.endswith("norm1.weight"))
    sd[name] = torch.zeros(3)
    merged, used = CK.merge_matching(dst.model.state_dict(), sd)
    assert name not in used and torch.equal(merged[name],
                                            dst.model.state_dict()[name])
    dst.load_model_state(merged)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    yield tmp_path
    signal.signal(signal.SIGTERM, handler)


def test_resume_equals_an_uninterrupted_run(workdir):
    """Two epochs of expt 99 (dropout, drop-path and mixup on) in one run,
    and one epoch then a resumed second: the same weights, optimizer state
    and best metric, bit for bit."""
    base = read_expt_file(SMOKE_TRAIN) + ["use_wandb=false", "workers=2"]
    PLOOP.main(compose(CONF_DIR, base + ["experiment_name=whole"]),
               device="cpu", interactive=False)
    PLOOP.main(compose(CONF_DIR, base + ["experiment_name=parts",
                                         "train.num_epochs=1"]),
               device="cpu", interactive=False)
    PLOOP.main(compose(CONF_DIR, base + ["experiment_name=parts",
                                         "train.resume=true"]),
               device="cpu", interactive=False)
    ckpts = workdir / "checkpoints"
    whole = CK.load_checkpoint(next(ckpts.glob("*_whole")) /
                               "checkpoint_last")
    parts = CK.load_checkpoint(next(ckpts.glob("*_parts")) /
                               "checkpoint_last")
    assert whole["epoch"] == parts["epoch"] == 2
    assert whole["step"] == parts["step"] == 16
    assert whole["best_metric"] == parts["best_metric"]
    for k, v in whole["model"].items():
        assert torch.equal(parts["model"][k], v), k
    for i, state in whole["optimizer"]["state"].items():
        assert torch.equal(parts["optimizer"]["state"][i]["momentum_buffer"],
                           state["momentum_buffer"]), i
