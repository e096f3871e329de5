"""The port's one-command reference parity
(afft_tpu_torch/tools/reproduce_reference.py) against the JAX package's
(tools/reproduce_reference.py), on the CPU, on the synthetic set
(tests/fixtures/synth) with expt 99_synth_smoke_val.

One torch-format ``.pth`` of a seeded JAX init (``afft_tpu.train.
torch_export`` -> ``torch.save({"model": ...})``, as tests/test_reproduce.py
makes it) carries the weights to both packages:

- both eval CLIs export the val set's action logits from it, and the two
  files agree at tests/test_parity.py's tolerance (atol 2e-5, rtol 1e-5);
- every clip's top-1 margin exceeds ten times that tolerance, so equal
  logits imply equal top-1 predictions, hence equal accuracies;
- the JAX tool's ``main`` and the port tool's ``main(..., "--device",
  "cpu")`` return the same metric on the file; out of tolerance the port
  tool exits 1;
- the port's ``EXPECTATIONS`` equal the JAX tool's, and its command line
  builds the JAX tool's overrides. Everything here comes from the repo: no
  step needs the reference's checkout or its released weights.

Both packages resolve ``${cwd}`` to the directory the tests run from (the
repo's root), as tests/test_reproduce.py relies on; the exports write under
a temporary ``cwd`` that links the repo's ``tests`` directory.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "tests", "fixtures", "synth")
EXPT = "99_synth_smoke_val"
ATOL, RTOL = 2e-5, 1e-5  # tests/test_parity.py


def _jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import reproduce_reference as RR
    return RR


@pytest.fixture(scope="module")
def synth_pth(tmp_path_factory):
    """A torch-format .pth of a seeded JAX init of the smoke expt's
    model."""
    import jax
    from afft_tpu.config import compose
    from afft_tpu.data.loader import get_dataset
    from afft_tpu.models import BaseModel
    from afft_tpu.train import torch_export as TE
    from afft_tpu.train.loop import DATASET_EVAL_CFG_KEY, get_transforms
    from afft_tpu_torch.config import read_expt_file

    overrides = read_expt_file(os.path.join(REPO, "expts", EXPT + ".txt"))
    cfg = compose(os.path.join(REPO, "afft_tpu", "conf"), overrides)
    ds = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                     get_transforms(cfg, train=False), None)
    model = BaseModel(cfg.model,
                      num_classes={k: len(v) for k, v in ds.classes.items()},
                      class_mappings=ds.class_mappings)
    params = model.init(jax.random.key(7))
    sd = TE.export_base_model(model, params)
    path = tmp_path_factory.mktemp("zoo") / "checkpoint_best.pth"
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    return str(path)


def _export_overrides(workdir, pth, name):
    from afft_tpu_torch.config import read_expt_file
    lines = read_expt_file(os.path.join(REPO, "expts", EXPT + ".txt"))
    return [*lines, f"cwd={workdir}", f"init_from_model={pth}",
            f"save_name={name}.h5"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory, synth_pth):
    """The val set's action logits exported by each package's eval from the
    .pth: {"jax": array, "port": array}."""
    import h5py
    from afft_tpu.config import compose as jax_compose
    from afft_tpu.eval.evaluate import main as jax_eval
    from afft_tpu_torch.config import CONF_DIR, compose
    from afft_tpu_torch.eval.evaluate import main as port_eval

    work = tmp_path_factory.mktemp("export")
    (work / "tests").symlink_to(os.path.join(REPO, "tests"))
    jax_eval(jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                         _export_overrides(work, synth_pth, "jax")))
    port_eval(compose(CONF_DIR, _export_overrides(work, synth_pth, "port")),
              device="cpu")
    out = {}
    for name in ("jax", "port"):
        with h5py.File(work / "logits" / f"{name}.h5", "r") as f:
            out[name] = np.asarray(f["logits/action_all-fused"])
    return out


def test_exported_logits_agree_and_decide_every_clip(exported):
    want, got = exported["jax"], exported["port"]
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    top2 = np.sort(want, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    need = 10 * (ATOL + RTOL * np.abs(top2[:, 1]))
    worst = int(np.argmin(margin - need))
    assert (margin > need).all(), (
        f"clip {worst}: top-1 margin {margin[worst]:.3g} is within ten "
        f"times the logits' tolerance ({need[worst]:.3g}); equal logits "
        "would not imply equal accuracies")
    assert (got.argmax(1) == want.argmax(1)).all()


def test_both_tools_measure_the_same_metric(synth_pth, exported):
    from afft_tpu_torch.tools import reproduce_reference as PR
    args = ["--expt", EXPT, "--ckpt", synth_pth, "--metric", "atop1",
            "--expect", "0.0", "--tolerance", "1e9"]
    want = _jax_tool().main(list(args))
    got = PR.main(args + ["--device", "cpu"])
    assert np.isfinite(got) and 0.0 <= got <= 100.0
    assert got == want

    # exit-code semantics: an out-of-tolerance result fails the command
    with pytest.raises(SystemExit) as e:
        PR.main(["--expt", EXPT, "--ckpt", synth_pth, "--metric", "atop1",
                 "--expect", str(got + 50.0), "--tolerance", "0.1",
                 "--device", "cpu"])
    assert e.value.code == 1


def test_expectations_and_command_line_are_the_jax_tools():
    from afft_tpu_torch.tools import reproduce_reference as PR
    assert PR.EXPECTATIONS == _jax_tool().EXPECTATIONS
    for name in PR.EXPECTATIONS:
        assert os.path.exists(os.path.join(REPO, "expts", name + ".txt"))
    args = PR.parse_args(["--expt", "01_SA-Fuser_ek100_val_TSN", "--lmdb",
                          "rgb=/d/rgb,flow=/d/flow", "--ckpt", "z/c.pth",
                          "--override", "a=1", "--override", "b=2"])
    assert args.device == "cuda" and args.tolerance == 0.3
    lines = PR.build_overrides(args)
    assert lines[-5:] == [
        "init_from_model=z/c.pth",
        "dataset.epic_kitchens100.common.reader_fn.rgb.lmdb_path=/d/rgb",
        "dataset.epic_kitchens100.common.reader_fn.flow.lmdb_path=/d/flow",
        "a=1", "b=2"]
    assert not any(line.lstrip("+").startswith("save_name=")
                   for line in lines)

