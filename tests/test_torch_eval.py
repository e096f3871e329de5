"""The port's eval path against the JAX package's, on the CPU.

- Every function of ``afft_tpu_torch.eval.challenge`` against
  ``afft_tpu.eval.challenge``: marginalization and accuracies on
  tests/fixtures/challenge_eval.npz and on seeded logits over the synthetic
  set (tests/fixtures/synth), the unseen / tail breakdowns (NaN for an
  empty subset or a missing annotation dir), late fusion and the
  submission structure, from the same logits files.
- ``eval.evaluate``'s ``collect_logits`` / ``evaluate`` against the JAX
  ones on the same weights (``weights.state_dict_from_jax``) at the
  tests/test_parity.py tolerances (atol 2e-5, rtol 1e-5, fp32); the dataset
  row order; the device feature cache against the host loader; the h5 and
  npz writers round-trip through the challenge reader.
- The CLI end to end: expt 99 trained one epoch, ``python -m
  afft_tpu_torch.run -m test --device cpu`` in the accuracies mode and with
  ``+save_name`` (h5, and npz where h5py would not import), then
  ``afft_tpu_torch.challenge`` on the exported file.
- artifacts/accept_r04/test.h5 through the port's challenge tool: the
  test.json it writes equals the one inside artifacts/accept_r04/submit.zip
  (parsed; scores within 1e-6). The annotations are the accept set's,
  written by ``make_accept_dataset.write_annotations`` (the features are
  not needed).
"""

import json
import logging
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.data.epic import EPICKitchens as JaxEPICKitchens
from afft_tpu.data.loader import BatchLoader as JaxBatchLoader
from afft_tpu.eval import challenge as JC
from afft_tpu.eval import evaluate as JE
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.parallel.mesh import make_mesh, replicate_tree
from afft_tpu_torch import challenge as PCHALLENGE
from afft_tpu_torch import run as RUN
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.data.device_cache import DeviceFeatureCache
from afft_tpu_torch.data.epic import EPICKitchens
from afft_tpu_torch.data.loader import BatchLoader
from afft_tpu_torch.eval import challenge as PC
from afft_tpu_torch.eval import evaluate as PE
from afft_tpu_torch.tools.make_accept_dataset import write_annotations
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SYNTH = os.path.join(FIXTURES, "synth")
ANNOT = os.path.join(SYNTH, "annotations")
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
SMOKE_VAL = os.path.join(REPO, "expts", "99_synth_smoke_val.txt")
ACCEPT = os.path.join(REPO, "artifacts", "accept_r04")
NARROW = ["model.modal_dims={rgb:24, flow:24}", "model.common_dim=24",
          "model.common.fp_inter_dim=48", "model.common.fp_layers=2",
          "model.common.fp_heads=2", "model.fuser.depth=2",
          "model.fuser.num_heads=2"]
ATOL, RTOL = 2e-5, 1e-5
TAIL_FILES = ("validation_unseen_participants_ids.csv",
              "validation_tail_verbs_ids.csv",
              "validation_tail_nouns_ids.csv",
              "validation_tail_actions_ids.csv")


def _dataset_kwargs():
    return dict(
        annotation_path=[os.path.join(ANNOT, "validation1.csv")],
        annotation_dir=ANNOT, rulstm_annotation_dir=ANNOT,
        action_labels_fpath=os.path.join(ANNOT, "actions.csv"),
        version=-1, label_type="action", sample_strategy="last_clip",
        conv_to_anticipate_fn={
            "_target_": "datasets.base_video_dataset.convert_to_anticipation",
            "tau_a": 0.5, "tau_o": 10, "drop_style": "correct"},
        reader_fn={m: {
            "_target_": "datasets.reader_fns.EpicRULSTMFeatsReader",
            "lmdb_path": os.path.join(SYNTH, "features_packed", m)}
            for m in ("rgb", "flow")},
        frames_per_clip=10, frame_rate=1, load_seg_labels=False)


@pytest.fixture(scope="module")
def setup():
    """(port dataset, JAX dataset, port runner, JAX model, params, mesh) on
    the same weights."""
    pds, jds = EPICKitchens(**_dataset_kwargs()), \
        JaxEPICKitchens(**_dataset_kwargs())
    classes = {k: len(v) for k, v in jds.classes.items()}
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"), NARROW)
    jmodel = JaxBaseModel(jcfg.model, num_classes=classes,
                          class_mappings=jds.class_mappings)
    params = jmodel.init(jax.random.key(7))
    host = jax.tree.map(np.asarray, params)
    mesh = make_mesh(jax.devices()[:1])
    params = replicate_tree(mesh, params)
    runner = Runner.from_config(compose(CONF_DIR, NARROW), classes,
                                device="cpu",
                                class_mappings=pds.class_mappings)
    runner.load_model_state(W.state_dict_from_jax(runner.model, host))
    return pds, jds, runner, jmodel, params, mesh


def _seeded_probs(ds, seed):
    rng = np.random.default_rng(seed)
    n = len(ds)
    return [rng.random((n, int(ds.df[c].max()) + 1)).astype(np.float32)
            for c in ("verb_class", "noun_class", "action_class")]


def _assert_accs(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-9, err_msg=k)


# -- challenge functions ----------------------------------------------------

@pytest.mark.parametrize("tail", [False, True])
def test_marginalization_on_the_fixture_matches_jax(setup, tail):
    pds, jds = setup[:2]
    logits = np.load(os.path.join(FIXTURES, "challenge_eval.npz"))["logits"]
    got, got_scores = PC.marginalize_verb_noun(
        logits, pds, to_prob=True, compute_manyshot_unseen_tail=tail)
    want, want_scores = JC.marginalize_verb_noun(
        logits, jds, to_prob=True, compute_manyshot_unseen_tail=tail)
    _assert_accs(got, want)
    for g, w in zip(got_scores, want_scores):
        np.testing.assert_allclose(g, w, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracies_and_breakdowns_on_seeded_logits_match_jax(
        setup, seed, tmp_path, monkeypatch):
    pds, jds = setup[:2]
    probs = _seeded_probs(pds, seed)
    # unseen / tail id lists: seeded subsets of the set's uids
    uids = pds.df.uid.values
    rng = np.random.default_rng(seed)
    for f in TAIL_FILES:
        pick = rng.choice(uids, size=len(uids) // 2, replace=False)
        (tmp_path / f).write_text("".join(f"{u}\n" for u in pick))
    for ds in (pds, jds):
        monkeypatch.setattr(ds, "rulstm_annotation_dir", str(tmp_path))
    _assert_accs(PC.compute_accuracies_epic(probs, pds, True),
                 JC.compute_accuracies_epic(probs, jds, True))
    _assert_accs(PC.epic100_unseen_tail_eval(probs, pds),
                 JC.epic100_unseen_tail_eval(probs, jds))
    assert PC.compute_accuracy(probs[2], pds.df.action_class.values) == \
        pytest.approx(JC.compute_accuracy(probs[2],
                                          jds.df.action_class.values))


def test_empty_or_missing_breakdowns_are_nan_as_in_jax(setup, tmp_path,
                                                       monkeypatch, caplog):
    pds, jds = setup[:2]
    probs = _seeded_probs(pds, 3)
    for f in TAIL_FILES:
        (tmp_path / f).write_text("")
    for ds in (pds, jds):
        monkeypatch.setattr(ds, "rulstm_annotation_dir", str(tmp_path))
    got = PC.epic100_unseen_tail_eval(probs, pds)
    assert set(got) == set(JC.epic100_unseen_tail_eval(probs, jds))
    assert all(np.isnan(v) for v in got.values())
    monkeypatch.setattr(pds, "rulstm_annotation_dir", None)
    with caplog.at_level(logging.WARNING):
        got = PC.epic100_unseen_tail_eval(probs, pds)
    assert all(np.isnan(v) for v in got.values())
    assert "rulstm_annot_dir" in caplog.text


def _write_logits(tmp_path, ds, fmt):
    """Two models' seeded logits as logits files of format ``fmt``."""
    dirs = []
    for i, name in enumerate(("A", "B")):
        logits = np.random.default_rng(10 + i).standard_normal(
            (len(ds), len(ds.classes["action"]))).astype(np.float32)
        d = str(tmp_path / fmt / name)
        store = PE.store_append_h5 if fmt == "h5" else PE.store_append_npz
        store({"logits/action_all-fused": logits}, d, "test.h5")
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("weights", [[1.0, 0.0], [1.0, 0.5],
                                     [[1.0, 0.5], [0.3, 1.0]]])
def test_late_fusion_matches_jax(setup, tmp_path, weights):
    pds, jds = setup[:2]
    dirs = _write_logits(tmp_path, pds, "h5")
    got, got_comb, _ = PC.get_epic_marginalize_late_fuse(
        dirs, pds, weights=weights, prefix_h5="test")
    want, want_comb, _ = JC.get_epic_marginalize_late_fuse(
        dirs, jds, weights=weights, prefix_h5="test")
    _assert_accs(got, want)
    for g, w in zip(got_comb, want_comb):
        assert set(g) == set(w)
        for uid in w:
            np.testing.assert_allclose(g[uid], w[uid], rtol=1e-12)
    # the npz files of the same logits fuse to the same numbers
    npz, _, _ = PC.get_epic_marginalize_late_fuse(
        _write_logits(tmp_path, pds, "npz"), pds, weights=weights,
        prefix_h5="test")
    _assert_accs(npz, want)


def test_submission_matches_jax(setup, tmp_path):
    pds, jds = setup[:2]
    dirs = _write_logits(tmp_path, pds, "h5")
    out = {}
    for name, mod, ds in (("port", PC, pds), ("jax", JC, jds)):
        mod.package_results_for_submission_ek100(
            dirs, ds, [1.0, 0.5], output_dir=str(tmp_path / name),
            prefix_h5="test")
        with open(tmp_path / name / "test.json") as f:
            out[name] = json.load(f)
        with zipfile.ZipFile(tmp_path / name / "submit.zip") as zf:
            assert zf.namelist() == ["test.json"]
            assert json.loads(zf.read("test.json")) == out[name]
    assert out["port"] == out["jax"]
    n_total = len(pds) + (0 if pds.discarded_df is None
                          else len(pds.discarded_df))
    assert len(out["port"]["results"]) == n_total


# -- the eval forward ---------------------------------------------------------

def test_collect_logits_and_evaluate_match_jax(setup):
    pds, jds, runner, jmodel, params, mesh = setup
    got, got_idx, got_head = PE.collect_logits(
        runner, BatchLoader(pds, batch_size=6, shuffle=False, num_workers=2))
    want, want_idx, want_head = JE.collect_logits(
        jmodel, params, JaxBatchLoader(jds, batch_size=6, shuffle=False,
                                       num_workers=2), mesh)
    assert got.shape == want.shape == (len(pds), len(pds.classes["action"]))
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got_head == want_head == "all-fused"
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    _assert_accs(
        PE.evaluate(runner, pds, BatchLoader(pds, batch_size=7,
                                             shuffle=False, num_workers=2)),
        JE.evaluate(jmodel, params, jds,
                    JaxBatchLoader(jds, batch_size=7, shuffle=False,
                                   num_workers=2), mesh))


def test_rows_follow_the_dataset_order(setup):
    pds, runner = setup[0], setup[2]
    uids = np.concatenate([u for _, u, _, _ in PE._forward_all(
        runner, BatchLoader(pds, batch_size=5, shuffle=False,
                            num_workers=2))])
    np.testing.assert_array_equal(uids.astype(np.int64),
                                  pds.df.uid.values.astype(np.int64))


def test_device_cache_equals_the_host_loader(setup):
    pds, runner = setup[0], setup[2]
    host, host_idx, _ = PE.collect_logits(
        runner, BatchLoader(pds, batch_size=6, shuffle=False, num_workers=2))
    # an fp32 cache holds the host loader's features: the same logits
    cache = DeviceFeatureCache(pds, "cpu", dtype=torch.float32)
    got, got_idx, _ = PE.collect_logits(runner,
                                        cache.iter_batches(6, shuffle=False))
    np.testing.assert_array_equal(got_idx, host_idx)
    np.testing.assert_array_equal(got, host)
    # the bf16 cache (data_on_device) gives the host loader's metrics, as
    # tests/test_eval_e2e.py holds the JAX cache to them
    cache = DeviceFeatureCache(pds, "cpu", dtype=torch.bfloat16)
    want = PE.evaluate(runner, pds, BatchLoader(pds, batch_size=6,
                                                shuffle=False, num_workers=2))
    got = PE.evaluate(runner, pds, cache.iter_batches(6, shuffle=False))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_logits_writers_round_trip(tmp_path, fmt):
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal((n, 7)).astype(np.float32) for n in (3, 5)]
    store = PE.store_append_h5 if fmt == "h5" else PE.store_append_npz
    paths = {store({"logits/action_all-fused": p}, str(tmp_path), "test.h5")
             for p in parts}
    assert paths == {str(tmp_path / f"test.{fmt}")}
    (got,) = list(PC.gen_load_resfiles(str(tmp_path), "test"))
    assert list(got) == ["logits/action_all-fused"]
    np.testing.assert_array_equal(got["logits/action_all-fused"],
                                  np.concatenate(parts))
    if fmt == "h5":  # the JAX reader reads the port's h5
        (jgot,) = list(JC.gen_load_resfiles(str(tmp_path), "test"))
        np.testing.assert_array_equal(jgot["logits/action_all-fused"],
                                      np.concatenate(parts))


# -- the CLI ----------------------------------------------------------------

@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory whose ``tests`` is the repo's (the expts find
    their data under ``${cwd}``)."""
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    import signal
    handler = signal.getsignal(signal.SIGTERM)
    yield tmp_path
    signal.signal(signal.SIGTERM, handler)


SMOKE_DATASET = [line for line in read_expt_file(SMOKE_VAL)
                 if line.startswith("dataset")]


@pytest.mark.parametrize("npz", [False, True])
def test_eval_cli_end_to_end(workdir, monkeypatch, npz):
    common = ["--device", "cpu", "workers=2", "use_wandb=false"]
    RUN.main(["-c", SMOKE_TRAIN, "-m", "train", "train.num_epochs=1",
              *common])
    accs = RUN.main(["-c", SMOKE_VAL, "-m", "test", "save_name=null",
                     *common])
    assert {"vtop1", "atop5", "amt5r"} <= set(accs)
    if npz:  # the card's machine: no h5py
        monkeypatch.setattr(PE, "h5py_imports", lambda: False)
    path = RUN.main(["-c", SMOKE_VAL, "-m", "test", *common])
    model = "CMFPEarly_ModalTokenCMFuser_rgb_flow_synth-smoke"
    assert path == str(workdir / "logits" / model /
                       ("val.npz" if npz else "val.h5"))
    (res,) = list(PC.gen_load_resfiles(os.path.dirname(path), "val"))
    logits = res["logits/action_all-fused"]
    # the accuracies mode equals the challenge's numbers from the file
    ds = PCHALLENGE.get_dataset(SMOKE_DATASET, "val")
    from_file, _ = PC.marginalize_verb_noun(
        logits, ds, compute_manyshot_unseen_tail=True)
    for k, v in accs.items():
        np.testing.assert_allclose(from_file[k], v, rtol=1e-6, err_msg=k)
    PCHALLENGE.main(["--prefix_h5", "val", "--models", model, "--weights",
                     "1", "--override", *SMOKE_DATASET])
    with open(workdir / "logits" / "test.json") as f:
        sub = json.load(f)
    assert len(sub["results"]) == len(ds) and sub["version"] == "-1"


def test_accept_logits_package_to_the_recorded_submission(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_annotations(tmp_path / ".accept_data")
    model = "CMFPEarly_ModalTokenCMFuser_rgb_objects_audio_flow_synth-accept"
    os.makedirs(tmp_path / "logits" / model)
    os.symlink(os.path.join(ACCEPT, "test.h5"),
               tmp_path / "logits" / model / "test.h5")
    # the override of ACCEPT_r04.json's challenge entry point
    PCHALLENGE.main([
        "--prefix_h5", "test", "--models", model, "--weights", "1",
        "--override", "dataset@dataset_eval=egtea/val",
        "dataset.egtea.common.annot_dir=${cwd}/.accept_data/annotations/",
        "dataset.egtea.common.rulstm_annot_dir="
        "${cwd}/.accept_data/annotations/",
        "dataset.egtea.common.tau_a=1", "dataset.egtea.common.tau_o=16"])
    with open(tmp_path / "logits" / "test.json") as f:
        got = json.load(f)
    with zipfile.ZipFile(os.path.join(ACCEPT, "submit.zip")) as zf:
        want = json.loads(zf.read("test.json"))
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert set(got["results"]) == set(want["results"])
    worst = 0.0
    for uid, spaces in want["results"].items():
        assert set(got["results"][uid]) == set(spaces)
        for space, scores in spaces.items():
            mine = got["results"][uid][space]
            assert set(mine) == set(scores), (uid, space)
            worst = max([worst] + [abs(mine[k] - v)
                                   for k, v in scores.items()])
    assert worst <= 1e-6
