"""The port's data pipeline (afft_tpu_torch.data) against the JAX package's
and against the reference fixtures, on the CPU.

- dataset items of tests/fixtures/synth, both splits, equal the JAX
  FeatureClipDataset's exactly, and the torch reference's fixtures
  (data_synth.npz, data_ek100.npz, data_ek100_pkl.npz);
- loader batches (shuffle, padding, ``valid``), ``shard_indices`` and
  weighted resampling equal the JAX loader's exactly;
- packed stores: bf16 / int8 files written by either package are
  byte-identical and read back to equal values by the other (no
  ``ml_dtypes`` in the port);
- the port's native LMDB reader equals ``afft_tpu.data.lmdb_native``;
- the device cache on ``device="cpu"`` equals the loader; its int8
  storage equals the JAX package's int8 cache;
- class statistics equal the JAX package's.
"""

import os
import subprocess
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from afft_tpu.data import loader as JL
from afft_tpu.data import readers as JR
from afft_tpu.data import stats as JS
from afft_tpu.data.epic import EPICKitchens as JaxEPICKitchens
from afft_tpu_torch.config.registry import resolve_target
from afft_tpu_torch.data import loader as PL
from afft_tpu_torch.data import readers as PR
from afft_tpu_torch.data import stats as PS
from afft_tpu_torch.data.device_cache import DeviceFeatureCache
from afft_tpu_torch.data.epic import EPICKitchens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SYNTH = os.path.join(FIXTURES, "synth")
ANNOT = os.path.join(SYNTH, "annotations")
MODS = ["rgb", "flow"]


def _synth_kwargs(split):
    return dict(
        annotation_path=[os.path.join(ANNOT, split)],
        annotation_dir=ANNOT, rulstm_annotation_dir=ANNOT,
        action_labels_fpath=os.path.join(ANNOT, "actions.csv"),
        version=-1, label_type="action", sample_strategy="last_clip",
        conv_to_anticipate_fn={
            "_target_": "datasets.base_video_dataset.convert_to_anticipation",
            "tau_a": 0.5, "tau_o": 10, "drop_style": "correct"},
        reader_fn={m: {
            "_target_": "datasets.reader_fns.EpicRULSTMFeatsReader",
            "lmdb_path": os.path.join(SYNTH, "features_packed", m)}
            for m in MODS},
        frames_per_clip=10, frame_rate=1, load_seg_labels=True)


@pytest.fixture(scope="module")
def synth():
    """{split: (port dataset, JAX dataset)}."""
    return {split: (EPICKitchens(**_synth_kwargs(split)),
                    JaxEPICKitchens(**_synth_kwargs(split)))
            for split in ("training1.csv", "validation1.csv")}


def _assert_items_equal(got, want):
    assert set(got) >= {"data_dict", "target", "uid", "idx"}
    for m, v in want["data_dict"].items():
        assert got["data_dict"][m].dtype == np.float32
        np.testing.assert_array_equal(got["data_dict"][m],
                                      np.asarray(v, np.float32), err_msg=m)
    for key in ("target", "target_subclips"):
        for t, v in want.get(key, {}).items():
            np.testing.assert_array_equal(got[key][t], v, err_msg=key)
    np.testing.assert_array_equal(got["uid"], want["uid"])
    np.testing.assert_array_equal(got["idx"], want["idx"])
    if "video_frame_sec" in want:
        np.testing.assert_array_equal(got["video_frame_sec"],
                                      want["video_frame_sec"])


@pytest.mark.parametrize("split", ["training1.csv", "validation1.csv"])
def test_synth_items_equal_the_jax_dataset(synth, split):
    """Every item and a whole-batch gather (the clip plan's fast path) of
    both splits: features, targets, per-frame past labels, timestamps."""
    port, jax_ds = synth[split]
    assert len(port) == len(jax_ds) > 0
    assert port.supports_batch_load() and jax_ds.supports_batch_load()
    for i in range(len(port)):
        _assert_items_equal(port.get_item(i), jax_ds.get_item(i))
    idx = np.arange(len(port))[::-3]
    _assert_items_equal(port.load_batch(idx), jax_ds.load_batch(idx))
    np.testing.assert_array_equal(port.df.uid.values, jax_ds.df.uid.values)
    for key, m in port.class_mappings.items():
        np.testing.assert_array_equal(m, jax_ds.class_mappings[key])


def test_synth_items_match_the_reference_fixture(synth):
    """data_synth.npz (the torch reference's items on the validation
    split): the anticipation conversion, the class mappings and every
    item, at the tolerances of tests/test_data.py."""
    port, _ = synth["validation1.csv"]
    d = np.load(os.path.join(FIXTURES, "data_synth.npz"))
    np.testing.assert_array_equal(port.df.uid.values.astype(np.int64),
                                  d["df::uid"])
    np.testing.assert_allclose(port.df.start.values, d["df::start"])
    np.testing.assert_allclose(port.df.orig_start.values,
                               d["df::orig_start"])
    np.testing.assert_array_equal(
        np.sort(port.discarded_df.uid.values.astype(np.int64)),
        np.sort(d["df::discarded_uid"]))
    cm = port.class_mappings
    np.testing.assert_array_equal(cm[("verb", "action")], d["cm::verb_action"])
    np.testing.assert_array_equal(cm[("noun", "action")], d["cm::noun_action"])
    assert len(port) == int(d["n_items"])
    for i in range(len(port)):
        item = port.get_item(i)
        for m in MODS:
            np.testing.assert_allclose(item["data_dict"][m],
                                       d[f"item{i}::data::{m}"],
                                       rtol=1e-6, atol=1e-6)
        assert item["target"]["action"] == int(d[f"item{i}::target::action"])
        np.testing.assert_array_equal(item["target_subclips"]["action"],
                                      d[f"item{i}::subclips::action"])
        np.testing.assert_allclose(item["video_frame_sec"],
                                   d[f"item{i}::frame_sec"].squeeze(-1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fixture,annotation,tau_o", [
    ("data_ek100.npz", "annotations/ek100_rulstm/validation.csv", 10),
    ("data_ek100_pkl.npz", "annotations/ek100_ori/EPIC_100_validation.pkl",
     16)])
def test_ek100_annotations_match_the_reference_fixture(fixture, annotation,
                                                       tau_o):
    """The EK100 csv and pkl annotation paths: the anticipation windows,
    labels and class mappings equal the reference fixture's and the JAX
    dataset's."""
    d = np.load(os.path.join(FIXTURES, fixture))
    kwargs = dict(
        annotation_path=[os.path.join(REPO, annotation)],
        annotation_dir=os.path.join(REPO, "annotations/ek100_ori/"),
        rulstm_annotation_dir=os.path.join(REPO, "annotations/ek100_rulstm/"),
        action_labels_fpath=os.path.join(
            REPO, "annotations/ek100_rulstm/actions.csv"),
        version=0.2, label_type="action", sample_strategy="last_clip",
        conv_to_anticipate_fn={
            "_target_": "datasets.base_video_dataset.convert_to_anticipation",
            "tau_a": 1, "tau_o": tau_o, "drop_style": "correct"},
        reader_fn={}, frames_per_clip=tau_o, frame_rate=1,
        load_seg_labels=False)
    ds = EPICKitchens(**kwargs)
    assert len(ds.df) == len(d["df::start"])
    assert len(ds.discarded_df) == int(d["n_discarded"])
    np.testing.assert_allclose(ds.df.start.values, d["df::start"])
    np.testing.assert_allclose(ds.df.end.values, d["df::end"])
    np.testing.assert_array_equal(ds.df.action_class.values,
                                  d["df::action_class"])
    jax_ds = JaxEPICKitchens(**kwargs)
    np.testing.assert_array_equal(ds.df.start.values, jax_ds.df.start.values)
    for key, m in ds.class_mappings.items():
        np.testing.assert_array_equal(m, jax_ds.class_mappings[key])
    if "cm::verb_action" in d:
        np.testing.assert_array_equal(ds.class_mappings[("verb", "action")],
                                      d["cm::verb_action"])


@pytest.mark.parametrize("n,shards,weighted", [
    (100, 1, False), (100, 3, False), (7, 4, False), (60, 1, True),
    (60, 2, True)])
def test_shard_indices_equal_the_jax_loader(n, shards, weighted):
    w = None
    if weighted:
        w = np.random.default_rng(n).random(n)
        w = w / w.sum()
    for epoch in (0, 3):
        for shard in range(shards):
            args = (n, True, 5, epoch, shard, shards)
            np.testing.assert_array_equal(
                PL.shard_indices(*args, weights=w),
                JL.shard_indices(*args, weights=w))
    np.testing.assert_array_equal(PL.shard_indices(n, False, 0, 0),
                                  np.arange(n))


def _batches(loader_cls, ds, **kw):
    loader = loader_cls(ds, num_workers=2, **kw)
    loader.set_epoch(2)
    return list(loader)


@pytest.mark.parametrize("kw", [
    dict(batch_size=7, shuffle=True, seed=3),
    dict(batch_size=16, shuffle=False),
    dict(batch_size=8, shuffle=True, seed=1, weights=True),
    dict(batch_size=5, shuffle=True, seed=2, pad_final=False)])
def test_loader_batches_equal_the_jax_loader(synth, kw):
    """Same batches in the same order: features, targets, past labels,
    uid / idx, the padding of the last batch and its ``valid`` mask;
    weighted resampling draws the same rows."""
    port, jax_ds = synth["training1.csv"]
    kw = dict(kw)
    if kw.pop("weights", False):
        kw["sample_weights"] = PS.balanced_sample_weights(port, "action", 1.0)
    got = _batches(PL.BatchLoader, port, **kw)
    want = _batches(JL.BatchLoader, jax_ds, **kw)
    assert len(got) == len(want) == len(PL.BatchLoader(port, **kw))
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
        np.testing.assert_array_equal(g["valid"], w["valid"])
    assert sum(int(b["valid"].sum()) for b in got) == len(port)


def test_loader_propagates_worker_errors_and_releases_on_break(synth):
    class Broken:
        def __len__(self):
            return 10

        def get_item(self, idx):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(PL.BatchLoader(Broken(), batch_size=4, num_workers=2))
    port, _ = synth["validation1.csv"]
    before = threading.active_count()
    for _ in range(5):
        for _ in PL.BatchLoader(port, batch_size=4, num_workers=2,
                                prefetch=1):
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def _store_table(dim=40, seed=0):
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-39,
                        3.3e38, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                        -(1.0 + 2.0 ** -8), 65504.0], np.float32)
    table = {}
    for v, n in (("P01_101", 23), ("P02_02", 9)):
        frames = {}
        for fid in range(1, 2 * n, 2):
            feat = rng.standard_normal(dim).astype(np.float32) * 3
            frames[fid] = feat
        table[v] = frames
    first = table["P01_101"][1]
    first[:len(special)] = special
    return table


def _files(path):
    return {name: (path / name).read_bytes()
            for name in ("features.bin", "frame_ids.bin", "meta.json")}


def _rows(table):
    for v in sorted(table):
        ids = np.array(sorted(table[v]), np.int64)
        yield v, ids, np.stack([table[v][i] for i in ids])


@pytest.mark.parametrize("writer", ["write", "write_blocks", "write_stream"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_packed_store_files_and_values_cross_read(tmp_path, writer, dtype):
    """A store written by the port is byte-identical to the JAX package's
    (bf16 by round to nearest even, NaN to a quiet NaN, as ml_dtypes), and
    each package reads the other's store to equal values: the port's
    float32 rows are the JAX reader's bf16 / dequantized rows exactly."""
    table = _store_table()
    if dtype == "int8":  # a non-finite row has no int8 scale
        table["P01_101"][1] = np.nan_to_num(table["P01_101"][1], posinf=0,
                                            neginf=0)
    made = {}
    for name, mod in (("port", PR), ("jax", JR)):
        path = tmp_path / name
        cls = mod.PackedFeatureStore
        if writer == "write":
            cls.write(path, table, dtype=dtype)
        elif writer == "write_blocks":
            cls.write_blocks(path, _rows(table), dtype=dtype)
        else:
            cls.write_stream(path, ((v, int(i), f)
                                    for v, ids, feats in _rows(table)
                                    for i, f in zip(ids, feats)),
                             dtype=dtype)
        made[name] = path
    assert _files(made["port"]) == _files(made["jax"])
    assert (made["port"] / "scales.bin").exists() == (dtype == "int8")
    ids = np.array([[1, 2, 5, 40], [3, 3, 17, 21]])
    videos = np.array(["P01_101", "P02_02"])
    for store_path in made.values():
        port = PR.PackedFeatureStore(store_path)
        jax_store = JR.PackedFeatureStore(store_path)
        got = port.get_frames_batch(videos, ids)
        want = np.asarray(jax_store.get_frames_batch(videos, ids), np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port.get_frames("P02_02", ids[1]),
            np.asarray(jax_store.get_frames("P02_02", ids[1]), np.float32))


def test_bf16_conversion_equals_ml_dtypes():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(10000).astype(np.float32) * 1e3,
        rng.integers(0, 2 ** 32, 10000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16)
    bits = PR.bf16_bits(x)
    nan = np.isnan(x)
    np.testing.assert_array_equal(bits[~nan], want.view(np.uint16)[~nan])
    assert np.isnan(PR.bf16_to_f32(bits[nan])).all()
    np.testing.assert_array_equal(PR.bf16_to_f32(bits[~nan]),
                                  want.astype(np.float32)[~nan])


def _toolchain_or_skip():
    try:
        subprocess.run(["g++", "--version"], check=True,
                       capture_output=True)
        subprocess.check_call(["make", "-C", os.path.join(REPO, "native")],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("no C++ toolchain available")


def test_native_lmdb_reader_equals_the_jax_one(tmp_path):
    """The port's copy of the native reader, built into build/, reads an
    LMDB written by tools/make_lmdb_fixture.py (with an overflow-page value)
    as afft_tpu.data.lmdb_native does: point gets, misses, the cursor scan,
    and LmdbFeatureStore's backward search."""
    _toolchain_or_skip()
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from make_lmdb_fixture import write_lmdb
    finally:
        sys.path.pop(0)
    from afft_tpu.data import lmdb_native as jax_native
    from afft_tpu_torch.data import lmdb_native as port_native
    rng = np.random.default_rng(3)
    table = {}
    for vid, n, dim in (("SYN-A-V1", 300, 24), ("SYN-B-V2", 40, 1024)):
        table[vid] = {i: rng.standard_normal(dim).astype(np.float32)
                      for i in range(1, n + 1) if rng.random() > 0.1}
    pairs = [(f"{vid}_frame_{fid:010d}.jpg".encode(), feat.tobytes())
             for vid, d in table.items() for fid, feat in d.items()]
    write_lmdb(tmp_path / "env", pairs)
    port_env = port_native.NativeLmdb(str(tmp_path / "env"))
    jax_env = jax_native.NativeLmdb(str(tmp_path / "env"))
    assert port_native.build().startswith(
        os.path.join(REPO, "build", "afft_tpu_torch"))
    assert port_env.entries == jax_env.entries == len(pairs)
    for key, _ in pairs[::7] + [(b"SYN-A-V1_frame_0000009999.jpg", None)]:
        assert port_env.get(key) == jax_env.get(key)
    assert list(port_env.items()) == list(jax_env.items())
    port_store = PR.LmdbFeatureStore(tmp_path / "env")
    jax_store = JR.LmdbFeatureStore(tmp_path / "env")
    ids = np.array([1, 2, 3, 17, 40, 55])
    np.testing.assert_array_equal(port_store.get_frames("SYN-B-V2", ids),
                                  jax_store.get_frames("SYN-B-V2", ids))


def test_device_cache_on_cpu_equals_the_loader(synth):
    """The device cache (here on the CPU) serves the loader's batches in the
    loader's order, features rounded to bf16 as it stores them, with the
    same padding and valid mask; its int8 storage gathers what the JAX
    package's int8 cache gathers (``_int8_cache_equals_the_jax_cache``)."""
    port, jax_ds = synth["training1.csv"]
    cache = DeviceFeatureCache(port, "cpu")
    assert cache.nbytes == sum(f.numel() * 2 for f in cache.features.values())
    got = list(cache.iter_batches(7, shuffle=True, seed=3, epoch=2))
    want = _batches(PL.BatchLoader, port, batch_size=7, shuffle=True, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for m in MODS:
            assert g["data_dict"][m].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g["data_dict"][m].float().numpy(),
                torch.from_numpy(w["data_dict"][m]).bfloat16().float()
                .numpy())
        for key in ("target", "target_subclips"):
            np.testing.assert_array_equal(g[key]["action"],
                                          w[key]["action"])
        np.testing.assert_array_equal(g["idx"], w["idx"])
        np.testing.assert_array_equal(g["valid"], w["valid"])
    _int8_cache_equals_the_jax_cache(port, jax_ds, cache)


def _int8_cache_equals_the_jax_cache(port, jax_ds, bf16_cache):
    """int8 storage on the CPU against afft_tpu's int8 DeviceFeatureCache:
    the same batches within one bf16 ulp (both dequantize in fp32 and round
    once to bf16), all-zero frames exactly 0, the payload half the bf16
    cache's bytes (plus the fp32 (N, T) scales)."""
    from afft_tpu.data.device_cache import DeviceFeatureCache as JaxCache
    cache = DeviceFeatureCache(port, "cpu", dtype="int8")
    jax_cache = JaxCache(jax_ds, dtype="int8")
    payload = sum(f.numel() for f in cache.features.values())
    assert all(f.dtype == torch.int8 for f in cache.features.values())
    assert 2 * payload == bf16_cache.nbytes
    assert cache.nbytes == payload + sum(
        s.numel() * 4 for s in cache.scales.values())
    rng = np.random.default_rng(4)
    indices = rng.permutation(len(port))[:13]
    got, want = cache.batch(indices), jax_cache.batch(indices)
    for m in MODS:
        g = got["data_dict"][m]
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = np.asarray(want["data_dict"][m].astype(np.float32))
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp).all(), m
        host = np.asarray(port.load_batch(indices)["data_dict"][m])
        zero = (host == 0).all(axis=-1)
        assert (g[zero] == 0).all()
        # int8 bound: half a quantization step of the frame, then bf16
        step = np.abs(host).max(axis=-1, keepdims=True) / 127.0
        assert (np.abs(g - host) <= 0.5 * step + np.abs(host) * 2 ** -8
                + 1e-7).all(), m
    np.testing.assert_array_equal(got["uid"], want["uid"])

    class ZeroFrames:
        """``port`` with frame 2 of every clip blanked to all zeros."""

        def __getattr__(self, name):
            return getattr(port, name)

        def __len__(self):
            return len(port)

        def load_batch(self, idx):
            batch = dict(port.load_batch(idx))
            batch["data_dict"] = {m: np.array(v) for m, v in
                                  batch["data_dict"].items()}
            for v in batch["data_dict"].values():
                v[:, 2] = 0
            return batch

    blank = DeviceFeatureCache(ZeroFrames(), "cpu", dtype="int8")
    for m, g in blank.batch(indices)["data_dict"].items():
        assert (g[:, 2] == 0).all() and (g[:, 1] != 0).any(), m


def test_class_statistics_equal_the_jax_package(synth):
    port, jax_ds = synth["training1.csv"]
    np.testing.assert_array_equal(PS.class_counts(port, "action"),
                                  JS.class_counts(jax_ds, "action"))
    for alpha in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(
            PS.balanced_sample_weights(port, "action", alpha),
            JS.balanced_sample_weights(jax_ds, "action", alpha))
    counts = np.random.default_rng(0).integers(0, 50, 40)
    for beta in (0.9, 0.999):
        np.testing.assert_allclose(
            PS.effective_number_class_weights(counts, beta),
            JS.effective_number_class_weights(counts, beta), rtol=1e-6)
    assert PS.summarize(port) == JS.summarize(jax_ds)


def test_registry_resolves_the_data_targets():
    from afft_tpu_torch.data import anticipation, epic, readers
    assert resolve_target("datasets.epic_kitchens.EPICKitchens") \
        is epic.EPICKitchens
    assert resolve_target(
        "datasets.base_video_dataset.convert_to_anticipation") \
        is anticipation.convert_to_anticipation
    assert resolve_target("datasets.reader_fns.EpicRULSTMFeatsReader") \
        is readers.EpicRULSTMFeatsReader
    assert resolve_target("datasets.reader_fns.DefaultReader") \
        is readers.DefaultReader
