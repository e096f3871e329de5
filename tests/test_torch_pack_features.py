"""The port's feature packer (``afft_tpu_torch.tools.pack_features``)
against the JAX package's (tools/pack_features.py), on the CPU: the same
LMDB environments, written by tools/make_lmdb_fixture.py ``write_lmdb``
(two videos, missing frames, a key that is not a frame), packed by both
with each ``--dtype``; every file of the two stores is equal byte for
byte, and the port's store reads back the LMDB's features. The ``--root``
form packs every modality directory as the JAX tool does.
"""

import filecmp
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from afft_tpu_torch.data.readers import PackedFeatureStore
from afft_tpu_torch.tools import pack_features as PF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_packer():
    """tools/pack_features.py, its native reader built (``make -C
    native``, as tests/test_native.py builds it)."""
    try:
        subprocess.check_call(["make", "-C", os.path.join(REPO, "native")],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("no C++ toolchain available")
    return _load_tool("pack_features")


@pytest.fixture(scope="module")
def lmdb_root(tmp_path_factory):
    """Two modality dirs of LMDB features: {name: (path, {video: {frame:
    feature}})}."""
    write_lmdb = _load_tool("make_lmdb_fixture").write_lmdb
    rng = np.random.default_rng(8)
    root = tmp_path_factory.mktemp("lmdb_root")
    out = {}
    for name, dim in (("rgb", 48), ("obj", 20)):
        table = {}
        for vid, n in (("P01_01", 90), ("P02_113", 40)):
            frames = {i: (rng.standard_normal(dim) * 3).astype(np.float32)
                      for i in range(1, n + 1) if rng.random() > 0.15}
            frames[n + 1] = np.zeros(dim, np.float32)  # an all-zero frame
            table[vid] = frames
        pairs = [(f"{vid}_frame_{fid:010d}.jpg".encode(), feat.tobytes())
                 for vid, d in table.items() for fid, feat in d.items()]
        pairs.append((b"__keys_that_are_not_frames__", b"\0" * 8))
        write_lmdb(root / name, pairs)
        out[name] = (root / name, table)
    return root, out


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "meta.json" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and match == names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_packed_store_is_the_jax_tools_byte_for_byte(jax_packer, lmdb_root,
                                                    tmp_path, dtype):
    _, envs = lmdb_root
    src, table = envs["rgb"]
    jax_packer.pack_one(src, tmp_path / "jax", dtype)
    store = PF.pack_one(src, tmp_path / "port", dtype)
    _same_files(tmp_path / "jax", tmp_path / "port")
    # and it serves the LMDB's features (to its dtype's precision)
    tol = {"float32": 0.0, "bfloat16": 2.0 ** -8, "int8": 1 / 127}[dtype]
    for vid, frames in table.items():
        fids = np.asarray(sorted(frames))
        want = np.stack([frames[f] for f in fids])
        got = store.get_frames(vid, fids)
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= tol * scale + 1e-30).all(), vid


def test_root_mode_packs_every_modality(jax_packer, lmdb_root, tmp_path):
    root, envs = lmdb_root
    argv = sys.argv  # the JAX tool's command line on the same root
    try:
        sys.argv = ["pack_features.py", "--root", str(root),
                    str(tmp_path / "jax"), "--dtype", "bfloat16"]
        jax_packer.main()
    finally:
        sys.argv = argv
    PF.main(["--root", str(root), str(tmp_path / "port"), "--dtype",
             "bfloat16"])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(envs)
    for name in envs:
        _same_files(tmp_path / "jax" / name, tmp_path / "port" / name)
        assert PackedFeatureStore(tmp_path / "port" / name).dtype_name \
            == "bfloat16"
