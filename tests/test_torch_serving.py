"""The port's serving extras against the JAX package's, on the CPU.

Mirrors tests/test_export_serving.py and tests/test_serve_concurrent.py:
- the port's bundle (``afft_tpu_torch.tools.export_serving`` /
  ``serve_bundle``) round trip against ``Server.logits`` and the JAX
  ``build_serving_fn`` (tools/export_serving.py:49-102) from the same
  weights (``weights.state_dict_from_jax``): dense logits, top-k (indices
  equal), the rollout's (B, output_len, C) and int8 input, at atol 2e-5,
  rtol 1e-5 (fp32; the summation order differs);
- the port's int8 quantizer equals ``PackedFeatureStore._quantize_rows`` of
  the JAX package bit for bit;
- wrong shapes are refused; ``meta.json`` has the JAX bundle's keys and its
  ``RANDOM-INIT`` provenance;
- ``BundleServer`` on the CPU (eager buckets 2 / 4 / 8): results equal the
  direct forward, the smallest bucket that fits is picked, a malformed
  request fails its future and not the server, empty percentiles are None,
  open and closed loops and ``--sweep`` run for under a second each;
- ``GraphServer`` refuses a CPU server.
"""

import contextlib
import io
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.data.readers import PackedFeatureStore as JaxStore
from afft_tpu_torch import serve
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose
from afft_tpu_torch.data.readers import PackedFeatureStore
from afft_tpu_torch.serving.graphs import EagerBucketServer, GraphServer
from afft_tpu_torch.tools import export_serving as PE
from afft_tpu_torch.tools import serve_bundle as PB
from afft_tpu_torch.tools import serve_concurrent as PC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

CFG = [
    "model.modal_dims={rgb: 16, flow: 16}", "model.common_dim=16",
    "model.fuser.depth=1", "model.fuser.num_heads=2",
    "model.common.fp_inter_dim=16", "model.common.fp_layers=1",
    "model.common.fp_heads=2", "model.dropout=0.0",
    "data_eval.num_frames=6"]
NUM_CLASSES = {"action": 11}
MODS = ("rgb", "flow")
ATOL, RTOL = 2e-5, 1e-5


def _jax_fn(lines, input_dtype="native", topk=0):
    """(JAX fwd, its params, the port state dict of the same weights)."""
    from export_serving import build_serving_fn
    cfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"), lines)
    model, params, fwd = build_serving_fn(cfg, NUM_CLASSES, "float32",
                                          input_dtype=input_dtype, topk=topk)
    server = serve.Server(compose(CONF_DIR, lines), NUM_CLASSES, "float32",
                          "cpu")
    sd = W.state_dict_from_jax(server.model, jax.tree.map(np.asarray, params))
    return fwd, params, sd


def _feats(b, seed=0):
    rng = np.random.default_rng(seed)
    return {m: rng.standard_normal((b, 6, 16)).astype(np.float32)
            for m in MODS}


def _quantized(feats):
    q, s = {}, {}
    for m, x in feats.items():
        qm, sm = PackedFeatureStore._quantize_rows(x.reshape(-1, 16))
        q[m], s[m] = qm.reshape(x.shape), sm.reshape(x.shape[:2])
    return q, s


def _t(d):
    return {m: torch.from_numpy(x) for m, x in d.items()}


def _load(bundle):
    """(the CPU's bucket server, meta) of a bundle."""
    return PB.load_bundle_buckets(bundle, "cpu", log=lambda *a: None)


def _export(tmp_path, name, lines, sd, batch, **kw):
    out = str(tmp_path / name)
    PE.export_bundle(lines, out, NUM_CLASSES, batch, "float32",
                     log=lambda *a: None, device="cpu", weights=sd, **kw)
    return out


@pytest.mark.parametrize("case", ["dense", "topk", "rollout", "int8"])
def test_bundle_roundtrip_matches_server_and_jax(tmp_path, case):
    """The reloaded bundle's function equals ``Server.logits`` (the same
    model) and the JAX serving function from the same weights."""
    lines = CFG + (["model.common.fp_output_len=3"] if case == "rollout"
                   else [])
    kw = {"topk": 3} if case == "topk" else \
        {"input_dtype": "int8"} if case == "int8" else {}
    fwd, params, sd = _jax_fn(lines, **kw)
    bundle = _export(tmp_path, "b", lines, sd, 4, **kw)
    runner, meta = _load(bundle)
    server = runner.server
    feats = _feats(4)
    if case == "int8":
        q, s = _quantized(feats)
        got = runner.run(meta["batch"], _t(q), _t(s))
        want = fwd(params, q, s)
        # the port's own eager path on the dequantized features
        deq = {m: serve.dequantize(torch.from_numpy(q[m]),
                                   torch.from_numpy(s[m]), torch.float32)
               for m in MODS}
        np.testing.assert_array_equal(got.numpy(),
                                      server.logits(deq).numpy())
    else:
        got = runner.run(meta["batch"], _t(feats))
        want = fwd(params, feats)
    if case == "topk":
        vals, idx = got
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want[0]),
                                   atol=ATOL, rtol=RTOL)
        dense = server.logits(_t(feats))
        np.testing.assert_array_equal(
            vals.numpy(), torch.topk(dense, 3, dim=-1).values.numpy())
        return
    shape = (4, 3, 11) if case == "rollout" else (4, 11)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert meta["output_len"] == (3 if case == "rollout" else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if case != "int8":
        np.testing.assert_array_equal(got.numpy(),
                                      server.logits(_t(feats)).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantizer_equals_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((40, 24)) * 10.0 ** rng.integers(
        -3, 3, (40, 1))).astype(np.float32)
    x[3] = 0.0
    x[7, :5] = 0.0
    q, s = PackedFeatureStore._quantize_rows(x)
    jq, js = JaxStore._quantize_rows(x)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))


def test_bundle_rejects_wrong_shapes(tmp_path):
    fwd, params, sd = _jax_fn(CFG)
    bundle = _export(tmp_path, "b", CFG, sd, [2, 4])
    runner, _ = _load(bundle)
    good = _t(_feats(4))
    for bad in ({m: torch.zeros(3, 6, 16) for m in MODS},      # batch
                {m: torch.zeros(4, 5, 16) for m in MODS},      # frames
                {m: torch.zeros(4, 6, 15) for m in MODS},      # width
                {"rgb": torch.zeros(4, 6, 16)}):               # modality
        with pytest.raises(ValueError):
            runner.run(4, bad)
    with pytest.raises(ValueError):
        runner.run(3, good)                                    # no bucket
    with pytest.raises(ValueError):
        runner.run(4, good, {m: torch.ones(4, 6) for m in MODS})  # scales
    assert runner.run(4, good).shape == (4, 11)


def test_meta_has_the_jax_keys_and_provenance(tmp_path):
    from export_serving import export_bundle as jax_export
    jax_dir = str(tmp_path / "jax")
    jax_export(jax_compose(os.path.join(REPO, "afft_tpu/conf"), CFG),
               jax_dir, NUM_CLASSES, [2, 4, 8], 6, "float32",
               log=lambda *a: None, input_dtype="int8", topk=3)
    with open(os.path.join(jax_dir, "meta.json")) as f:
        want = json.load(f)
    bundle = str(tmp_path / "port")
    PE.export_bundle(CFG, bundle, NUM_CLASSES, [8, 2, 4], "float32",
                     log=lambda *a: None, device="cpu", input_dtype="int8",
                     topk=3)
    meta = PB.read_meta(bundle)
    assert set(meta) == (set(want) - {"jax_version"}) | {"torch_version",
                                                         "expt_lines"}
    for key in ("batch", "batch_buckets", "input_dtype", "topk",
                "output_len", "num_frames", "modal_dims", "feat_dtype",
                "num_classes", "ckpt_paths"):
        assert meta[key] == want[key], key
    assert meta["ckpt_paths"].startswith("RANDOM-INIT")
    assert meta["platforms"] == ["cuda"]
    assert meta["torch_version"] == torch.__version__
    assert meta["expt_lines"] == CFG
    # the bundle rebuilds its model from its own files
    server = _load(bundle)[0].server
    sd = torch.load(os.path.join(bundle, PE.BUNDLE_WEIGHTS))
    for k, v in server.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_graph_server_refuses_the_cpu():
    server = serve.Server(compose(CONF_DIR, CFG), NUM_CLASSES, "float32",
                          "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        GraphServer(server, [2, 4])
    eager = EagerBucketServer(server, [4, 2])
    assert eager.buckets == [2, 4] and eager.stream is None


# -- the concurrent server on the CPU -----------------------------------------

@pytest.fixture(scope="module")
def bucket_bundle(tmp_path_factory):
    fwd, params, sd = _jax_fn(CFG)
    out = str(tmp_path_factory.mktemp("serve") / "bundle")
    PE.export_bundle(CFG, out, NUM_CLASSES, [2, 4, 8], "float32",
                     log=lambda *a: None, device="cpu", weights=sd)
    return out


def _clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{m: rng.standard_normal((6, 16)).astype(np.float32)
             for m in MODS} for _ in range(n)]


def _server(bundle, **kw):
    return PC.BundleServer(bundle, device="cpu", log=lambda *a: None, **kw)


def test_concurrent_results_match_direct_forward(bucket_bundle):
    """9 clips from 3 threads: each result equals the clip's own forward in
    the largest bucket, padded with zeros, however the scheduler batched
    them (every op is row-local)."""
    runner, _ = _load(bucket_bundle)
    clips = _clips(9, seed=1)
    refs = [runner.run(8, {m: torch.from_numpy(np.concatenate(
        [c[m][None], np.zeros((7, 6, 16), np.float32)])) for m in c})[0]
        .numpy() for c in clips]
    server = _server(bucket_bundle, max_wait_ms=20.0)
    try:
        futs = [None] * len(clips)

        def submit(lo, hi):
            for i in range(lo, hi):
                futs[i] = server.submit(clips[i])

        threads = [threading.Thread(target=submit, args=(i * 3, i * 3 + 3))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, fut in enumerate(futs):
            logits, lat = fut.result(timeout=60)
            assert lat > 0 and logits.shape == (11,)
            np.testing.assert_allclose(logits, refs[i], atol=ATOL, rtol=RTOL)
    finally:
        server.close()
    assert sum(server.batch_hist.values()) >= 1
    # each thread's host seconds by stage; a native bundle quantizes nothing
    times = server.take_host_times()
    assert set(times) == set(PC.HOST_STAGES) | {"wall_s"}
    assert min(times[k] for k in ("assemble", "stage", "replay",
                                  "complete")) > 0
    assert times["quantize"] == 0.0
    assert sum(times[k] for k in PC.HOST_STAGES) <= 2 * times["wall_s"]
    assert server.take_host_times()["replay"] == 0.0


def test_bucket_selection_smallest_fit(bucket_bundle):
    server = _server(bucket_bundle, max_wait_ms=1.0)
    try:
        server.submit(_clips(1)[0]).result(timeout=60)
        assert server.batch_hist == {2: 1, 4: 0, 8: 0}
    finally:
        server.close()
    server = _server(bucket_bundle, max_wait_ms=200.0)
    try:
        for f in [server.submit(c) for c in _clips(6, seed=2)]:
            f.result(timeout=60)
        # one 200 ms coalescing window: one batch of 6 -> bucket 8
        assert server.batch_hist[8] == 1, server.batch_hist
    finally:
        server.close()


def test_malformed_request_fails_future_not_server(bucket_bundle):
    server = _server(bucket_bundle, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError):
            server.submit({m: np.zeros((6, 99), np.float32)
                           for m in MODS}).result(timeout=60)
        with pytest.raises(KeyError):
            server.submit({"rgb": np.zeros((6, 16), np.float32)}).result(
                timeout=60)
        logits, _ = server.submit(_clips(1)[0]).result(timeout=60)
        assert logits.shape == (11,)
    finally:
        server.close()


def test_percentiles_empty_is_none():
    assert PC._percentiles([]) == {"p50_ms": None, "p95_ms": None,
                                   "p99_ms": None, "mean_ms": None}


def test_open_and_closed_loop_smoke(bucket_bundle):
    server = _server(bucket_bundle, max_wait_ms=2.0)
    try:
        res = PC.run_open_loop(server, rate_hz=200.0, duration_s=0.5)
        assert res["requests"] > 0 and res["p99_ms"] > 0
        res2 = PC.run_closed_loop(server, n_clients=4, duration_s=0.5)
        assert res2["throughput_clips_per_sec"] > 0
        assert res2["p50_ms"] <= res2["p99_ms"]
    finally:
        server.close()


def test_int8_transport_topk_server(tmp_path):
    """int8 + top-k: each clip's top-1 is the dense fp32 forward's, and its
    scores lie near the dense logits (int8 rounding is the only error: the
    bound of tests/test_serve_concurrent.py, 5% of max|logit|)."""
    lines = CFG
    _, _, sd = _jax_fn(lines)
    bundle = _export(tmp_path, "i8", lines, sd, [2, 4], input_dtype="int8",
                     topk=3)
    dense = serve.Server(compose(CONF_DIR, lines), NUM_CLASSES, "float32",
                         "cpu", sd)
    clips = _clips(4, seed=3)
    refs = [dense.logits({m: torch.from_numpy(c[m][None]) for m in c})[0]
            .numpy() for c in clips]
    server = _server(bundle, max_wait_ms=20.0)
    try:
        for i, fut in enumerate([server.submit(c) for c in clips]):
            (vals, idx), _ = fut.result(timeout=60)
            assert vals.shape == (3,) and idx.shape == (3,)
            assert idx[0] == int(refs[i].argmax())
            rel = np.abs(vals - refs[i][idx]).max() / np.abs(refs[i]).max()
            assert rel < 0.05, rel
    finally:
        server.close()
    assert server.take_host_times()["quantize"] > 0


def test_clis_on_the_cpu(tmp_path):
    """export_serving, serve_bundle (a batch and --iters) and
    serve_concurrent --sweep, each through its main on --device cpu."""
    bundle = str(tmp_path / "cli")
    with contextlib.redirect_stdout(io.StringIO()):
        PE.main(["-c", os.path.join(REPO, "expts", "99_synth_smoke_val.txt"),
                 "--batch", "2,4", "--dtype", "float32", "--device", "cpu",
                 "--num-classes", "action:106", "--topk", "5",
                 "--out", bundle])
    meta = PB.read_meta(bundle)
    assert meta["batch_buckets"] == [2, 4] and meta["num_frames"] == 10
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "batch.npz", **{
        m: rng.standard_normal((2, 10, 24)).astype(np.float32)
        for m in MODS})
    for extra, bucket in (([], 4), (["--input", str(tmp_path / "batch.npz")],
                                     2)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            PB.main(["--bundle", bundle, "--device", "cpu", "--iters", "2",
                     *extra])
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        assert lines[0]["logits_shape"] == [bucket, 5]
        assert lines[1]["clips_per_sec"] > 0
    results = tmp_path / "sweep.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        PC.main(["--bundle", bundle, "--device", "cpu", "--sweep",
                 "--duration", "0.25", "--out", str(results)])
    rows = [json.loads(ln) for ln in results.read_text().splitlines()]
    assert [r["mode"] for r in rows] == ["closed-loop"] + ["open-loop"] * 3
    assert rows[0]["clients"] == 8 and rows[0]["device"] == "cpu"
    assert all(r["requests"] > 0 for r in rows)
    assert all(r["host_s"]["replay"] > 0 and r["host_s"]["wall_s"] > 0
               for r in rows)
