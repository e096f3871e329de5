"""Rules of the port that hold without a GPU.

- No file of afft_tpu_torch, and not chip_smoke.py, imports jax, afft_tpu,
  ml_dtypes or lmdb; importing the data pipeline loads none of them;
  tools/torch_turns.py and the code its workloads run import neither jax
  nor afft_tpu.
- afft_tpu_torch/conf is a byte-for-byte copy of afft_tpu/conf; the port's
  LMDB reader source is native/lmdb_reader.cpp but for its binding's path.
- Entry points run on the card by default and raise without CUDA; the
  launcher trains expt 99 end to end with ``--device cpu``.
- Importing the kernel modules needs neither nvcc nor a GPU.
- The _target_ registry resolves the ported targets and rejects the rest.
- Training works for the per-timestep fusers and raises, naming the roadmap,
  for what is not ported; the serving kernels refuse to run under autograd.
- No CUDA source sums with atomics; the wgmma / TMA GEMM is reached only
  from the bf16 paths (fp32 stays on gemm_f32 / gemm_tn_f32).
"""

import ast
import filecmp
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from afft_tpu_torch import resolve_device, serve
from afft_tpu_torch.config import CONF_DIR, compose, instantiate, \
    read_expt_file
from afft_tpu_torch.config.registry import resolve_target
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.models.layers import RngStream
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "afft_tpu_torch")
FLAGSHIP = os.path.join(REPO, "expts", "01_SA-Fuser_ek100_val_Swin.txt")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_afft_tpu():
    files = _port_files()
    assert len(files) > 23
    names = {os.path.relpath(p, PKG) for p in files}
    assert {"ops/attention.py", "ops/fused_seq_block.py",
            "models/fusion.py", "models/predictor.py",
            "ops/fused_block_train.py", "ops/fused_gpt2_train.py",
            "train/losses.py", "train/mixup.py", "train/optim.py",
            "train/runner.py", "train/loop.py", "train/checkpoint.py",
            "train/metrics.py", "data/readers.py", "data/dataset.py",
            "data/loader.py", "data/device_cache.py", "data/lmdb_native.py",
            "run.py", "tools/make_accept_dataset.py",
            "tools/reproduce_reference.py", "tools/train_check.py"} <= names
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "afft_tpu", "ml_dtypes",
                                  "lmdb")]
    assert not bad, bad


@pytest.mark.parametrize("workload", ["startup", "serve", "long"])
def test_turns_tool_imports_neither_jax_nor_afft_tpu(workload):
    """``tools/torch_turns.py`` and the code each of its workloads runs in a
    tree's fresh process import torch and the trees' own code only, and
    every workload has a default order of turns over both trees."""
    path = os.path.join(REPO, "tools", "torch_turns.py")
    spec = importlib.util.spec_from_file_location("torch_turns", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    child, order = tool.WORKLOADS[workload]
    tree = ast.parse(child)
    modules = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
               for a in n.names]
    modules += [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)]
    modules += list(_imported_modules(path))
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "afft_tpu")], modules
    assert set(order) == {"p", "c"}
    with pytest.raises(SystemExit):
        tool.main([workload])  # both trees are required


def test_data_pipeline_imports_neither_jax_nor_afft_tpu():
    code = ("import sys, afft_tpu_torch.data, afft_tpu_torch.data.stats, "
            "afft_tpu_torch.data.device_cache, "
            "afft_tpu_torch.data.lmdb_native, afft_tpu_torch.train.loop, "
            "afft_tpu_torch.tools.make_accept_dataset; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'afft_tpu', 'ml_dtypes', 'lmdb')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _assert_same_tree(cmp):
    assert not cmp.left_only and not cmp.right_only, \
        (cmp.left, cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(cmp.left, cmp.right,
                                           cmp.common_files, shallow=False)
    assert not mismatch and not errors, (cmp.left, mismatch, errors)
    for sub in cmp.subdirs.values():
        _assert_same_tree(sub)


def test_conf_is_a_byte_identical_copy():
    _assert_same_tree(filecmp.dircmp(os.path.join(REPO, "afft_tpu", "conf"),
                                     CONF_DIR, ignore=["__pycache__"]))


def test_lmdb_reader_is_a_copy_of_the_native_one():
    """The port's LMDB reader source equals native/lmdb_reader.cpp, apart
    from the path of the module that binds it, so the two cannot drift."""
    with open(os.path.join(REPO, "native", "lmdb_reader.cpp")) as f:
        native = f.read()
    with open(os.path.join(PKG, "native", "lmdb_reader.cpp")) as f:
        port = f.read()
    assert "afft_tpu_torch/data/lmdb_native.py" in port
    assert port.replace("afft_tpu_torch/data/lmdb_native.py",
                        "afft_tpu/data/lmdb_native.py") == native


def _skip_with_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_default_device_raises_without_cuda():
    _skip_with_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_server_default_device_raises_without_cuda():
    _skip_with_cuda()
    cfg = serve.load_config(os.path.join(REPO, "expts",
                                         "99_synth_smoke_val.txt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Server(cfg, {"action": 5})


def test_runner_default_device_raises_without_cuda():
    _skip_with_cuda()
    cfg = serve.load_config(os.path.join(REPO, "expts",
                                         "99_synth_smoke_val.txt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner.from_config(cfg, {"action": 5})
    runner = Runner.from_config(cfg, {"action": 5}, device="cpu")
    assert runner.device == torch.device("cpu")


@pytest.mark.parametrize("tool, argv", [
    ("reproduce_reference", ["--expt", "99_synth_smoke_val", "--metric",
                             "atop1", "--expect", "0"]),
    ("train_check", ["--steps", "2"])])
def test_check_tools_default_device_raises_without_cuda(tool, argv):
    _skip_with_cuda()
    module = importlib.import_module(f"afft_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_serve_cli_default_device_exits_nonzero():
    _skip_with_cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.serve", "-c",
         "expts/99_synth_smoke_val.txt", "--batch", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_launcher_default_device_exits_nonzero(tmp_path):
    _skip_with_cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.run", "-c",
         os.path.join(REPO, "expts", "99_synth_smoke_train.txt"), "-m",
         "train"], cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "checkpoints").exists()


def test_launcher_trains_the_smoke_expt_on_cpu(tmp_path):
    """python -m afft_tpu_torch.run -c expts/99_synth_smoke_train.txt -m
    train --device cpu: two epochs, best and last checkpoints, a finite
    loss per epoch; a second run with train.resume=true continues."""
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    cmd = [sys.executable, "-m", "afft_tpu_torch.run", "-c",
           os.path.join(REPO, "expts", "99_synth_smoke_train.txt"), "-m",
           "train", "--device", "cpu", "use_wandb=false"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, = (tmp_path / "checkpoints").glob("*synth-smoke")
    assert (out / "checkpoint_best").is_file()
    assert (out / "checkpoint_last").is_file()
    epochs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [e["_step"] for e in epochs] == [1, 2]
    assert all(np.isfinite(e["train_total_loss"]) for e in epochs)
    proc = subprocess.run(cmd + ["train.resume=true", "train.num_epochs=3"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Resumed from" in proc.stderr
    epochs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [e["_step"] for e in epochs] == [1, 2, 3]


def test_serve_cli_on_cpu_answers_and_marks_random_init():
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.serve", "-c",
         "expts/99_synth_smoke_val.txt", "--device", "cpu", "--batch", "5",
         "--requests", "2", "--dtype", "float32", "--num-classes",
         "action:11"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "RANDOM-INIT" in lines[0]
    summary = json.loads(lines[-1])
    assert summary["requests"] == 2 and summary["clips"] == 5
    assert 0 <= summary["top1_of_first_clip"] < 11


def test_kernel_modules_import_without_nvcc():
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = ("import afft_tpu_torch.ops.fused_block, "
            "afft_tpu_torch.ops.fused_gpt2, afft_tpu_torch.ops.attention, "
            "afft_tpu_torch.ops.fused_seq_block, "
            "afft_tpu_torch.ops.fused_block_train, "
            "afft_tpu_torch.ops.fused_gpt2_train, afft_tpu_torch.ops.gemm, "
            "afft_tpu_torch.train.runner, sys; "
            "assert 'triton' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_registry_resolves_ported_targets_only():
    from afft_tpu_torch.models import cmfp, fusion, mapping as maps
    for name in ("ModalTokenCMFuser", "CMFuser", "TemporalCMFuser",
                 "TemporalCrossAttentFuser", "MATT"):
        assert resolve_target(f"models.fusion.{name}") is \
            getattr(fusion, name)
    for name in ("CMFPEarly", "IndividualFuturePrediction",
                 "CMFPScoreFusion"):
        assert resolve_target(f"models.future_prediction.{name}") is \
            getattr(cmfp, name)
    for name, cls in (("GatedLinear", maps.GatedLinearMapping),
                      ("NonLinear", maps.NonLinearMapping),
                      ("GatedEmbeddingUnit", maps.GatedEmbeddingUnit)):
        assert resolve_target(f"models.feature_mapping.{name}") is cls
    mapping = instantiate({"_target_": "models.feature_mapping.Linear",
                           "use_layernorm": False}, in_features=8,
                          out_features=8)
    assert mapping.identity
    for target in ("models.fusion.RULSTM",
                   "models.future_prediction.CMFPLate",
                   "models.feature_mapping.Conv",
                   "torch.optim.RMSprop", "os.system"):
        with pytest.raises(ValueError, match=target.replace(".", r"\.")):
            resolve_target(target)
    from afft_tpu_torch.train import optim
    assert resolve_target("torch.optim.SGD") is optim.sgd
    assert resolve_target("common.scheduler.Warmup") is optim.warmup_wrap


def test_flagship_builds_at_full_width():
    """expts/01_SA-Fuser_ek100_val_Swin.txt composes over the port's conf
    and builds the ~388M-parameter model (on the meta device: no memory)."""
    cfg = compose(CONF_DIR, read_expt_file(FLAGSHIP))
    with torch.device("meta"):
        model = BaseModel(cfg.model, num_classes={"action": 3806})
    n_params = sum(p.numel() for p in model.parameters())
    assert 380e6 < n_params < 395e6
    cmfp = model.future_predictor
    assert len(cmfp.fuser.blocks) == 6 and cmfp.fuser.num_heads == 4
    assert cmfp.future_predictor.n_head == 4
    assert cmfp.future_predictor.gpt_model.h[0].attn.c_attn.weight.shape \
        == (2048, 6144)


@pytest.mark.parametrize("expt,fuser,blocks,n_params", [
    ("02_SA-Fuser_wo_token_ek100_train.txt", "CMFuser", 6, 388.3e6),
    ("03_T-SA-Fuser_ek100_train.txt", "TemporalCMFuser", 6, 388.4e6),
    ("04_CA-Fuser_ek100_train.txt", "TemporalCrossAttentFuser", 3, 363.2e6)])
def test_fuser_variants_build_at_full_width(expt, fuser, blocks, n_params):
    """expts 02, 03 and 04 compose over the port's conf and build at full
    width (on the meta device: no memory)."""
    cfg = compose(CONF_DIR, read_expt_file(os.path.join(REPO, "expts", expt)))
    with torch.device("meta"):
        model = BaseModel(cfg.model, num_classes={"action": 3806})
    got = model.future_predictor.fuser
    assert type(got).__name__ == fuser and len(got.blocks) == blocks
    assert got.num_heads == 4
    total = sum(p.numel() for p in model.parameters())
    assert abs(total - n_params) < 0.2e6, total


def test_unported_parts_still_raise_naming_the_roadmap():
    """Expts 00 and 05 build at full width with the JAX package's parameter
    counts (on the meta device: no memory); every fuser trains, expts 03
    and 04 included; an unknown ``_target_`` still raises naming
    ROADMAP.md."""
    for expt, cmfp, n_params in (
            ("00_RGB_Swin_ek100_train.txt", "IndividualFuturePrediction",
             312.346334e6),
            ("00_RGB_TSN_ek100_train.txt", "IndividualFuturePrediction",
             312.346334e6),
            ("05_MATT_ek100_train.txt", "CMFPScoreFusion", 1249.15782e6)):
        cfg = compose(CONF_DIR,
                      read_expt_file(os.path.join(REPO, "expts", expt)))
        with torch.device("meta"):
            model = BaseModel(cfg.model, num_classes={"action": 3806})
        assert type(model.future_predictor).__name__ == cmfp
        assert sum(p.numel() for p in model.parameters()) == n_params
    with pytest.raises(ValueError, match=r"ROADMAP\.md"):
        resolve_target("models.fusion.NoSuchFuser")
    # training mode: the SA-Fuser (flagship, synthetic smoke expt) trains ...
    cfg = serve.load_config(os.path.join(REPO, "expts",
                                         "99_synth_smoke_val.txt"))
    model = BaseModel(cfg.model, num_classes={"action": 5})
    assert model.training
    feats = {m: torch.zeros(2, 4, 24) for m in ("rgb", "flow")}
    out = model(feats, rng=RngStream(0))
    assert out["logits/action"]["all-fused"].shape == (2, 1, 5)
    assert out["logits/action"]["all-fused"].requires_grad
    # ... and so do expts 02, 03 (T-SA-Fuser) and 04 (CA-Fuser), at a
    # narrow width
    narrow = ["model.modal_dims={rgb:32, objects:20, audio:32, flow:32}",
              "model.common_dim=32", "model.fuser.depth=2",
              "model.common.fp_inter_dim=64", "model.common.fp_layers=2"]
    wide = {"rgb": 32, "objects": 20, "audio": 32, "flow": 32}
    for expt in ("02_SA-Fuser_wo_token_ek100_train.txt",
                 "03_T-SA-Fuser_ek100_train.txt",
                 "04_CA-Fuser_ek100_train.txt"):
        cfg = serve.load_config(os.path.join(REPO, "expts", expt),
                                [n for n in narrow
                                 if "depth" not in n or "04" not in expt])
        model = BaseModel(cfg.model, num_classes={"action": 5})
        feats = {m: torch.zeros(2, 10, d) for m, d in wide.items()}
        out = model(feats, rng=RngStream(0))
        assert out["logits/action"]["all-fused"].requires_grad
        assert model.eval()(feats)["logits/action"]["all-fused"].shape \
            == (2, 1, 5)


def test_serving_kernels_refuse_to_run_under_autograd():
    """The serving kernels have no backward: their operand check raises
    where a gradient would be recorded (the check runs before a CUDA
    launch; here it is called as the wrappers call it)."""
    from afft_tpu_torch.ops._common import check_no_grad, check_operands
    x = torch.zeros(2, 3, 8)
    w = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        check_no_grad("fused_block", [x, None, w])
    with pytest.raises(RuntimeError, match="no backward"):
        check_operands("gpt2_attn_half", x, {"w": w})
    with torch.no_grad():
        check_operands("gpt2_attn_half", x, {"w": w})
    check_operands("fused_block_train", x, {"w": w}, differentiable=True)
    check_no_grad("fused_block", [x, w.detach()])


def test_serve_cli_output_len_serves_the_rollout():
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.serve", "-c",
         "expts/99_synth_smoke_val.txt", "--device", "cpu", "--batch", "3",
         "--requests", "1", "--dtype", "float32", "--num-classes",
         "action:11", "--output-len", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["output_len"] == 3 and summary["clips"] == 3
    assert 0 <= summary["top1_of_first_clip"] < 11


CSRC = os.path.join(PKG, "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _body(src, name):
    """The brace-delimited body of the function ``name`` defined in src."""
    m = re.search(rf"^static [\w:<>* ]+\b{name}\(", src, re.M)
    assert m, name
    start = src.index("{", m.end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"unbalanced braces in {name}")


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(CSRC, "*.cu*"))))
def test_cuda_sources_sum_without_atomics(name):
    assert "atomicAdd" not in _source(name)


def test_hopper_gemm_only_on_the_bf16_path():
    """gemm_kn and gemm_nk send bf16 to the wgmma / TMA GEMM (gemm_nk to its
    K-major B route) and fp32 to launch_gemm (gemm_f32), gemm_tn bf16 to its
    TN route and fp32 to gemm_tn_f32. Both GPT-2 serving halves and the
    GPT-2 training forward reach the GEMM through gemm_kn only; the fuser
    blocks' serving forward (fused_block.cu, and seq_block.cu's
    self-attention and MLP stages) and training forward (train_block.cuh
    fwd_gemm's fuser branch) through gemm_nk only, beside the staged fuser
    attention (the training forward's with its dropout, through
    attention_drop); the training backward through the shared helpers
    launch_dx (the fuser's (K, N) products on gemm_kn, the GPT-2 layer's (N,
    K) products on gemm_nk) and launch_dw (every weight gradient), its
    attention through attention_bwd.cuh alone, which also gives dWproj its
    operand (no forward attention launched again). The
    decoder block (seq_block.cu run_decoder_block) runs its four cross
    products on gemm_nk and both its attentions on the sequence attention,
    which attention.cu launches too. launch_gemm< (gemm_f32) is left only in
    the fp32 branches of gemm_kn / gemm_nk. The wmma GEMM (gemm_bf16,
    nvcuda::wmma) and its gemm_tn_bf16, small_attention, the training
    forward's small_attention_drop, the training backward's
    small_attention_drop_bwd, strided_attention and the packed attention
    launcher are gone. Past the short kernels' lengths the training
    attention and its backward take the long route (long_attention.cuh),
    on the tensor-core forms for bf16 with rounded probabilities."""
    header = _source("gemm_sm90.cuh")
    bf16_branch, fp32_branch = _body(header, "gemm_kn").split("} else {")
    assert "if constexpr (std::is_same<T, bf16>::value)" in bf16_branch
    assert "launch_gemm_sm90<EPI, TOut>" in bf16_branch
    assert "launch_gemm<" in fp32_branch and "sm90" not in fp32_branch
    bf16_branch, fp32_branch = _body(header, "gemm_nk").split("} else {")
    assert "if constexpr (std::is_same<T, bf16>::value)" in bf16_branch
    assert "launch_gemm_sm90<EPI, TOut, true, TRes>" in bf16_branch
    assert "launch_gemm<EPI, false, TRes, TOut>" in fp32_branch
    assert "sm90" not in fp32_branch
    assert "launch_gemm_tn_sm90(" in _body(header, "gemm_tn")
    assert "static cudaError_t gemm_tn(const float*" in header
    for name in glob.glob(os.path.join(CSRC, "*.cu*")):
        assert "gemm_tn_bf16" not in _source(os.path.basename(name))

    for name in glob.glob(os.path.join(CSRC, "*.cu*")):
        src = _source(os.path.basename(name))
        assert not re.search(r"\bsmall_attention\b", src), name
        assert not re.search(r"\bsmall_attention_drop\b", src), name
        assert "small_attention_drop_bwd" not in src, name
        assert "launch_packed_attention" not in src, name
        for gone in ("gemm_bf16", "strided_attention", "nvcuda::wmma",
                     "wmma::", "<mma.h>"):
            assert gone not in src, (name, gone)
        # gemm_f32's launcher: the fp32 branches of gemm_kn and gemm_nk
        expected = {"gemm_sm90.cuh": 2}
        assert src.count("launch_gemm<") == expected.get(
            os.path.basename(name), 0), name
    block = _body(_source("fused_block.cu"), "run_fused_block")
    assert block.count("gemm_nk<") == 4 and "launch_gemm<" not in block
    assert "launch_fuser_attention_rows<" in block
    seq = _source("seq_block.cu")
    for stage, attention in (("run_self_attn_stage",
                              "launch_fuser_attention_seq<"),
                             ("run_mlp_stage", None)):
        body = _body(seq, stage)
        assert body.count("gemm_nk<") == 2 and "launch_gemm<" not in body
        assert attention is None or attention in body
    # the decoder block: its self-attention stage (one attention launch)
    # and its cross stage, four products on gemm_nk (the cross proj adding
    # into the fp32 residual stream in place) and the second attention
    decoder = _body(seq, "run_decoder_block")
    assert decoder.count("gemm_nk<") == 4 and "launch_gemm<" not in decoder
    assert "gemm_nk<EPI_BIAS_RES, T, float, float>" in decoder
    assert decoder.count("run_self_attn_stage<") == 1
    self_attn = _body(seq, "run_self_attn_stage")
    assert (decoder.count("launch_fuser_attention_seq<")
            + self_attn.count("launch_fuser_attention_seq<")) == 2
    # row 4: one launch of the same attention
    attention = _source("attention.cu")
    assert attention.count("launch_fuser_attention_seq<") == 2  # fp32, bf16
    assert "launch_" not in attention.replace(
        "launch_fuser_attention_seq<", "")

    gpt2 = _source("fused_gpt2.cu")
    assert "launch_gemm" not in gpt2
    for half in ("run_attn_half", "run_mlp_half"):
        assert _body(gpt2, half).count("gemm_kn<") == 2

    train = _source("train_block.cuh")
    assert "launch_gemm_sm90" not in train and "launch_gemm_tn" not in train
    assert "launch_gemm<" not in train
    gpt2_branch, fuser_branch = _body(train, "fwd_gemm").split("} else {")
    assert "if constexpr (GPT2)" in gpt2_branch
    assert "gemm_kn<EPI, T>" in gpt2_branch
    assert "gemm_nk<EPI, T, TRes, TOut>" in fuser_branch
    fwd = _body(train, "run_fwd")
    assert fwd.count("fwd_gemm<") == 4 and "launch_gemm<" not in fwd
    assert fwd.count("attention_drop<") == 1
    gpt2_branch, fuser_branch = _body(train, "attention_drop").split(
        "} else {")
    assert "launch_staged_attention<T, true>" in gpt2_branch
    assert "launch_fuser_attention_rows<T, true>" in fuser_branch
    bwd_attn = _body(train, "run_bwd_attn")
    assert "attention_drop<" not in bwd_attn
    assert bwd_attn.count("attention_drop_bwd<T, GPT2>") == 1
    # the attention backward: attention_bwd.cuh up to the short length,
    # past it the long route's backward (which recomputes its own O)
    short, long = _body(train, "attention_drop_bwd").split(
        "LongAttn a =")
    assert short.count("launch_attention_bwd<T, GPT2>") == 1
    assert long.count("launch_long_attention_bwd<T, GPT2, true>") == 1
    assert "launch_long_attention<T, GPT2, true>" in _body(
        train, "attention_drop")
    # the long route's launchers pick the form by type: the tensor-core
    # kernels (long_attention_mma and its backward) for bf16 with ROUND,
    # the CUDA-core ones (long_attention_f32rows) otherwise
    la = _source("long_attention.cu")
    assert la.count(
        "if constexpr (std::is_same<T, bf16>::value && ROUND)") == 2
    for mma in ("launch_long_mma", "launch_long_mma_bwd"):
        assert "f32rows" not in _body(la, mma)
    gpt2_branch, fuser_branch = _body(train, "launch_dx").split("} else {")
    assert "if constexpr (GPT2)" in gpt2_branch
    assert "gemm_nk<EPI, T, T, TOut>" in gpt2_branch
    assert "gemm_kn<EPI, T, TOut>" in fuser_branch
    assert _body(train, "launch_dw").count("gemm_tn(") == 2
    for entry, dx, dw in (("run_bwd_mlp", 2, 2), ("run_bwd_attn", 2, 2)):
        body = _body(train, entry)
        assert "fwd_gemm" not in body and "launch_gemm" not in body
        assert body.count("launch_dx<") == dx
        assert body.count("launch_dw<") == dw
