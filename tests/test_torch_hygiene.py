"""Rules of the port that hold without a GPU.

- No file of afft_tpu_torch, and not chip_smoke.py, imports jax or afft_tpu.
- afft_tpu_torch/conf is a byte-for-byte copy of afft_tpu/conf.
- Entry points run on the card by default and raise without CUDA.
- Importing the kernel modules needs neither nvcc nor a GPU.
- The _target_ registry resolves the ported targets and rejects the rest.
"""

import ast
import filecmp
import json
import os
import subprocess
import sys

import pytest
import torch

from afft_tpu_torch import resolve_device, serve
from afft_tpu_torch.config import CONF_DIR, compose, instantiate, \
    read_expt_file
from afft_tpu_torch.config.registry import resolve_target
from afft_tpu_torch.models import BaseModel

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
    assert len(files) > 15
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "afft_tpu")]
    assert not bad, bad


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


def test_serve_cli_default_device_exits_nonzero():
    _skip_with_cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.serve", "-c",
         "expts/99_synth_smoke_val.txt", "--batch", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


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
            "afft_tpu_torch.ops.fused_gpt2, sys; "
            "assert 'triton' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_registry_resolves_ported_targets_only():
    from afft_tpu_torch.models.fusion import ModalTokenCMFuser
    assert resolve_target("models.fusion.ModalTokenCMFuser") is \
        ModalTokenCMFuser
    mapping = instantiate({"_target_": "models.feature_mapping.Linear",
                           "use_layernorm": False}, in_features=8,
                          out_features=8)
    assert mapping.identity
    for target in ("models.fusion.CMFuser", "torch.optim.SGD",
                   "os.system"):
        with pytest.raises(ValueError, match=target.replace(".", r"\.")):
            resolve_target(target)


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
