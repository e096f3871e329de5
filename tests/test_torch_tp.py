"""Tensor and sequence parallelism of the port on the CPU: gloo processes as
model ranks, against the JAX package and against one process.

The spawned runs go through ``python -m torch.distributed.run --standalone``
(``tests/test_torch_dp.py``'s helpers), one module-scoped run of
``afft_tpu_torch.tools.dp_check`` jobs on 2 processes and one on 4.

- The rules: for the JAX driver's tiny config and a flagship-shaped narrow
  one (4 modalities, 4 GPT-2 heads, the EK100 classes), every parameter that
  JAX's ``shard_params`` shards on ``make_mesh_2d(4, 2)`` the port shards on
  the counterpart dimension, and no other; JAX's shard of model index m,
  carried through ``weights.state_dict_from_jax`` (the c_attn head re-pack
  included), is the port's rank-m tensor.
- The shard-mode plain versions (the GPT-2 layer's halves, the fuser's MLP
  half): summed over the ranks, forward and backward at dropout 0.2, the
  unsharded plain layer within 1e-5.
- The TP step: data1 x model2 (2 processes) and data2 x model2 (4) with
  dropout 0 and mixup off against the JAX runner's step on
  ``make_mesh_2d(4, 2)`` with ``shard_params`` (as
  tests/test_integration.py:167-195 runs it); with dropout, drop-path and
  mixup on against the port's one-process step; losses and weights within
  1e-5.
- SP: data2 x model2 with ``SeqCtx`` against JAX's SP step, and with the
  rates on against one process; a T that does not divide over the model
  ranks warns once and stays whole.
- 3-axis: data1 x model2 x pipe2 against JAX's ``make_mesh_3d(2, 2, 2)`` on
  B = 16.
- ZeRO-1 at data2 x model2: 0 difference from plain data parallelism at
  data2 x model2; ``train.grad_accum=2`` and a clip that acts (with
  ``watch_gradients``' norms: each shard counted once over the model
  group, a replicated tensor once) at data2 x model2 against one process.
- Checkpoints: a TP checkpoint has a one-process run's keys and shapes,
  loads there bit for bit, and resumes at tp = 1.
- Every tensor a rank holds whole is byte for byte the same on the ranks
  of its model group; a planted fault (the LayerNorm partial sums left
  unsummed) parts them and moves the state far past the tolerance.
- Layering: ``ops`` imports nothing of ``parallel`` or ``models``, and
  ``parallel.sharding`` nothing of ``models``; the sequence dimension's
  reduce-scatter goes through ``mesh.reduce_scatter_sum``.
- The driver: ``dryrun_multichip -n 4 --device cpu`` prints every mode n = 4
  allows; it spawns its processes once; the new modules import neither jax
  nor afft_tpu.
"""

import ast
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.parallel.mesh import replicate_tree, shard_batch
from afft_tpu.parallel.pipeline import PipelineCtx as JaxPipelineCtx
from afft_tpu.parallel.sharding import (SeqCtx as JaxSeqCtx, make_mesh_2d,
                                        make_mesh_3d, shard_params)
from afft_tpu.train import optim as JO
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models.layers import neg_inf_causal_mask
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.parallel import sharding as SH
from afft_tpu_torch.tools import dp_check as D
from afft_tpu_torch.tools import dryrun_multichip as DRY
from afft_tpu_torch.train import checkpoint as CK
from afft_tpu_torch.train.runner import Runner

from test_torch_dp import (CLASSES, GLOBAL_BATCH, NO_DROPOUT, RATES, REPO,
                           SMOKE_TRAIN, STEPS, _assert_runs_agree, _lrs,
                           _spawn, _torchrun)

NO_MIXUP = NO_DROPOUT + ["train.use_mixup=false"]
PIPE2 = ["train.pipeline_stages=2", "train.pipeline_microbatches=2"]
ZERO = "train.zero_sharding=true"
ACCUM = "train.grad_accum=2"
# a clip that acts, and the norms it reads in the metric stream
CLIP = ["opt.grad_clip=0.05", "train.watch_gradients=true"]
TOL = dict(atol=1e-5, rtol=1e-5)
BATCH3 = 16                         # the 3-axis loss match's batch
ODD_T = "data_train.num_frames=9"   # T over 2 model ranks leaves a rest
NEW_MODULES = ("parallel/sharding.py", "parallel/mesh.py",
               "tools/dryrun_multichip.py")
# the flagship's shapes, narrow: 4 modalities, 4 GPT-2 heads, EK100 classes
NARROW = ["model.modal_dims={rgb: 64, objects: 32, audio: 64, flow: 64}",
          "model.common_dim=64", "model.common.fp_inter_dim=64",
          "model.common.fp_layers=2", "model.common.fp_heads=4",
          "model.fuser.depth=2", "model.fuser.num_heads=4"]
NARROW_CLASSES = {"action": 3806, "verb": 97, "noun": 300}


def _train_job(name, overrides, tp=2, **more):
    return {"kind": "train", "name": name, "expt": SMOKE_TRAIN,
            "overrides": overrides, "classes": CLASSES,
            "batch": GLOBAL_BATCH, "steps": STEPS, "seed": 3,
            "lrs": _lrs(overrides), "invalid": [GLOBAL_BATCH - 1], "tp": tp,
            **more}


def _run(work, nproc, jobs):
    """The jobs on ``nproc`` gloo processes: {name: [record by rank]}."""
    (work / "tests").symlink_to(os.path.join(REPO, "tests"))
    spec = {"device": "cpu", "out": str(work / "out"), "jobs": jobs}
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)
    _spawn(_torchrun(nproc, "-m", "afft_tpu_torch.tools.dp_check",
                     str(work / "spec.json")), str(work), f"tp{nproc}.log")
    return {job["name"]: [torch.load(work / "out" / f"{job['name']}"
                                     f".rank{r}.pt", weights_only=False)
                          for r in range(nproc)] for job in jobs}


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """JAX params of the smoke expt (dropout 0, mixup off) and the port
    state dict that carries them (a file)."""
    work = tmp_path_factory.mktemp("init")
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"),
                       read_expt_file(SMOKE_TRAIN) + NO_MIXUP)
    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    params = jmodel.init(jax.random.key(11))
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + NO_MIXUP)
    model = Runner.from_config(tcfg, CLASSES, device="cpu").model
    torch.save(W.state_dict_from_jax(model, jax.tree.map(np.asarray,
                                                         params)),
               work / "model.pt")
    return {"jcfg": jcfg, "jmodel": jmodel, "params": params,
            "model": str(work / "model.pt"), "work": work}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, inits):
    """data1 x model2: the pinned step against JAX, the step with the rates
    on (its checkpoint after 2 steps), the same with a planted fault, and
    that checkpoint resumed at tp = 1 (data2)."""
    work = tmp_path_factory.mktemp("tp2")
    ckpt = str(work / "tp.ckpt")
    jobs = [_train_job("jax", NO_MIXUP, weights=inits["model"]),
            _train_job("rates", RATES, save={"path": ckpt, "after": 2}),
            _train_job("planted", RATES, plant="unsummed_norm_grads"),
            _train_job("resumed", RATES, tp=1,
                       resume={"path": ckpt, "after": 2})]
    return _run(work, 2, jobs), {j["name"]: j for j in jobs}, work


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, inits):
    """data2 x model2 (with SP) and data1 x model2 x pipe2: the pinned steps
    against JAX, the steps with the rates on, ZeRO-1 against plain data
    parallelism."""
    work = tmp_path_factory.mktemp("tp4")
    jobs = [_train_job("jax", NO_MIXUP, weights=inits["model"]),
            _train_job("rates", RATES),
            _train_job("sp_jax", NO_MIXUP, weights=inits["model"], sp=True),
            _train_job("sp", RATES, sp=True),
            _train_job("sp_odd", RATES + [ODD_T], sp=True, steps=2,
                       lrs=_lrs(RATES)[:2]),
            _train_job("accum", RATES + [ACCUM], invalid=[2, 3, 7]),
            _train_job("clip", RATES + CLIP + [ZERO]),
            _train_job("plain_tp", RATES, keep_state="host"),
            _train_job("zero", RATES + [ZERO], keep_state=False,
                       against="plain_tp"),
            _train_job("axis3", NO_MIXUP + PIPE2, weights=inits["model"],
                       batch=BATCH3, steps=2, invalid=[],
                       lrs=_lrs(NO_MIXUP + PIPE2)[:2])]
    return _run(work, 4, jobs), {j["name"]: j for j in jobs}, work


def _jax_steps(inits, mesh, *, seq=False, pipe=False, batch=GLOBAL_BATCH,
               steps=STEPS, invalid=(GLOBAL_BATCH - 1,)):
    """The JAX runner's steps (dropout 0, mixup off) with its weights
    placed by ``shard_params`` on ``mesh`` (and SeqCtx / PipelineCtx) over
    the jobs' global batches: (losses by step, the final port state)."""
    jcfg, params = inits["jcfg"], inits["params"]
    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    jrunner = JaxRunner(jmodel, joptimizer, groups,
                        loss_wts=dict(jcfg.train.loss_wts.items()),
                        mixup=None, mixup_backbone=jcfg.train.mixup_backbone,
                        grad_clip=jcfg.opt.grad_clip, donate=False)
    proto = jmodel.future_predictor.predictor_proto
    if seq:
        proto.seq_ctx = JaxSeqCtx(mesh)
    if pipe:
        proto.pipeline_ctx = JaxPipelineCtx(mesh, microbatches=2)
    opt_state = joptimizer.init(params, groups)
    opt_state = {"momentum": shard_params(mesh, opt_state["momentum"]),
                 "step": replicate_tree(mesh, opt_state["step"])}
    p = shard_params(mesh, params)
    overrides = NO_MIXUP + (PIPE2 if pipe else [])
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + overrides)
    lrs = _lrs(overrides)
    losses = []
    for i, b in enumerate(D.make_batches(tcfg, CLASSES, batch, steps, 3,
                                         list(invalid))):
        b = shard_batch(mesh, {k: v for k, v in b.items() if v is not None})
        p, opt_state, step, _, _ = jrunner.train_step(
            p, opt_state, b, lrs[i], jcfg.opt.lr, jax.random.key(i))
        losses.append({k: float(v) for k, v in step.items()})
    model = Runner.from_config(tcfg, CLASSES, device="cpu",
                               pipeline=False).model
    return losses, W.state_dict_from_jax(model, jax.tree.map(np.asarray, p))


def _assert_equals_jax(records, want):
    want_losses, want_state = want
    rank0 = records[0]
    assert all(r["losses"] == rank0["losses"] for r in records)
    assert len(rank0["losses"]) == len(want_losses)
    for i, (got, exp) in enumerate(zip(rank0["losses"], want_losses)):
        assert set(got) == set(exp)
        for k, v in exp.items():
            np.testing.assert_allclose(got[k], v, **TOL,
                                       err_msg=f"step {i} {k}")
    assert set(rank0["state"]) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(rank0["state"][k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)


# -- the rules ----------------------------------------------------------------

class _Grid:
    """A model axis of ``count`` ranks without a process group."""

    def __init__(self, count, rank=0):
        self.model_size, self.model = count, rank
        self.model_group = None


def _port_names_of_leaves(model, params):
    """{port state-dict name: the JAX leaf's index} (each JAX leaf filled
    with its own index carried through ``weights``), and the leaves with
    their paths."""
    leaves = jax.tree_util.tree_leaves_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(v), i + 1, np.float32)
         for i, (_, v) in enumerate(leaves)])
    state = W.state_dict_from_jax(model, marked)
    out = {}
    for k, v in state.items():
        vals = torch.unique(v)
        assert len(vals) == 1, k
        out[k] = int(vals[0]) - 1
    return out, leaves


@pytest.mark.parametrize("config", ["tiny", "narrow"])
def test_rules_shard_what_jax_shards_on_the_counterpart_dimension(config):
    overrides = DRY.TINY if config == "tiny" else NARROW
    classes = DRY.CLASSES if config == "tiny" else NARROW_CLASSES
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"), overrides)
    params = JaxBaseModel(jcfg.model, num_classes=classes).init(
        jax.random.key(0))
    mesh = make_mesh_2d(4, 2)
    placed = shard_params(mesh, params)
    tcfg = compose(CONF_DIR, overrides)
    model = Runner.from_config(tcfg, classes, device="cpu").model
    names, leaves = _port_names_of_leaves(model, params)
    tp = SH.TensorParallel(_Grid(2))
    SH.plan_model(model, tp)
    full = W.state_dict_from_jax(model, jax.tree.map(np.asarray, params))
    placed_leaves = jax.tree_util.tree_leaves(placed)
    seen = 0
    for name, i in names.items():
        leaf = placed_leaves[i]
        spec = tuple(leaf.sharding.spec)
        jdim = [d for d, a in enumerate(spec) if a == "model"]
        pspec = tp.specs.get(name)
        assert (pspec is not None) == bool(jdim), (name, spec, pspec)
        if not jdim:
            continue
        seen += 1
        # the counterpart dimension: nn.Linear weights are transposed
        linear = full[name].dim() == 2 and tuple(full[name].shape) != tuple(
            leaf.shape)
        want = (1 - jdim[0]) if linear else jdim[0]
        assert SH._split_dim(pspec) == want, (name, spec, pspec)
        # JAX's shard of model index m through weights.py is the port's
        # rank-m tensor: that shard alone (zeros elsewhere) carried over
        index = leaf.sharding.devices_indices_map(leaf.shape)
        for m in range(2):
            sl = index[mesh.devices[0, m]]
            alone = np.zeros(leaf.shape, np.float32)
            alone[sl] = np.asarray(leaf)[sl]
            tree = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(params),
                [alone if j == i else np.asarray(v)
                 for j, (_, v) in enumerate(leaves)])
            for r in range(2):
                tp.rank = r
                got = W.tp_state_from_jax(model, tree, tp)[name]
                if r == m:
                    np.testing.assert_array_equal(
                        got.numpy(), SH.shard_state(tp, full)[name].numpy(),
                        err_msg=name)
                else:
                    assert not got.any(), (name, m, r)
            tp.rank = 0
    assert seen >= (8 if config == "tiny" else 12)


# -- the shard-mode plain versions --------------------------------------------

def _local(p, prefix, rank, count=2):
    return {k: (SH.shard_tensor(v, SH.spec_for_path(prefix + k), rank, count)
                if SH.spec_for_path(prefix + k) is not None else v.clone())
            .detach().requires_grad_(True) for k, v in p.items()}


def _params(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(s, generator=gen) * 0.05
                + (1.0 if k.endswith("norm1.weight") or k.endswith(
                    "norm2.weight") or k.startswith("ln_") and
                   k.endswith("weight") else 0.0)).requires_grad_(True)
            for k, s in shapes.items()}


def test_gpt2_shard_plain_halves_sum_to_the_unsharded_layer():
    B, T, C, H, hidden = 3, 6, 64, 4, 256
    p = _params({"ln_1.weight": (C,), "ln_1.bias": (C,),
                 "attn.c_attn.weight": (C, 3 * C),
                 "attn.c_attn.bias": (3 * C,),
                 "attn.c_proj.weight": (C, C), "attn.c_proj.bias": (C,),
                 "ln_2.weight": (C,), "ln_2.bias": (C,),
                 "mlp.c_fc.weight": (C, hidden), "mlp.c_fc.bias": (hidden,),
                 "mlp.c_proj.weight": (hidden, C),
                 "mlp.c_proj.bias": (C,)}, 0)
    x0 = torch.randn(B, T, C, generator=torch.Generator().manual_seed(1))
    g = torch.randn(B, T, C, generator=torch.Generator().manual_seed(2))
    mask = neg_inf_causal_mask(T)
    masks = FGT.draw_masks_gpt2(B, T, C, H, (5, 7), 2, 0.2, 0.2,
                                device="cpu")
    x = x0.clone().requires_grad_(True)
    ref = FGT.fused_gpt2_block_train_plain(x, p, mask, masks, num_heads=H)
    (ref * g).sum().backward()
    xs = x0.clone().requires_grad_(True)
    loc = [_local(p, "gpt_model.h.0.", m) for m in range(2)]
    y = sum(FGT.gpt2_attn_half_shard_plain(xs, loc[m], mask, masks,
                                           num_heads=H, rank=m)[0]
            for m in range(2))
    out = sum(FGT.gpt2_mlp_half_shard_plain(y, loc[m], masks, rank=m)
              for m in range(2)).reshape(B, T, C)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    (out * g).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), x.grad.numpy(), **TOL)
    for k, v in p.items():
        spec = SH.spec_for_path("gpt_model.h.0." + k)
        if spec is not None:
            got = SH.unshard_tensor([loc[m][k].grad for m in range(2)], spec)
        elif k.startswith("ln_"):
            got = loc[0][k].grad + loc[1][k].grad     # partial sums
        else:
            # a row-parallel bias: the whole gradient on every rank
            np.testing.assert_allclose(loc[1][k].grad.numpy(),
                                       v.grad.numpy(), err_msg=k, **TOL)
            got = loc[0][k].grad
        np.testing.assert_allclose(got.numpy(), v.grad.numpy(), err_msg=k,
                                   **TOL)


def test_fuser_shard_plain_mlp_sums_to_the_unsharded_block():
    R, N, C, H, hidden = 6, 5, 32, 2, 128
    p = _params({"norm1.weight": (C,), "norm1.bias": (C,),
                 "attn.qkv.weight": (3 * C, C), "attn.proj.weight": (C, C),
                 "attn.proj.bias": (C,), "norm2.weight": (C,),
                 "norm2.bias": (C,), "mlp.mlp.0.weight": (hidden, C),
                 "mlp.mlp.0.bias": (hidden,), "mlp.mlp.2.weight": (C, hidden),
                 "mlp.mlp.2.bias": (C,)}, 3)
    x0 = torch.randn(R, N, C, generator=torch.Generator().manual_seed(4))
    g = torch.randn(R, N, C, generator=torch.Generator().manual_seed(5))
    masks = FT.draw_masks(R, N, C, H, (9, 11), 1, 0.2, 0.2, 0.2,
                          device="cpu")
    x = x0.clone().requires_grad_(True)
    ref = FT.fused_block_train_plain(x, p, None, masks, num_heads=H)
    (ref * g).sum().backward()
    xs = x0.clone().requires_grad_(True)
    loc = [_local(p, "fuser.blocks.0.", m) for m in range(2)]
    # the attention half whole (rank 0's copy: the ranks compute it alike)
    y, _ = FT.attn_half_train_plain(xs, loc[0], None, masks, num_heads=H)
    out = sum(FT.mlp_half_shard_plain(y, loc[m], masks, torch.float32, N, m)
              for m in range(2)).reshape(R, N, C)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    (out * g).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), x.grad.numpy(), **TOL)
    for k, v in p.items():
        spec = SH.spec_for_path("fuser.blocks.0." + k)
        if spec is not None:
            got = SH.unshard_tensor([loc[m][k].grad for m in range(2)], spec)
        elif k.startswith("norm2"):
            got = loc[0][k].grad + loc[1][k].grad     # partial sums
        elif k == "mlp.mlp.2.bias":
            np.testing.assert_allclose(loc[1][k].grad.numpy(),
                                       v.grad.numpy(), err_msg=k, **TOL)
            got = loc[0][k].grad
        else:
            got = loc[0][k].grad
        np.testing.assert_allclose(got.numpy(), v.grad.numpy(), err_msg=k,
                                   **TOL)


# -- the steps ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tp(inits):
    return _jax_steps(inits, make_mesh_2d(4, 2))


@pytest.mark.parametrize("grid", ["data1xmodel2", "data2xmodel2"])
def test_tp_step_equals_the_jax_tp_step(grid, two_ranks, four_ranks, jax_tp):
    records = (two_ranks if grid == "data1xmodel2" else four_ranks)[0]
    assert [r["model_rank"] for r in records["jax"]] == (
        [0, 1] if grid == "data1xmodel2" else [0, 1, 0, 1])
    _assert_equals_jax(records["jax"], jax_tp)


@pytest.mark.parametrize("grid", ["data1xmodel2", "data2xmodel2"])
def test_tp_step_equals_one_process_with_dropout_and_mixup(grid, two_ranks,
                                                           four_ranks):
    records, jobs, _ = two_ranks if grid == "data1xmodel2" else four_ranks
    rank0 = records["rates"][0]
    one = D.run_train({**jobs["rates"], "tp": 1, "save": None},
                      torch.device("cpu"))
    _assert_runs_agree(rank0, one, f"{grid}, rates on")
    # each rank holds its shards: well under the whole model's bytes
    for r in records["rates"]:
        assert r["param_bytes"] < 0.9 * one["param_bytes"]
        assert r["state_bytes"] < 0.9 * one["state_bytes"]


def test_sp_step_equals_the_jax_sp_step(four_ranks, inits):
    _assert_equals_jax(four_ranks[0]["sp_jax"],
                       _jax_steps(inits, make_mesh_2d(4, 2), seq=True))


@pytest.mark.parametrize("job", ["sp", "sp_odd"])
def test_sp_step_equals_one_process_with_dropout_and_mixup(four_ranks, job):
    records, jobs, _ = four_ranks
    one = D.run_train({**jobs[job], "tp": 1, "sp": False},
                      torch.device("cpu"))
    _assert_runs_agree(records[job][0], one, job)


def test_sp_warns_once_and_stays_whole_where_t_does_not_divide():
    ctx = SH.SeqCtx(_Grid(2))
    with pytest.warns(UserWarning, match="T=9 does not divide"):
        assert ctx.applies(9) is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ctx.applies(9) is False
        assert ctx.applies(10) is True
    with pytest.raises(ValueError, match="model axis"):
        SH.SeqCtx(_Grid(1))


def test_three_axis_step_equals_the_jax_3d_mesh(four_ranks, inits):
    records = four_ranks[0]["axis3"]
    assert [(r["stage"], r["model_rank"]) for r in records] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    _assert_equals_jax(records, _jax_steps(
        inits, make_mesh_3d(2, 2, 2), pipe=True, batch=BATCH3, steps=2,
        invalid=()))


def test_tp_grad_accum_equals_one_process_in_microbatch_order(four_ranks):
    records, jobs, _ = four_ranks
    rank0 = records["accum"][0]
    one = D.run_train({**jobs["accum"], "tp": 1, "order": 2},
                      torch.device("cpu"))
    _assert_runs_agree(rank0, one, "data2xmodel2, grad_accum=2")


def test_tp_clip_and_norms_equal_one_process(four_ranks):
    """The clip's global norm and ``watch_gradients``' norms add each shard
    once over the model group and the replicated rest once (under ZeRO-1,
    each rank's slices too)."""
    records, jobs, _ = four_ranks
    rank0 = records["clip"][0]
    one = D.run_train({**jobs["clip"], "tp": 1}, torch.device("cpu"))
    _assert_runs_agree(rank0, one, "data2xmodel2, clipped")
    assert all(r["norms"] == rank0["norms"] for r in records["clip"])
    for i, (got, want) in enumerate(zip(rank0["norms"], one["norms"])):
        assert set(got) == set(want) and "grad_norm" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
        assert want["grad_norm"] > 0.05     # the clip acted


def test_zero1_under_tp_equals_plain_data_parallelism(four_ranks):
    records = four_ranks[0]
    zero, plain = records["zero"], records["plain_tp"]
    assert zero[0]["losses"] == plain[0]["losses"]
    assert zero[0]["state_diff"] == 0.0
    for z, p in zip(zero, plain):
        assert z["state_bytes"] < 0.6 * p["state_bytes"]


def test_tp_checkpoint_is_the_one_process_file_and_resumes_at_tp1(two_ranks):
    records, jobs, work = two_ranks
    ckpt = CK.load_checkpoint(jobs["rates"]["save"]["path"])
    cfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + RATES)
    runner = Runner.from_config(cfg, CLASSES, device="cpu")
    want = runner.model_state()
    assert list(ckpt["model"]) == list(want)
    for k, v in want.items():
        assert ckpt["model"][k].shape == v.shape, k
    runner.load_checkpoint_state(ckpt["model"], ckpt["optimizer"])
    for k, v in runner.model_state().items():
        assert torch.equal(v, ckpt["model"][k]), k
    opt = runner.optimizer.state_dict()
    assert set(opt["state"]) == set(ckpt["optimizer"]["state"])
    for i, entry in opt["state"].items():
        for key, v in entry.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                ckpt["optimizer"]["state"][i][key])), (i, key)
    # resumed for the last 2 steps at tp = 1 on 2 processes (data2): where
    # the tp = 2 run's 4 steps landed
    _assert_runs_agree(
        {"losses": records["resumed"][0]["losses"],
         "state": records["resumed"][0]["state"]},
        {"losses": records["rates"][0]["losses"][2:],
         "state": records["rates"][0]["state"]}, "resumed at tp=1")


# -- the driver and the rules of the port -------------------------------------

def test_dryrun_multichip_runs_every_mode_n4_allows():
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "afft_tpu_torch.tools.dryrun_multichip", "-n",
         "4", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("dryrun_multichip(")]
    modes = ["pure-DP)", "2-D data2xmodel2)", "2-D data2xmodel2+SP)",
             "DP+ZeRO-1)", "pure-DP x grad_accum=2)",
             "pipeline 4-stage 8-layer)", "data2xpipe2 (train.pipeline"]
    assert len(lines) == len(modes), proc.stdout
    for line, mode in zip(lines, modes):
        assert line.startswith(f"dryrun_multichip(4, {mode}"), line
        assert "ok" in line


def test_dryrun_multichip_spawns_once(monkeypatch):
    calls = []

    def fake(fn, args, nprocs, **kw):
        calls.append((fn, nprocs, kw.get("start_method")))
    monkeypatch.setattr(DRY.mp, "start_processes", fake)
    assert DRY.main(["-n", "4", "--device", "cpu"]) == 0
    assert calls == [(DRY._worker, 4, "spawn")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DRY.main(["-n", "2"])
    assert len(calls) == 1


def test_new_modules_import_neither_jax_nor_afft_tpu():
    pkg = os.path.join(REPO, "afft_tpu_torch")
    for rel in NEW_MODULES:
        with open(os.path.join(pkg, rel)) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in (
            "jax", "jaxlib", "afft_tpu")], (rel, names)
    code = ("import sys, afft_tpu_torch.parallel.sharding, "
            "afft_tpu_torch.tools.dryrun_multichip; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'afft_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_wrappers_and_rules_import_in_one_direction():
    """ops (the kernels' wrappers) imports nothing of parallel or models,
    and parallel.sharding nothing of models: the shard-mode layers get the
    model group's collectives in their Shard."""
    code = ("import sys, afft_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m.startswith(("
            "'afft_tpu_torch.parallel', 'afft_tpu_torch.models'))]; "
            "assert not bad, bad; "
            "import afft_tpu_torch.parallel.sharding; "
            "bad = [m for m in sys.modules "
            "if m.startswith('afft_tpu_torch.models')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_reduce_scatter_dim_goes_through_reduce_scatter_sum(monkeypatch,
                                                            dim):
    """reduce_scatter_dim is reduce_scatter_sum (NCCL's reduce-scatter on
    the card) over ``dim`` moved first: rank 1 of 2 equal ranks gets its
    slice along ``dim`` of twice the tensor."""
    from afft_tpu_torch.parallel import mesh as M
    calls = []

    def fake_sum(flat, group=None):
        calls.append(flat.shape)
        n = flat.numel() // 2
        return 2 * flat[n:]
    monkeypatch.setattr(M, "_alone", lambda group: False)
    monkeypatch.setattr(M, "rank_and_world", lambda group=None: (1, 2))
    monkeypatch.setattr(M, "reduce_scatter_sum", fake_sum)
    t = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    got = M.reduce_scatter_dim(t, dim)
    size = t.shape[dim] // 2
    assert torch.equal(got, 2 * t.narrow(dim, size, size))
    assert got.is_contiguous() and calls == [(t.numel(),)]


@pytest.mark.parametrize("run,job", [
    ("two_ranks", "jax"), ("two_ranks", "rates"), ("four_ranks", "rates"),
    ("four_ranks", "sp"), ("four_ranks", "accum"), ("four_ranks", "zero"),
    ("four_ranks", "axis3")])
def test_model_ranks_keep_their_whole_tensors_alike(request, run, job):
    """Every tensor a rank holds whole is the same, byte for byte, on the
    ranks of its model group (consecutive ranks: the model axis is
    innermost) after the steps."""
    records = request.getfixturevalue(run)[0][job]
    for r in range(0, len(records), 2):
        a, b = records[r], records[r + 1]
        assert a["replicated_digests"] == b["replicated_digests"], (job, r)
        assert a["replicated_digests"], job


def test_a_planted_fault_is_caught(two_ranks):
    """The LayerNorm gradients of the sharded layers left unsummed over the
    model group (dp_check's planted fault): the model ranks' copies of
    them part, and rank 0's state leaves the sound run's (which holds to
    one process within 1e-5) by far more than that tolerance."""
    records = two_ranks[0]
    sound, planted = records["rates"][0], records["planted"]
    parted = [k for k, v in planted[0]["replicated_digests"].items()
              if v != planted[1]["replicated_digests"][k]]
    assert any(".ln_1." in k or ".norm2." in k for k in parted), parted
    worst = max(float((planted[0]["state"][k] - v).abs().max()
                      / max(float(v.abs().max()), 1e-30))
                for k, v in sound["state"].items())
    assert worst > 100 * TOL["rtol"], worst
