"""GPipe pipeline parallelism of the port on the CPU: gloo processes as
stages, against the JAX package and against one process.

The spawned runs go through ``python -m torch.distributed.run --standalone``
(``tests/test_torch_dp.py``'s helpers), one module-scoped run of
``afft_tpu_torch.tools.dp_check`` jobs on 2 processes and one on 4.

- The schedule: the GPT-2 training layers (L 4, B 8, T 6, C 32, 2 heads,
  fp32, dropout 0) through the S-stage schedule at (S, M) = (2, 4) and
  (4, 2): the output and the gradients of sum(out²) (input and every
  layer's parameters) against ``afft_tpu.parallel.pipeline.pipeline_blocks``
  on the conftest's 8-device CPU mesh and against the port's sequential
  stack, at atol = rtol = 1e-5.
- The train step at dropout 0 with mixup off: data1×pipe2 (2 processes) and
  data2×pipe2 (4) against the JAX runner's pipelined step
  (``make_mesh_data_pipe(2)`` + ``PipelineCtx``, as
  tests/test_integration.py runs it), losses and every updated weight
  within 1e-5.
- With dropout, drop-path and mixup on, the same grids against the port's
  one-process unpipelined step over the same global batches (within 1e-5),
  alone and at ``train.grad_accum=2``; ZeRO-1 at data2×pipe2 against plain
  data parallelism at data2×pipe2, 0 difference.
- Ownership and checkpoints: each rank holds only its stage's layers (and
  their optimizer state), the replicated weights alike on every rank; the
  checkpoint has an unpipelined run's keys and shapes, loads in one process
  bit for bit and continues there as the pipelined run did; an unpipelined
  checkpoint resumes at S = 2.
- The launcher: ``expts/99_synth_smoke_pipe.txt -m train -n 2 --device
  cpu``, then ``-m test`` in one process from its checkpoint.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.models.predictor import \
    BaseFuturePredictor as JaxFuturePredictor
from afft_tpu.parallel.mesh import replicate_tree, shard_batch
from afft_tpu.parallel.pipeline import (PipelineCtx as JaxPipelineCtx,
                                        make_mesh_data_pipe, make_mesh_pipe,
                                        pipeline_blocks, stack_layer_params)
from afft_tpu.train import optim as JO
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.eval import challenge as PC
from afft_tpu_torch.models import layers as L
from afft_tpu_torch.models.predictor import BaseFuturePredictor
from afft_tpu_torch.parallel import pipeline as P
from afft_tpu_torch.tools import dp_check as D
from afft_tpu_torch.train import checkpoint as CK
from afft_tpu_torch.train.runner import Runner

from test_torch_dp import (CLASSES, GLOBAL_BATCH, NO_DROPOUT, RATES, REPO,
                           SMOKE_TRAIN, STEPS, _assert_runs_agree, _lrs,
                           _spawn, _torchrun)

SMOKE_PIPE = os.path.join(REPO, "expts", "99_synth_smoke_pipe.txt")
NO_MIXUP = NO_DROPOUT + ["train.use_mixup=false"]
PIPE2 = ["train.pipeline_stages=2", "train.pipeline_microbatches=2"]
ZERO = "train.zero_sharding=true"
ACCUM = "train.grad_accum=2"
# a clip that acts, and the norms it reads in the metric stream
CLIP = ["opt.grad_clip=0.05", "train.watch_gradients=true"]
# the stack of the schedule check: L, B, T, C, heads
STACK = dict(layers=4, batch=8, tokens=6, width=32, heads=2)
STACK_GRIDS = {2: 4, 4: 2}          # S: M
TOL = dict(atol=1e-5, rtol=1e-5)


def _train_job(name, overrides, **more):
    return {"kind": "train", "name": name, "expt": SMOKE_TRAIN,
            "overrides": overrides, "classes": CLASSES,
            "batch": GLOBAL_BATCH, "steps": STEPS, "seed": 3,
            "lrs": _lrs(overrides), "invalid": [GLOBAL_BATCH - 1], **more}


def _unpipelined(job, **more):
    """``job`` in one process without pipelining."""
    return {**job, "overrides": [o for o in job["overrides"]
                                 if not o.startswith("train.pipeline")],
            **more}


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """JAX params of the smoke expt (dropout 0) and of the schedule's
    stack, with the port state dicts that carry them (files)."""
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
    C, heads = STACK["width"], STACK["heads"]
    fp = JaxFuturePredictor(in_features=C, inter_dim=C,
                            n_layer=STACK["layers"], n_head=heads)
    stack = fp.init(jax.random.key(0))
    layers = {}
    for i, blk in enumerate(stack["blocks"]):
        layers.update(W.gpt2_block_from_jax(
            jax.tree.map(np.asarray, blk), heads, f"gpt_model.h.{i}"))
    torch.save(layers, work / "stack.pt")
    return {"jcfg": jcfg, "jmodel": jmodel, "params": params,
            "model": str(work / "model.pt"), "fp": fp, "stack": stack,
            "stack_file": str(work / "stack.pt"), "work": work}


def _stack_job(stages, inits):
    return {"kind": "stack", "name": f"stack{stages}", "stages": stages,
            "micro": STACK_GRIDS[stages], "weights": inits["stack_file"],
            "seed": 0, **STACK}


def _run(work, nproc, jobs):
    """The jobs on ``nproc`` gloo processes: {name: [record by rank]}."""
    (work / "tests").symlink_to(os.path.join(REPO, "tests"))
    spec = {"device": "cpu", "out": str(work / "out"), "jobs": jobs}
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)
    _spawn(_torchrun(nproc, "-m", "afft_tpu_torch.tools.dp_check",
                     str(work / "spec.json")), str(work),
           f"pipeline{nproc}.log")
    return {job["name"]: [torch.load(work / "out" / f"{job['name']}"
                                     f".rank{r}.pt", weights_only=False)
                          for r in range(nproc)] for job in jobs}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, inits):
    """data1 x pipe2: the schedule at S 2, the pinned step against JAX, the
    step with the rates on (its checkpoint after 2 steps), at grad_accum 2,
    and a resume of an unpipelined checkpoint."""
    work = tmp_path_factory.mktemp("pipe2")
    plain = _train_job("plain", RATES, save={"path": str(work / "plain.ckpt"),
                                             "after": 2})
    D.run_train(plain, torch.device("cpu"))   # the unpipelined checkpoint
    jobs = [_stack_job(2, inits),
            _train_job("jax", NO_MIXUP + PIPE2, weights=inits["model"]),
            _train_job("rates", RATES + PIPE2,
                       save={"path": str(work / "pipe.ckpt"), "after": 2}),
            _train_job("accum", RATES + PIPE2 + [ACCUM], invalid=[2, 3, 7]),
            _train_job("clip", RATES + PIPE2 + CLIP),
            _train_job("resumed", RATES + PIPE2,
                       resume={"path": str(work / "plain.ckpt"),
                               "after": 2})]
    return _run(work, 2, jobs), {j["name"]: j for j in jobs}, work


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, inits):
    """data2 x pipe2 (and the schedule at S 4): the pinned step against
    JAX, the step with the rates on, at grad_accum 2, ZeRO-1 against plain
    data parallelism."""
    work = tmp_path_factory.mktemp("pipe4")
    jobs = [_stack_job(4, inits),
            _train_job("jax", NO_MIXUP + PIPE2, weights=inits["model"]),
            _train_job("rates", RATES + PIPE2),
            _train_job("accum", RATES + PIPE2 + [ACCUM], invalid=[2, 3, 7]),
            _train_job("clip", RATES + PIPE2 + CLIP + [ZERO]),
            _train_job("plain_dp", RATES + PIPE2, keep_state="host"),
            _train_job("zero", RATES + PIPE2 + [ZERO], keep_state=False,
                       against="plain_dp")]
    return _run(work, 4, jobs), {j["name"]: j for j in jobs}, work


def _grid(request, two_ranks, four_ranks):
    return two_ranks if request.param == "data1xpipe2" else four_ranks


GRIDS = ["data1xpipe2", "data2xpipe2"]


@pytest.fixture(params=GRIDS)
def grid(request, two_ranks, four_ranks):
    return _grid(request, two_ranks, four_ranks)


@pytest.fixture(scope="module")
def jax_pipelined(inits):
    """The JAX runner's pipelined steps (data 4 x pipe 2 over the 8 CPU
    devices, 2 microbatches, dropout 0, mixup off) over the jobs' global
    batches: (losses by step, the final port state dict)."""
    jcfg, jmodel, params = inits["jcfg"], inits["jmodel"], inits["params"]
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    jrunner = JaxRunner(jmodel, joptimizer, groups,
                        loss_wts=dict(jcfg.train.loss_wts.items()),
                        mixup=None, mixup_backbone=jcfg.train.mixup_backbone,
                        grad_clip=jcfg.opt.grad_clip, donate=False)
    mesh = make_mesh_data_pipe(2)
    jmodel.future_predictor.predictor_proto.pipeline_ctx = JaxPipelineCtx(
        mesh, microbatches=2)
    opt_state = replicate_tree(mesh, joptimizer.init(params, groups))
    params = replicate_tree(mesh, params)
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + NO_MIXUP)
    lrs = _lrs(NO_MIXUP + PIPE2)
    losses = []
    for i, batch in enumerate(D.make_batches(tcfg, CLASSES, GLOBAL_BATCH,
                                             STEPS, 3, [GLOBAL_BATCH - 1])):
        batch = shard_batch(mesh, {k: v for k, v in batch.items()
                                   if v is not None})
        params, opt_state, step, _, _ = jrunner.train_step(
            params, opt_state, batch, lrs[i], jcfg.opt.lr,
            jax.random.key(i))
        losses.append({k: float(v) for k, v in step.items()})
    model = Runner.from_config(tcfg, CLASSES, device="cpu").model
    return losses, W.state_dict_from_jax(model,
                                         jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("stages", sorted(STACK_GRIDS))
def test_schedule_equals_sequential_stack_and_jax(two_ranks, four_ranks,
                                                  inits, stages):
    records = (two_ranks if stages == 2 else four_ranks)[0][f"stack{stages}"]
    micro = STACK_GRIDS[stages]
    # JAX: the same weights and input through pipeline_blocks
    fp, stack = inits["fp"], inits["stack"]
    B, T, C = STACK["batch"], STACK["tokens"], STACK["width"]
    x = np.random.default_rng(0).standard_normal((B, T, C)).astype(
        np.float32)
    mask = jnp.triu(jnp.full((T, T), -1e9, jnp.float32), k=1)

    def block_fn(p, h):
        return fp._block(p, h, mask, train=False, rng=None,
                         collect_attn=False)[0]

    def loss(stacked, x):
        out = pipeline_blocks(block_fn, stacked, x, make_mesh_pipe(stages),
                              microbatches=micro)
        return jnp.sum(out ** 2), out

    stacked = stack_layer_params(stack["blocks"])
    (_, j_out), (j_gp, j_dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(stacked, jnp.asarray(x))
    j_grads = {}
    for i in range(STACK["layers"]):
        j_grads.update(W.gpt2_block_from_jax(
            jax.tree.map(lambda a, i=i: np.asarray(a[i]), j_gp),
            STACK["heads"], f"gpt_model.h.{i}"))
    # the port's sequential stack on the same weights
    seq = BaseFuturePredictor(C, inter_dim=C, n_layer=STACK["layers"],
                              n_head=STACK["heads"], embd_pdrop=0.0,
                              resid_pdrop=0.0, attn_pdrop=0.0)
    seq.load_state_dict(torch.load(inits["stack_file"]), strict=False)
    seq.train()
    xt = torch.from_numpy(x).requires_grad_()
    s_out = seq._train_layers(xt, L.neg_inf_causal_mask(T), "kernel", None)
    (s_out ** 2).sum().backward()
    s_grads = {n: p.grad for n, p in seq.named_parameters()
               if P.layer_of(n) is not None}
    np.testing.assert_allclose(s_out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    seen = set()
    for rec in records:
        np.testing.assert_allclose(rec["out"].numpy(), np.asarray(j_out),
                                   **TOL)
        np.testing.assert_allclose(rec["out"].numpy(),
                                   s_out.detach().numpy(), **TOL)
        np.testing.assert_allclose(rec["dx"].numpy(), np.asarray(j_dx),
                                   **TOL)
        np.testing.assert_allclose(rec["dx"].numpy(), xt.grad.numpy(),
                                   **TOL)
        # the stage's own layers, and only those
        per = STACK["layers"] // stages
        assert {P.layer_of(n)[1] for n in rec["grads"]} == set(
            range(rec["stage"] * per, (rec["stage"] + 1) * per))
        for n, g in rec["grads"].items():
            np.testing.assert_allclose(g.numpy(), j_grads[n].numpy(),
                                       err_msg=n, **TOL)
            np.testing.assert_allclose(g.numpy(), s_grads[n].numpy(),
                                       err_msg=n, **TOL)
            seen.add(n)
    assert seen == set(j_grads)


def test_pipelined_step_equals_the_jax_pipelined_runner(grid,
                                                        jax_pipelined):
    records, jobs, _ = grid
    want_losses, want_state = jax_pipelined
    rank0 = records["jax"][0]
    assert all(r["losses"] == rank0["losses"] for r in records["jax"])
    for i, (got, want) in enumerate(zip(rank0["losses"], want_losses)):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert set(rank0["state"]) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(rank0["state"][k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)


def test_pipelined_step_equals_one_process_with_dropout_and_mixup(grid):
    records, jobs, _ = grid
    rank0 = records["rates"][0]
    assert all(r["losses"] == rank0["losses"] for r in records["rates"])
    one = D.run_train(_unpipelined(jobs["rates"]), torch.device("cpu"))
    _assert_runs_agree(rank0, one, "pipelined, rates on")
    # the rates acted: without them the first step's loss differs
    plain = D.run_train(_unpipelined(jobs["rates"], overrides=NO_DROPOUT,
                                     steps=1, keep_state=False),
                        torch.device("cpu"))
    assert plain["losses"][0]["total_loss"] != \
        one["losses"][0]["total_loss"]


def test_pipelined_grad_accum_equals_one_process(grid):
    records, jobs, _ = grid
    rank0 = records["accum"][0]
    one = D.run_train(_unpipelined(jobs["accum"], order=rank0["replicas"]),
                      torch.device("cpu"))
    _assert_runs_agree(rank0, one, "pipelined, grad_accum=2")


def test_pipelined_clip_and_norms_equal_one_process(grid):
    """The clip's global norm and ``watch_gradients``' norms add each
    stage's layers once and the replicated rest once (at data2 x pipe2
    under ZeRO-1, each rank's slices too)."""
    records, jobs, _ = grid
    rank0 = records["clip"][0]
    one = D.run_train(_unpipelined(jobs["clip"]), torch.device("cpu"))
    _assert_runs_agree(rank0, one, "pipelined, clipped")
    assert all(r["norms"] == rank0["norms"] for r in records["clip"])
    for i, (got, want) in enumerate(zip(rank0["norms"], one["norms"])):
        assert set(got) == set(want) and "grad_norm" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
        assert want["grad_norm"] > 0.05     # the clip acted


def test_zero1_over_data2_pipe2_equals_plain_data_parallelism(four_ranks):
    records = four_ranks[0]
    for zero, plain in zip(records["zero"], records["plain_dp"]):
        assert zero["losses"] == plain["losses"]
        # each rank holds half its stage's state: the data group splits it
        assert abs(zero["state_bytes"] - plain["state_bytes"] / 2) <= 16
    assert records["zero"][0]["state_diff"] == 0.0


def test_each_stage_holds_only_its_layers(grid):
    records, jobs, _ = grid
    whole = Runner.from_config(compose(CONF_DIR, read_expt_file(
        SMOKE_TRAIN) + RATES), CLASSES, device="cpu")
    names = [n for n, _ in whole.model.named_parameters()]
    layers = int(whole.model.future_predictor.future_predictor.n_layer)
    for rec in records["rates"]:
        assert rec["replica"] == rec["rank"] // 2
        assert rec["stage"] == rec["rank"] % 2
        per = layers // 2
        own = range(rec["stage"] * per, (rec["stage"] + 1) * per)
        assert rec["params"] == [n for n in names if P.layer_of(n) is None
                                 or P.layer_of(n)[1] in own]
        # the replicated weights are alike on every rank
        assert rec["replicated_sums"] == \
            records["rates"][0]["replicated_sums"]
    # SGD's momentum, one fp32 buffer a parameter: each rank holds the
    # replicated parameters' and its own layers' only
    per_layer = sum(p.numel() * 4 for n, p in whole.model.named_parameters()
                    if P.layer_of(n) is not None) // layers
    replicated = sum(p.numel() * 4 for n, p in
                     whole.model.named_parameters() if P.layer_of(n) is None)
    for rec in records["rates"]:
        assert rec["state_bytes"] == replicated + per_layer * layers // 2


def test_checkpoint_is_canonical_and_resumes_in_one_process(two_ranks):
    records, jobs, work = two_ranks
    ckpt = CK.load_checkpoint(work / "pipe.ckpt")
    plain = CK.load_checkpoint(work / "plain.ckpt")
    # the unpipelined run's keys, order and shapes
    assert list(ckpt["model"]) == list(plain["model"])
    for k, v in plain["model"].items():
        assert ckpt["model"][k].shape == v.shape, k
    assert sorted(ckpt["optimizer"]["state"]) == \
        sorted(plain["optimizer"]["state"])
    assert [g["params"] for g in ckpt["optimizer"]["param_groups"]] == \
        [g["params"] for g in plain["optimizer"]["param_groups"]]
    for i, entry in plain["optimizer"]["state"].items():
        for n, v in entry.items():
            assert ckpt["optimizer"]["state"][i][n].shape == v.shape
    # one process loads it bit for bit ...
    job = {k: v for k, v in jobs["rates"].items() if k != "save"}
    runner = Runner.from_config(compose(CONF_DIR, read_expt_file(
        SMOKE_TRAIN) + RATES), CLASSES, device="cpu")
    runner.load_checkpoint_state(ckpt["model"], ckpt["optimizer"])
    model, opt = runner.checkpoint_state()
    for k, v in ckpt["model"].items():
        assert torch.equal(model[k], v), k
    for i, entry in ckpt["optimizer"]["state"].items():
        for n, v in entry.items():
            assert torch.equal(opt["state"][i][n], v), (i, n)
    # ... and continues where the pipelined run went
    one = D.run_train(_unpipelined(job, resume={"path": str(
        work / "pipe.ckpt"), "after": 2}), torch.device("cpu"))
    rank0 = records["rates"][0]
    _assert_runs_agree(one, {**rank0, "losses": rank0["losses"][2:]},
                       "pipelined checkpoint resumed in one process")


def test_unpipelined_checkpoint_resumes_at_two_stages(two_ranks):
    records, jobs, work = two_ranks
    one = D.run_train(_unpipelined(jobs["resumed"]), torch.device("cpu"))
    _assert_runs_agree(records["resumed"][0], one,
                       "unpipelined checkpoint resumed at S = 2")


def test_launcher_trains_pipelined_and_evaluates_in_one_process(
        tmp_path, monkeypatch):
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    run = [sys.executable, "-m", "afft_tpu_torch.run", "--device", "cpu",
           "workers=2", "use_wandb=false"]
    _spawn(run + ["-c", SMOKE_PIPE, "-m", "train", "-n", "2"],
           str(tmp_path), "train.log")
    name = "CMFPEarly_ModalTokenCMFuser_rgb_flow_synth-smoke-pipe"
    ckpt = tmp_path / "checkpoints" / name
    assert {"checkpoint_best", "checkpoint_last"} <= set(os.listdir(ckpt))
    with open(ckpt / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # two epochs, one writer
    with open(ckpt / "summary.jsonl") as f:
        run_line = [json.loads(line) for line in f][-1]["run"]
    assert (run_line["world_size"], run_line["pipeline_stages"],
            run_line["data_replicas"]) == (2, 2, 1)
    state = CK.load_checkpoint(ckpt / "checkpoint_last")["model"]
    assert any(P.layer_of(k) == (
        "future_predictor.future_predictor.gpt_model.h.", 1) for k in state)
    _spawn(run + ["-c", SMOKE_PIPE, "-m", "test",
                  f"init_from_model={name}/checkpoint_last",
                  "+save_name=one.h5"], str(tmp_path), "eval.log")
    (one,) = PC.gen_load_resfiles(str(tmp_path / "logits" / name), "one")
    logits = one["logits/action_all-fused"]
    assert logits.shape[0] == 16 and np.isfinite(logits).all()
