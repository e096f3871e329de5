"""Carry weights into the port: JAX parameter pytrees and reference
checkpoints.

``state_dict_from_jax`` turns the JAX package's parameter pytree (numpy
leaves) into the port's state dict, reproducing the reference-layout export
of afft_tpu (train/torch_export.py ``export_base_model``):

- JAX Linear weights are (in, out); ``nn.Linear.weight`` is (out, in), so
  they are transposed;
- the GPT-2 Conv1D weights stay (in, out), but the JAX ``c_attn`` packs qkv
  heads-major, [h0: (q, k, v), h1: ...]; HF and the port pack [q | k | v]
  with heads minor, so ``c_attn`` is re-interleaved;
- one shared classifier appears under every head key;
- every CMFP (early, individual, score fusion), fuser (MATT included) and
  mapping (linear, gated linear, non-linear, gated embedding unit) is
  carried name for name as ``torch_export.export_cmfp`` writes it.

``grads_from_jax`` carries a JAX gradient pytree the same way (the tests
compare gradients with it). ``tp_state_from_jax`` goes one step further, to
a tensor-parallel rank's shards (``parallel.sharding.shard_state``; back to
the whole state is ``parallel.sharding.canonical_state``, a gather over the
model group): the split is head-aligned on the port's [q | k | v]
``c_attn``, so rank m's columns are its heads' of each of q, k and v, the
same heads as JAX's shard m of its heads-major packing.
``load_reference_checkpoint`` reads a reference ``.pth``. Either result
loads with ``model.load_state_dict`` and needs no adapter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(x):
    return np.asarray(x)


def _join(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def _lin(out, prefix, p):
    out[_join(prefix, "weight")] = _np(p["w"]).T
    if "b" in p:
        out[_join(prefix, "bias")] = _np(p["b"])


def _conv1d(out, prefix, p):
    out[_join(prefix, "weight")] = _np(p["w"])
    out[_join(prefix, "bias")] = _np(p["b"])


def _conv1d_qkv(out, prefix, p, n_head):
    """Heads-major [h: (q, k, v)] -> HF [q | k | v] with heads minor."""
    w, b = _np(p["w"]), _np(p["b"])
    c_in, three_c = w.shape
    hd = three_c // 3 // n_head
    out[_join(prefix, "weight")] = (w.reshape(c_in, n_head, 3, hd)
                                    .transpose(0, 2, 1, 3)
                                    .reshape(c_in, three_c))
    out[_join(prefix, "bias")] = (b.reshape(n_head, 3, hd)
                                  .transpose(1, 0, 2).reshape(three_c))


def _ln(out, prefix, p):
    if p:  # an empty dict is a LayerNorm without affine parameters
        out[_join(prefix, "weight")] = _np(p["g"])
        out[_join(prefix, "bias")] = _np(p["b"])


def _tensors(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


def block_from_jax(p, prefix="") -> Dict[str, torch.Tensor]:
    """One JAX fuser block (models.blocks.block_init) -> Block state dict."""
    out = {}
    _ln(out, _join(prefix, "norm1"), p["norm1"])
    _lin(out, _join(prefix, "attn.qkv"), p["attn"]["qkv"])
    _lin(out, _join(prefix, "attn.proj"), p["attn"]["proj"])
    _ln(out, _join(prefix, "norm2"), p["norm2"])
    _lin(out, _join(prefix, "mlp.mlp.0"), p["mlp"]["fc1"])
    _lin(out, _join(prefix, "mlp.mlp.2"), p["mlp"]["fc2"])
    return _tensors(out)


def decoder_block_from_jax(p, prefix="") -> Dict[str, torch.Tensor]:
    """One JAX decoder block (models.blocks.decoder_block_init) ->
    DecoderBlock state dict."""
    out = {}
    _ln(out, _join(prefix, "norm_self"), p["norm_self"])
    _lin(out, _join(prefix, "attn.qkv"), p["attn"]["qkv"])
    _lin(out, _join(prefix, "attn.proj"), p["attn"]["proj"])
    _ln(out, _join(prefix, "norm_q"), p["norm_q"])
    _ln(out, _join(prefix, "norm_kv"), p["norm_kv"])
    for k in ("w_q", "w_k", "w_v", "proj"):
        _lin(out, _join(prefix, f"cross_attn.{k}"), p["cross_attn"][k])
    _ln(out, _join(prefix, "norm_mlp"), p["norm_mlp"])
    _lin(out, _join(prefix, "mlp.mlp.0"), p["mlp"]["fc1"])
    _lin(out, _join(prefix, "mlp.mlp.2"), p["mlp"]["fc2"])
    return _tensors(out)


def gpt2_block_from_jax(p, n_head: int, prefix="") -> Dict[str, torch.Tensor]:
    """One JAX GPT-2 layer (heads-major c_attn) -> GPT2Block state dict."""
    out = {}
    _ln(out, _join(prefix, "ln_1"), p["ln_1"])
    _conv1d_qkv(out, _join(prefix, "attn.c_attn"), p["c_attn"], n_head)
    _conv1d(out, _join(prefix, "attn.c_proj"), p["c_proj"])
    _ln(out, _join(prefix, "ln_2"), p["ln_2"])
    _conv1d(out, _join(prefix, "mlp.c_fc"), p["c_fc"])
    _conv1d(out, _join(prefix, "mlp.c_proj"), p["mlp_c_proj"])
    return _tensors(out)


def fuser_from_jax(fuser, p, prefix="") -> Dict[str, torch.Tensor]:
    """A JAX fuser's parameters -> the port fuser's state dict (after
    torch_export.export_fuser)."""
    from .models import fusion as F
    if isinstance(fuser, F.MATT):
        out = {}
        for i, name in ((0, "fc1"), (3, "fc2"), (6, "fc3")):
            _lin(out, _join(prefix, f"matt.{i}"), p[name])
        return _tensors(out)
    if not isinstance(fuser, (F.ModalTokenCMFuser, F.CMFuser,
                              F.TemporalCMFuser,
                              F.TemporalCrossAttentFuser)):
        raise ValueError(f"fuser {type(fuser).__name__} is not ported")
    decoder = isinstance(fuser, F.TemporalCrossAttentFuser)
    out = {}
    for i, blk in enumerate(p["blocks"]):
        convert = decoder_block_from_jax if decoder else block_from_jax
        out.update(convert(blk, _join(prefix, f"blocks.{i}")))
    rest = {}
    _ln(rest, _join(prefix, "norm"), p["norm"])
    if "position_embeddings" in p:
        rest[_join(prefix, "position_embeddings.weight")] = _np(
            p["position_embeddings"]["w"])
    for name in ("modal_token", "modality_embedding"):
        if name in p:
            rest[_join(prefix, name)] = _np(p[name])
    out.update(_tensors(rest))
    return out


def _gpt2_from_jax(p, n_head, prefix):
    g = f"{prefix}.gpt_model"
    out = {}
    for i, blk in enumerate(p["blocks"]):
        out.update(gpt2_block_from_jax(blk, n_head, f"{g}.h.{i}"))
    rest = {f"{g}.wpe.weight": _np(p["wpe"])}
    _ln(rest, f"{g}.ln_f", p["ln_f"])
    out.update(_tensors(rest))
    return out


def mapping_from_jax(mapping, p, prefix="") -> Dict[str, torch.Tensor]:
    """A JAX mapping's parameters -> the port mapping's state dict (after
    torch_export.export_mapping)."""
    from .models import mapping as M
    out = {}
    if isinstance(mapping, M.LinearMapping):
        if not mapping.identity:
            _lin(out, _join(prefix, "mapping.0"), p["fc"])
        if mapping.use_layernorm:
            _ln(out, _join(prefix, "mapping.1"), p["ln"])
    elif isinstance(mapping, M.GatedEmbeddingUnit):
        _lin(out, _join(prefix, "fc"), p["fc"])
        _lin(out, _join(prefix, "cg.fc"), p["cg"]["fc"])
    elif isinstance(mapping, (M.GatedLinearMapping, M.NonLinearMapping)):
        _lin(out, _join(prefix, "mapping.0"), p["fc"])
        if isinstance(mapping, M.GatedLinearMapping):
            _lin(out, _join(prefix, "mapping.1.fc"), p["cg"]["fc"])
        if mapping.use_layernorm:
            _ln(out, _join(prefix, "mapping.2"), p["ln"])
    else:
        raise ValueError(f"mapping {type(mapping).__name__} is not ported")
    return _tensors(out)


def cmfp_from_jax(cmfp, p, prefix="") -> Dict[str, torch.Tensor]:
    """A JAX CMFP's parameters -> the port CMFP's state dict (after
    torch_export.export_cmfp)."""
    from .models.cmfp import CMFPEarly
    out, flat = {}, {}
    if cmfp.uses_mapping:
        for modk, mapping in cmfp.mapping.items():
            out.update(mapping_from_jax(mapping, p["mapping"][modk],
                                        _join(prefix, f"mapping.{modk}")))
    if cmfp.uses_fuser:
        out.update(fuser_from_jax(cmfp.fuser, p["fuser"],
                                  _join(prefix, "fuser")))
    for name in ("dim_encoder", "dim_decoder"):
        codecs = ({"": p[name]} if isinstance(cmfp, CMFPEarly)
                  else {f".{m}": c for m, c in p[name].items()})
        for key, codec in codecs.items():
            if codec is not None:
                flat[_join(prefix, f"{name}{key}.weight")] = \
                    _np(codec["w"]).T
    preds = p["future_predictor"]
    n_head = next(iter(cmfp.predictors().values())).n_head
    for name, pred in preds.items():
        sub = "future_predictor" if name == "shared" \
            else f"future_predictor.{name}"
        out.update(_gpt2_from_jax(pred, n_head, _join(prefix, sub)))
    for cls_type, heads in p["classifiers"].items():
        for headk in cmfp.classifier_keys[cls_type]:
            _lin(flat, _join(prefix, f"classifiers.{cls_type}.{headk}.1"),
                 heads["shared"] if cmfp.common_classifier
                 else heads[headk])
    out.update(_tensors(flat))
    return out


def state_dict_from_jax(model, params) -> Dict[str, torch.Tensor]:
    """JAX BaseModel params (numpy leaves) -> the port BaseModel's state
    dict, in the reference layout of ``torch_export.export_base_model``."""
    out = cmfp_from_jax(model.future_predictor, params["future_predictor"],
                        "future_predictor")
    out.update(_tensors({k: _np(v) for k, v in
                         params.get("buffers", {}).items()}))
    return out


def tp_state_from_jax(model, params, tp) -> Dict[str, torch.Tensor]:
    """The state dict of ``params`` (whole JAX params of ``model``'s
    config) as model rank ``tp.rank`` of a ``parallel.sharding
    .TensorParallel`` placement holds it."""
    from .parallel.sharding import shard_state
    return shard_state(tp, state_dict_from_jax(model, params))


def grads_from_jax(model, grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient pytree (the structure of the JAX parameters, numpy
    leaves) -> {the port's parameter name: gradient in the port's layout}.
    Every layout change of ``state_dict_from_jax`` is a permutation, so the
    gradients take the same road: Linear weights transposed, ``c_attn``
    re-interleaved; a shared classifier's gradient lands under the one name
    ``model.named_parameters()`` gives it."""
    sd = state_dict_from_jax(model, grads)
    return {name: sd[name] for name, _ in model.named_parameters()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (or a saved port state dict) -> state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in ckpt:
        ckpt = ckpt["model"]
    elif "model_state" in ckpt:
        ckpt = ckpt["model_state"]
    return {k: v.detach().cpu() for k, v in ckpt.items()}
