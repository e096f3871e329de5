"""``_target_`` instantiation for the port.

The conf tree and the expt files name components by the reference's
``_target_`` strings (``models.fusion.ModalTokenCMFuser``,
``torch.nn.Identity``, ...). The port resolves them through its own alias
table to its own classes. The table holds only what the ported serving
paths build; any other target raises ``ValueError`` naming it.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

from .config import Config

# reference target name -> "afft_tpu_torch_module:attr"
_ALIASES: Dict[str, str] = {
    "models.fusion.ModalTokenCMFuser":
        "afft_tpu_torch.models.fusion:ModalTokenCMFuser",
    "models.fusion.CMFuser": "afft_tpu_torch.models.fusion:CMFuser",
    "models.fusion.TemporalCMFuser":
        "afft_tpu_torch.models.fusion:TemporalCMFuser",
    "models.fusion.TemporalCrossAttentFuser":
        "afft_tpu_torch.models.fusion:TemporalCrossAttentFuser",
    "models.future_prediction.CMFPEarly":
        "afft_tpu_torch.models.cmfp:CMFPEarly",
    "models.future_prediction.BaseFuturePredictor":
        "afft_tpu_torch.models.predictor:BaseFuturePredictor",
    "models.feature_mapping.Linear":
        "afft_tpu_torch.models.mapping:LinearMapping",
    "torch.nn.Identity": "afft_tpu_torch.models.backbones:Identity",
}


def resolve_target(target: str) -> Callable:
    spec = _ALIASES.get(target)
    if spec is None:
        raise ValueError(
            f"_target_ {target!r} is not ported to afft_tpu_torch (see "
            f"ROADMAP.md, Open items; ported: {sorted(_ALIASES)})")
    mod_name, attr = spec.split(":")
    return getattr(importlib.import_module(mod_name), attr)


def _to_plain(value: Any, recursive: bool) -> Any:
    if isinstance(value, Config):
        return _to_plain(value.to_container(resolve=True), recursive)
    if isinstance(value, dict):
        if recursive and "_target_" in value:
            return instantiate(value)
        return {k: _to_plain(v, recursive) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_plain(v, recursive) for v in value]
    return value


def instantiate(cfg: Any, *args, **kwargs) -> Any:
    """hydra.utils.instantiate equivalent; ``_recursive_=False`` passes
    nested ``_target_`` dicts through unresolved."""
    if cfg is None:
        return None
    if isinstance(cfg, Config):
        cfg = cfg.to_container(resolve=True)
    if not isinstance(cfg, dict):
        raise TypeError(f"instantiate needs a dict/Config, got {type(cfg)}")
    cfg = dict(cfg)
    target = cfg.pop("_target_", None)
    if target is None:
        raise ValueError("missing _target_")
    recursive = kwargs.pop("_recursive_", cfg.pop("_recursive_", True))
    cfg.pop("_convert_", None)
    fn = resolve_target(target)
    final_kwargs = {k: _to_plain(v, recursive) for k, v in cfg.items()}
    final_kwargs.update(kwargs)
    return fn(*args, **final_kwargs)
