"""Top-level model: backbones + CMFP + class-mapping buffers.

Port of afft_tpu/models/base_model.py (reference models/base_model.py
BaseModel :15-119): backbones (identity over pre-extracted features),
(B, T, F) feature extraction from video-shaped inputs, and the multi-crop
merge, which averages every output over the crops. The verb/noun <-> action
mapping matrices are buffers named ``cls_map_<src>_<dst>``. ``forward`` is
the inference path in eval mode; ``forward_train`` adds what a training
step needs: the targets, the feature-space mixup hook and the step's
generator, and returns the outputs beside the (possibly mixed) targets.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..config.registry import instantiate

CLS_MAP_PREFIX = "cls_map_"


class BaseModel(nn.Module):
    def __init__(self, model_cfg, num_classes: Dict[str, int],
                 class_mappings: Optional[Dict[Tuple[str, str], object]]
                 = None, fuser_need_weights: bool = False):
        """``fuser_need_weights``: passed to the CMFP, whose fuser then
        returns its attention weights (afft_tpu/models/base_model.py:26,35;
        ``visualize_attention``)."""
        super().__init__()
        backbones_cfg = model_cfg["common"].get("backbones") or {}
        self.backbones = nn.ModuleDict({mod: instantiate(bc)
                                        for mod, bc in backbones_cfg.items()})
        self.future_predictor = instantiate(
            model_cfg["CMFP"], model_cfg=model_cfg, num_classes=num_classes,
            fuser_need_weights=fuser_need_weights, _recursive_=False)
        for (src, dst), mapping in (class_mappings or {}).items():
            self.register_buffer(f"{CLS_MAP_PREFIX}{src}_{dst}",
                                 torch.as_tensor(mapping))

    def reset_parameters(self, gen: torch.Generator):
        """Seeded init with the JAX package's distributions."""
        self.future_predictor.reset_parameters(gen)

    @staticmethod
    def _features_from_video(data):
        """Backbone output -> (B, T, F): spatial mean, permute, flatten
        (reference models/base_model.py:41-46)."""
        if data.dim() == 3:
            return data
        feats = data.mean(dim=(-1, -2))          # (B, clips, C, T')
        feats = feats.permute(0, 1, 3, 2)        # (B, clips, T', C)
        return feats.reshape(feats.shape[0], -1, feats.shape[-1])

    def forward_singlecrop(self, data_dict, *, target=None,
                           target_subclips=None,
                           target_subclips_ignore_index=None, mixup_fn=None,
                           impl="kernel", rng=None):
        """One crop -> (outputs, targets): ``mixup_fn`` mixes the backbone
        features and turns the targets into soft ones
        (afft_tpu/models/base_model.py:70-94)."""
        feats_past = {}
        for mod, data in data_dict.items():
            if mod in self.backbones:
                data = self.backbones[mod](data)
            feats_past[mod] = self._features_from_video(data)
        if mixup_fn is not None:
            feats_past, target, target_subclips, \
                target_subclips_ignore_index = mixup_fn(
                    feats_past, target, target_subclips)
        outputs = self.future_predictor(feats_past, impl=impl, rng=rng)
        return outputs, {
            "target": target, "target_subclips": target_subclips,
            "target_subclips_ignore_index": target_subclips_ignore_index}

    def forward(self, video_data: Dict, *, impl="kernel", rng=None):
        """video_data: {mod: (B,T,F) | (B,clips,C,T,H,W) |
        (B,clips,crops,C,T,H,W)} -> the output dictionary; crops are
        forwarded one by one and their outputs averaged (reference
        models/base_model.py:68-119)."""
        return self.forward_train(video_data, impl=impl, rng=rng)[0]

    def forward_train(self, video_data: Dict, *, target=None,
                      target_subclips=None,
                      target_subclips_ignore_index=None, mixup_fn=None,
                      impl="kernel", rng=None):
        """As ``forward``, with the targets and the mixup hook; returns
        (outputs, targets as the first crop left them)."""
        per_mod_crops = {}
        for mod, data in video_data.items():
            if data.dim() in (3, 6):
                per_mod_crops[mod] = [data]
            elif data.dim() == 7:
                per_mod_crops[mod] = list(data.unbind(dim=2))
            else:
                raise NotImplementedError(f"Unsupported size {data.shape}")
        all_mods = sorted(per_mod_crops)
        num_crops = max(len(per_mod_crops[m]) for m in all_mods)
        crops = [self.forward_singlecrop(
            {m: per_mod_crops[m][ci % len(per_mod_crops[m])]
             for m in all_mods}, target=target,
            target_subclips=target_subclips,
            target_subclips_ignore_index=target_subclips_ignore_index,
            mixup_fn=mixup_fn, impl=impl, rng=rng)
            for ci in range(num_crops)]
        outs, targets = [c[0] for c in crops], crops[0][1]
        if num_crops == 1:
            return outs[0], targets
        merged = {}
        for key in outs[0]:
            if key == "attentions":  # crop 0's, as the reference
                merged[key] = outs[0][key]
                continue
            merged[key] = {k: torch.stack([o[key][k] for o in outs]).mean(0)
                           for k in outs[0][key]}
        return merged, targets
