"""CMFPEarly: map -> fuse -> predict -> classify (early fusion).

Port of afft_tpu/models/cmfp.py ``CMFPEarly`` (reference
models/future_prediction.py:228-291). Returns the reference's output
dictionary (``logits/*``, ``past_logits/*``, ``orig_past``, ``future``,
``past_futures``, ``all-fused``, ``attentions``). State-dict names:
``mapping.<mod>.mapping.0``, ``fuser.*``, ``dim_encoder``, ``dim_decoder``,
``future_predictor.gpt_model.*`` and ``classifiers.<cls>.<head>.1``, where
one shared classifier is registered under every head key, as the reference
does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from . import layers as L
from ..config.registry import instantiate

PAST_LOGITS_PREFIX = "past_"


def _codec(in_dim, out_dim):
    """Bias-free Linear, or None (identity) when the widths match."""
    return None if in_dim == out_dim else nn.Linear(in_dim, out_dim,
                                                    bias=False)


class CMFPEarly(nn.Module):
    def __init__(self, model_cfg, num_classes: Dict[str, int]):
        super().__init__()
        common = model_cfg["common"]
        # early fusion implies a shared classifier and predictor (reference
        # :235-242 sets the same flags on the shared config object)
        common["share_classifiers"] = True
        common["share_predictors"] = True
        self.num_classes = dict(num_classes)
        self.latent_dim = common["in_features"]
        self.fp_inter_dim = common["fp_inter_dim"]
        self.fp_output_len = common["fp_output_len"]
        self.modality_dims = dict(model_cfg["modal_dims"].items())
        self.modal_feature_order = list(model_cfg["modal_feature_order"])
        self.dropout_rate = model_cfg["dropout"]
        self.modality_cls = common["modality_cls"]
        self.fusion_cls = common["fusion_cls"]
        if not (self.modality_cls or self.fusion_cls):
            raise ValueError("needs modality-level and / or fusion "
                             "classification")

        self.mapping = nn.ModuleDict({
            mod: instantiate(model_cfg["mapping"], in_features=dim,
                             out_features=self.latent_dim)
            for mod, dim in self.modality_dims.items()})
        self.fuser = instantiate(model_cfg["fuser"], _recursive_=False)
        self.dim_encoder = _codec(self.latent_dim, self.fp_inter_dim)
        self.dim_decoder = _codec(self.fp_inter_dim, self.latent_dim)
        self.future_predictor = instantiate(
            model_cfg["future_predictor"], in_features=self.fp_inter_dim,
            dimension_mapping=False, _recursive_=False)

        self.classifier_keys: Dict[str, list] = {}
        classifiers = {}
        for cls_type, cls_dim in self.num_classes.items():
            heads = list(self.modality_dims) if self.modality_cls else []
            if self.fusion_cls:
                heads.append("all-fused")
            self.classifier_keys[cls_type] = heads
            # reference Sequential(Dropout, Linear): the Linear keeps the
            # index ".1"; the dropout (model.dropout) is applied in
            # apply_classifier from the step's generator
            shared = nn.Sequential(nn.Identity(),
                                   nn.Linear(self.latent_dim, cls_dim))
            classifiers[cls_type] = nn.ModuleDict({h: shared for h in heads})
        self.classifiers = nn.ModuleDict(classifiers)

    def reset_parameters(self, gen):
        for mod in sorted(self.modality_dims):
            self.mapping[mod].reset_parameters(gen)
        self.fuser.reset_parameters(gen)
        for codec in (self.dim_encoder, self.dim_decoder):
            if codec is not None:
                L.init_torch_linear(codec, gen)
        self.future_predictor.reset_parameters(gen)
        for cls_type in sorted(self.num_classes):
            heads = self.classifiers[cls_type]
            L.init_torch_linear(heads[next(iter(heads))][1], gen)

    def apply_classifier(self, input_feat: Dict, outputs_prefix="",
                         rng=None):
        out = {}
        for cls_type in self.num_classes:
            out[f"{outputs_prefix}logits/{cls_type}"] = {
                headk: self.classifiers[cls_type][headk](L.dropout(
                    input_feat[headk], self.dropout_rate, self.training, rng))
                for headk in self.classifier_keys[cls_type]
                if headk in input_feat}
        return out

    @staticmethod
    def prepare_output(z: Dict, z_hat: Dict, fusions: Dict):
        """Split the predicted sequence into teacher-forced past and future
        (reference :155-182)."""
        out = {"orig_past": z, "future": dict(z_hat),
               "all-fused": dict(fusions), "past_futures": {}}
        T = next(iter(z.values())).shape[1]
        for modk in out["future"]:
            out["past_futures"][modk] = torch.cat(
                [z[modk][:, :1], out["future"][modk][:, :T - 1]], dim=1)
            out["future"][modk] = out["future"][modk][:, T - 1:]
        for modk in out["all-fused"]:
            out["all-fused"][modk] = out["all-fused"][modk][:, T - 1:]
        return out

    def forward(self, feats: Dict, *, impl="kernel", rng=None):
        """``rng``: the step's ``layers.RngStream`` (training mode only)."""
        order = [m for m in self.modal_feature_order if m in feats]
        x_hat = {m: self.mapping[m](x) for m, x in feats.items()}
        z, modality_attns = self.fuser(x_hat, order, impl=impl, rng=rng)
        z_enc = z if self.dim_encoder is None else self.dim_encoder(z)
        z_hat_enc, temporal_attns = self.future_predictor(
            z_enc, self.fp_output_len, impl=impl, rng=rng)
        z_hat = (z_hat_enc if self.dim_decoder is None
                 else self.dim_decoder(z_hat_enc))

        out = self.prepare_output({"all-fused": z}, {"all-fused": z_hat},
                                  {"all-fused": z})
        out.update(self.apply_classifier(out["past_futures"],
                                         PAST_LOGITS_PREFIX, rng))
        out.update(self.apply_classifier(out["future"], rng=rng))
        out["attentions"] = {"all-fused": {"modality_attns": modality_attns,
                                           "temporal_attns": temporal_attns}}
        return out
