"""Cross-modal fusion and future prediction heads: the CMFP variants.

Port of afft_tpu/models/cmfp.py (reference models/future_prediction.py):
``_CMFPBase`` wires the mapping layers, the fuser, the dim encoder /
decoder, the future predictor(s) and the classifiers
(CrossModalFusionPrediction :19-186); the three variants compose them:
- ``CMFPEarly`` (:228-291): map -> fuse -> predict on the fused sequence,
  one codec, one shared predictor and classifier;
- ``IndividualFuturePrediction`` (:189-225): each modality predicted on its
  own, no mapping and no fuser;
- ``CMFPScoreFusion`` (:294-351): each modality predicted and classified on
  its own, the logits fused by ``MATT`` weights computed over the mapped
  [first original frame, predicted frames].
Each returns the reference's output dictionary (``logits/*``,
``past_logits/*``, ``orig_past``, ``future``, ``past_futures``,
``all-fused``, ``attentions`` for the early variant).

State-dict names (afft_tpu/train/torch_export.py ``export_cmfp``):
``mapping.<mod>.*``, ``fuser.*``; ``dim_encoder`` / ``dim_decoder`` (early)
or ``dim_encoder.<mod>`` / ``dim_decoder.<mod>`` (per modality; nothing
where the widths match); ``future_predictor.gpt_model.*`` (shared) or
``future_predictor.<mod>.gpt_model.*``; ``classifiers.<cls>.<head>.1``,
where a shared classifier is registered under every head key, as the
reference does, and a per-head classifier takes its head's own width
(the latent width for ``all-fused``, the modality's otherwise).
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


def _apply_codec(codec, x):
    return x if codec is None else codec(x)


class _CMFPBase(nn.Module):
    """The shared wiring (afft_tpu/models/cmfp.py ``_CMFPBase``)."""

    uses_fuser = True
    uses_mapping = True

    def __init__(self, model_cfg, num_classes: Dict[str, int],
                 fuser_need_weights: bool = False):
        """``fuser_need_weights``: the fuser also returns its attention
        weights (``visualize_attention``; it then runs its plain path). Only
        a CMFP that fuses before predicting has such weights to return; the
        others ignore the flag."""
        super().__init__()
        self.fuser_need_weights = fuser_need_weights
        common = model_cfg["common"]
        self.num_classes = dict(num_classes)
        self.latent_dim = common["in_features"]
        self.fp_inter_dim = common["fp_inter_dim"]
        self.fp_output_len = common["fp_output_len"]
        self.modality_dims = dict(model_cfg["modal_dims"].items())
        self.modal_feature_order = list(model_cfg["modal_feature_order"])
        self.dropout_rate = model_cfg["dropout"]
        self.common_predictor = common["share_predictors"]
        self.common_classifier = common["share_classifiers"]
        self.modality_cls = common["modality_cls"]
        self.fusion_cls = common["fusion_cls"]
        if not (self.modality_cls or self.fusion_cls):
            raise ValueError("needs modality-level and / or fusion "
                             "classification")

        if self.uses_mapping:
            self.mapping = nn.ModuleDict({
                mod: instantiate(model_cfg["mapping"], in_features=dim,
                                 out_features=self.latent_dim)
                for mod, dim in self.modality_dims.items()})
        if self.uses_fuser:
            self.fuser = instantiate(model_cfg["fuser"], _recursive_=False)
        self._init_dim_codec()

        def predictor():
            return instantiate(model_cfg["future_predictor"],
                               in_features=self.fp_inter_dim,
                               dimension_mapping=False, _recursive_=False)
        if self.common_predictor:
            self.future_predictor = predictor()
        else:
            self.future_predictor = nn.ModuleDict(
                {mod: predictor() for mod in self.modality_dims})

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
            if self.common_classifier:
                shared = nn.Sequential(nn.Identity(),
                                       nn.Linear(self.latent_dim, cls_dim))
                classifiers[cls_type] = nn.ModuleDict(
                    {h: shared for h in heads})
            else:
                classifiers[cls_type] = nn.ModuleDict({
                    h: nn.Sequential(nn.Identity(), nn.Linear(
                        self.latent_dim if h == "all-fused"
                        else self.modality_dims[h], cls_dim))
                    for h in heads})
        self.classifiers = nn.ModuleDict(classifiers)

    def _init_dim_codec(self):
        """Per-modality encoder / decoder between the modality's width and
        the predictor's (reference :56-72); the identity where they
        match."""
        enc = {m: _codec(d, self.fp_inter_dim)
               for m, d in self.modality_dims.items()}
        dec = {m: _codec(self.fp_inter_dim, d)
               for m, d in self.modality_dims.items()}
        self.dim_encoder = nn.ModuleDict(
            {m: c for m, c in enc.items() if c is not None})
        self.dim_decoder = nn.ModuleDict(
            {m: c for m, c in dec.items() if c is not None})

    def _codecs(self, modk):
        return (self.dim_encoder[modk] if modk in self.dim_encoder else None,
                self.dim_decoder[modk] if modk in self.dim_decoder else None)

    def predictors(self):
        """{name: predictor}: ``shared``, or one per modality."""
        if self.common_predictor:
            return {"shared": self.future_predictor}
        return dict(self.future_predictor.items())

    def logit_heads(self, cls_type: str) -> list:
        """The heads of ``logits/<cls_type>`` in the outputs."""
        return list(self.classifier_keys[cls_type])

    def reset_parameters(self, gen):
        if self.uses_mapping:
            for mod in sorted(self.modality_dims):
                self.mapping[mod].reset_parameters(gen)
        if self.uses_fuser:
            self.fuser.reset_parameters(gen)
        for codec in self._codec_modules():
            L.init_torch_linear(codec, gen)
        for _, pred in sorted(self.predictors().items()):
            pred.reset_parameters(gen)
        for cls_type in sorted(self.num_classes):
            heads = self.classifiers[cls_type]
            if self.common_classifier:
                L.init_torch_linear(heads[next(iter(heads))][1], gen)
            else:
                for head in heads.values():
                    L.init_torch_linear(head[1], gen)

    def _codec_modules(self):
        return [self.dim_encoder[m] for m in sorted(self.dim_encoder)] + \
            [self.dim_decoder[m] for m in sorted(self.dim_decoder)]

    def _predict(self, modk, feats, *, impl, rng):
        pred = (self.future_predictor if self.common_predictor
                else self.future_predictor[modk])
        return pred(feats, self.fp_output_len, impl=impl, rng=rng)

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

    def feature_mapping(self, x_d: Dict):
        return {m: self.mapping[m](x) for m, x in x_d.items()}

    def feats_order(self, feats: Dict):
        return [m for m in self.modal_feature_order if m in feats]

    def _predict_each(self, z: Dict, *, impl, rng):
        """Every modality through its codec and predictor: ({mod: predicted
        sequence at the modality's width}, {mod: predictor endpoints})."""
        z_hat, attentions = {}, {}
        for modk, z_unimod in z.items():
            enc, dec = self._codecs(modk)
            z_hat_enc, atts = self._predict(modk, _apply_codec(enc, z_unimod),
                                            impl=impl, rng=rng)
            z_hat[modk] = _apply_codec(dec, z_hat_enc)
            attentions[modk] = atts
        return z_hat, attentions


class CMFPEarly(_CMFPBase):
    """Early fusion: map -> fuse -> predict on the fused sequence
    (reference :228-291). Shared classifier and predictor are implied
    (:235-242)."""

    def __init__(self, model_cfg, num_classes: Dict[str, int],
                 fuser_need_weights: bool = False):
        # early fusion implies a shared classifier and predictor (reference
        # :235-242 sets the same flags on the shared config object)
        common = model_cfg["common"]
        common["share_classifiers"] = True
        common["share_predictors"] = True
        super().__init__(model_cfg, num_classes, fuser_need_weights)

    def _init_dim_codec(self):
        """The fused features are at the latent width: one codec
        (reference :245-255)."""
        self.dim_encoder = _codec(self.latent_dim, self.fp_inter_dim)
        self.dim_decoder = _codec(self.fp_inter_dim, self.latent_dim)

    def _codec_modules(self):
        return [c for c in (self.dim_encoder, self.dim_decoder)
                if c is not None]

    def forward(self, feats: Dict, *, impl="kernel", rng=None):
        """``rng``: the step's ``layers.RngStream`` (training mode only)."""
        order = self.feats_order(feats)
        x_hat = self.feature_mapping(feats)
        z, modality_attns = self.fuser(
            x_hat, order, need_weights=self.fuser_need_weights, impl=impl,
            rng=rng)
        z_hat_enc, temporal_attns = self._predict(
            None, _apply_codec(self.dim_encoder, z), impl=impl, rng=rng)
        z_hat = _apply_codec(self.dim_decoder, z_hat_enc)

        out = self.prepare_output({"all-fused": z}, {"all-fused": z_hat},
                                  {"all-fused": z})
        out.update(self.apply_classifier(out["past_futures"],
                                         PAST_LOGITS_PREFIX, rng))
        out.update(self.apply_classifier(out["future"], rng=rng))
        out["attentions"] = {"all-fused": {"modality_attns": modality_attns,
                                           "temporal_attns": temporal_attns}}
        return out


class IndividualFuturePrediction(_CMFPBase):
    """Per-modality prediction, no fusion (reference :189-225)."""

    uses_fuser = False
    uses_mapping = False

    def __init__(self, model_cfg, num_classes: Dict[str, int],
                 fuser_need_weights: bool = False):
        if model_cfg["common"]["fusion_cls"]:
            raise ValueError("fusion_cls must be off for individual "
                             "prediction")
        super().__init__(model_cfg, num_classes, fuser_need_weights)

    def forward(self, z: Dict, *, impl="kernel", rng=None):
        z_hat, _ = self._predict_each(z, impl=impl, rng=rng)
        out = self.prepare_output(z, z_hat, {})
        out.update(self.apply_classifier(out["past_futures"],
                                         PAST_LOGITS_PREFIX, rng))
        out.update(self.apply_classifier(out["future"], rng=rng))
        return out


class CMFPScoreFusion(_CMFPBase):
    """RULSTM-style late fusion: per-modality predictions and logits, fused
    by MATT weights (reference :294-351)."""

    def __init__(self, model_cfg, num_classes: Dict[str, int],
                 fuser_need_weights: bool = False):
        if model_cfg["common"]["fusion_cls"]:
            raise ValueError("fusion_cls is not used by score fusion: the "
                             "scores are fused directly")
        model_cfg["common"]["modality_cls"] = True
        super().__init__(model_cfg, num_classes, fuser_need_weights)

    def logit_heads(self, cls_type: str) -> list:
        return ["all-fused"]

    def forward(self, z: Dict, *, impl="kernel", rng=None):
        order = self.feats_order(z)
        z_hat, _ = self._predict_each(z, impl=impl, rng=rng)
        # the first original frame and the predicted frames, mapped to the
        # common width
        z_hat_cat = self.feature_mapping(
            {m: torch.cat([z[m][:, :1], z_hat[m]], dim=1) for m in z})
        modality_attns = self.fuser(z_hat_cat, order, impl=impl, rng=rng)

        out = self.prepare_output(z, z_hat, {})
        logits_past = self.apply_classifier(out["past_futures"],
                                            PAST_LOGITS_PREFIX, rng)
        logits_future = self.apply_classifier(out["future"], rng=rng)
        for cls_type in self.num_classes:
            lp = logits_past[f"{PAST_LOGITS_PREFIX}logits/{cls_type}"]
            lf = logits_future[f"logits/{cls_type}"]
            past_final = torch.zeros_like(next(iter(lp.values())))
            future_final = torch.zeros_like(next(iter(lf.values())))
            for i, modk in enumerate(order):
                past_final = past_final + \
                    modality_attns[:, :-1, i][..., None] * lp[modk]
                future_final = future_final + \
                    modality_attns[:, -1:, i][..., None] * lf[modk]
            out[f"{PAST_LOGITS_PREFIX}logits/{cls_type}"] = \
                {"all-fused": past_final}
            out[f"logits/{cls_type}"] = {"all-fused": future_final}
        return out
