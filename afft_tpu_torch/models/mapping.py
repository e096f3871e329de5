"""Feature mapping: project each modality's features to the common width.

Port of afft_tpu/models/mapping.py (reference models/feature_mapping.py):
- ``LinearMapping`` (Linear :54-78): a bias-free Linear, the identity when
  the widths match and ``sparse_mapping`` is set, optionally followed by
  LayerNorm(eps=1e-6);
- ``GatedLinearMapping`` (GatedLinear :32-51): Linear, context gating
  (``x * sigmoid(fc(x))``, ContextGating :21-29), optional LayerNorm;
- ``NonLinearMapping`` (NonLinear :91-111): Linear, relu / gelu / none,
  optional LayerNorm;
- ``GatedEmbeddingUnit`` (:9-18): Linear and context gating.
State-dict names follow the reference Sequentials (the export layout of
afft_tpu/train/torch_export.py ``export_mapping``): ``mapping.0`` the
Linear, ``mapping.1`` the LayerNorm of ``LinearMapping`` or the gating
(``mapping.1.fc``) of ``GatedLinearMapping``, ``mapping.2`` the LayerNorm
of the gated and non-linear mappings; ``fc`` and ``cg.fc`` for the unit.
Plain PyTorch: the JAX package runs no kernel here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L

ACTIVATIONS = {"relu": F.relu,
               "gelu": lambda x: F.gelu(x, approximate="none"),
               "none": lambda x: x}


class LinearMapping(nn.Module):
    def __init__(self, in_features, out_features, use_layernorm=False,
                 sparse_mapping=True):
        super().__init__()
        self.use_layernorm = use_layernorm
        self.identity = sparse_mapping and in_features == out_features
        layers = [nn.Identity() if self.identity
                  else nn.Linear(in_features, out_features, bias=False)]
        if use_layernorm:
            layers.append(nn.LayerNorm(out_features, eps=1e-6))
        self.mapping = nn.Sequential(*layers)

    def reset_parameters(self, gen):
        if not self.identity:
            L.init_torch_linear(self.mapping[0], gen)
        if self.use_layernorm:
            L.init_layer_norm(self.mapping[1])

    def forward(self, x):
        return self.mapping(x)


class ContextGating(nn.Module):
    """glu(cat(x, fc(x))) == x * sigmoid(fc(x))."""

    def __init__(self, dim):
        super().__init__()
        self.fc = nn.Linear(dim, dim)

    def reset_parameters(self, gen):
        L.init_torch_linear(self.fc, gen)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x))


class _Activation(nn.Module):
    """The NonLinear mapping's activation slot (``mapping.1``, no
    parameters)."""

    def __init__(self, name):
        super().__init__()
        if name not in ACTIVATIONS:
            raise ValueError(f"activation {name!r}: one of "
                             f"{sorted(ACTIVATIONS)}")
        self.name = name

    def forward(self, x):
        return ACTIVATIONS[self.name](x)


class _LinearThen(nn.Module):
    """Linear (``mapping.0``), a middle stage (``mapping.1``), optional
    LayerNorm(eps=1e-6) (``mapping.2``)."""

    def __init__(self, in_features, out_features, middle, use_layernorm):
        super().__init__()
        self.use_layernorm = use_layernorm
        layers = [nn.Linear(in_features, out_features), middle]
        if use_layernorm:
            layers.append(nn.LayerNorm(out_features, eps=1e-6))
        self.mapping = nn.Sequential(*layers)

    def reset_parameters(self, gen):
        L.init_torch_linear(self.mapping[0], gen)
        if isinstance(self.mapping[1], ContextGating):
            self.mapping[1].reset_parameters(gen)
        if self.use_layernorm:
            L.init_layer_norm(self.mapping[2])

    def forward(self, x):
        return self.mapping(x)


class GatedLinearMapping(_LinearThen):
    def __init__(self, in_features, out_features, use_layernorm=True):
        super().__init__(in_features, out_features,
                         ContextGating(out_features), use_layernorm)


class NonLinearMapping(_LinearThen):
    def __init__(self, in_features, out_features, use_layernorm=True,
                 activation="relu"):
        super().__init__(in_features, out_features, _Activation(activation),
                         use_layernorm)


class GatedEmbeddingUnit(nn.Module):
    """Linear and context gating, no LayerNorm (``fc``, ``cg.fc``)."""

    def __init__(self, in_features=None, out_features=None,
                 input_dimension=None, output_dimension=None):
        super().__init__()
        in_features = in_features or input_dimension
        out_features = out_features or output_dimension
        self.fc = nn.Linear(in_features, out_features)
        self.cg = ContextGating(out_features)

    def reset_parameters(self, gen):
        L.init_torch_linear(self.fc, gen)
        self.cg.reset_parameters(gen)

    def forward(self, x):
        return self.cg(self.fc(x))
