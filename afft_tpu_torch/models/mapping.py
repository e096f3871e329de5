"""Feature mapping: project each modality's features to the common width.

Port of afft_tpu/models/mapping.py ``LinearMapping`` (reference
models/feature_mapping.py Linear): a bias-free Linear, the identity when the
widths match and ``sparse_mapping`` is set, optionally followed by
LayerNorm(eps=1e-6). State-dict names follow the reference Sequential:
``mapping.0.weight`` and ``mapping.1.{weight,bias}``.
"""

from __future__ import annotations

import torch.nn as nn

from . import layers as L


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
