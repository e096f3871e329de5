"""Backbones. Every shipped config uses an identity backbone over
pre-extracted features (reference conf/model/backbone/identity.yaml)."""

import torch.nn as nn


class Identity(nn.Identity):
    """The ``torch.nn.Identity`` target of the conf tree."""
