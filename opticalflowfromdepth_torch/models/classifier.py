"""Auxiliary augmentation classifier (port of
``opticalflowfromdepth_tpu/models/classifier.py``).

A residual encoder over the 2-channel flow map, global mean (or max)
pooling, ReLU, optional dropout, and a linear layer to the four classes
{none, flip, rotate, shear}. The ``state_dict`` names are the reference's
(``auxiliary_classifier/classifier.py:269-333``): ``encoder.*`` and
``classify.3`` (``classify.4`` with dropout in the head), where
``classify`` is ``[pool, flatten, relu, (dropout), linear]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..utils.profiling import spanned
from .layers import BasicEncoder, SmallEncoder, dropout

NUM_CLASSES = 1 + 3  # `classifier.py:5`


class Classifier(nn.Module):
    """flow ``[B, 2, H, W]`` -> f32 logits ``[B, 4]``."""

    def __init__(self, output_dim: int = 64, norm_fn: str = "batch",
                 dropout: float = 0.9, use_small: bool = False,
                 use_dropout_in_encoder: bool = True,
                 use_dropout_in_classify: bool = False,
                 use_average_pooling: bool = True, dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.use_dropout_in_classify = use_dropout_in_classify
        self.use_average_pooling = use_average_pooling
        self.dtype = dtype
        enc = SmallEncoder if use_small else BasicEncoder
        self.encoder = enc(output_dim, norm_fn, dtype=dtype,
                           dropout=dropout if use_dropout_in_encoder else 0.0,
                           in_dim=2)
        # the reference's head is Sequential(pool, flatten, relu,
        # [dropout,] linear); only the linear layer has weights
        self.linear_key = "4" if use_dropout_in_classify else "3"
        self.classify = nn.ModuleDict(
            {self.linear_key: nn.Linear(output_dim, NUM_CLASSES)})

    @spanned("ofd.classifier")
    def forward(self, flow: torch.Tensor, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        train = self.training if train is None else train
        x = self.encoder(flow.to(self.dtype), train, generator)
        x = x.mean(dim=(2, 3)) if self.use_average_pooling \
            else x.amax(dim=(2, 3))
        x = torch.relu(x)
        if train and self.use_dropout_in_classify:
            x = dropout(x, self.dropout, generator)
        linear = self.classify[self.linear_key]
        x = nn.functional.linear(x, linear.weight.to(self.dtype),
                                 linear.bias.to(self.dtype))
        return x.float()
