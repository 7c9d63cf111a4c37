"""Small helpers of the drivers (the parts of uc2_tpu/utils/misc.py that
the pretraining driver uses)."""

from __future__ import annotations

import random

import numpy as np
import torch

from uc2_torch.config import UC2Config


def set_random_seed(seed: int):
    """Seed Python's, numpy's and PyTorch's global generators. The port's
    own randomness (weights, dropout, data) comes from generators it seeds
    explicitly; this covers any library code that reads the globals."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def set_dropout(config: UC2Config, drop_p: float) -> UC2Config:
    """Every dropout rate of the model set to ``drop_p`` (the reference's
    ``--dropout``)."""
    return config.replace(hidden_dropout_prob=drop_p,
                          attention_probs_dropout_prob=drop_p)
