"""Retrieval model (port of uc2_tpu/models/finetune.py
``UC2ForImageTextRetrieval``): pair scores and the rank loss, for scoring
and for finetuning."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config
from uc2_torch.models import heads as H
from uc2_torch.models.encoder import UC2Model, init_weights


class UC2ForImageTextRetrieval(nn.Module):
    """Rank-score model with the margin triplet loss.

    The parameters live on ``device`` (CUDA by default; asking for CUDA
    without a GPU raises). Without ``params`` they are drawn from ``seed``
    as the reference initialises them (normal(0, initializer_range)
    weights and embeddings, zero biases, unit LayerNorm scales); with
    ``params``, a reference parameter tree (nested dicts of arrays from
    ``uc2_tpu``'s ``init_params`` or a converted checkpoint), they are
    loaded from it.
    """

    def __init__(self, config: UC2Config, margin: float = 0.2,
                 device="cuda", seed: int = 0,
                 params: Optional[Dict] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.margin = margin
        self.roberta = UC2Model(config, dev)
        self.itm_output = H.ItmHead(config, dev)
        self.rank_output = H.RankHead(config, dev)
        if params is None:
            init_weights(self, torch.Generator(device=dev).manual_seed(seed),
                         config.initializer_range)
        else:
            from uc2_torch.models.convert import load_params
            load_params(self, params)

    def scores(self, batch: Dict[str, torch.Tensor], deterministic=True,
               rng=None) -> torch.Tensor:
        """[B] fp32 rank scores of a batch of (text, image) pairs. A
        deterministic call is the scoring path: it runs without autograd
        (the fused inference blocks it routes to have no backward); a
        training call (``deterministic=False``, dropout from ``rng``, a
        ``DropoutRng``) keeps the graph."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not deterministic):
            _, pooled = self.roberta(
                input_ids=batch["input_ids"],
                position_ids=batch.get("position_ids"),
                img_feat=batch["img_feat"],
                img_pos_feat=batch["img_pos_feat"],
                attn_mask=batch["attn_mask"], deterministic=deterministic,
                rng=rng)
            return self.rank_output(pooled)[:, 0]

    def rank_loss(self, batch: Dict[str, torch.Tensor], sample_size: int,
                  deterministic=True, rng=None) -> torch.Tensor:
        """Margin triplet over groups of ``sample_size`` rows (row 0 of each
        group is the positive): clamp(margin + sigma(neg) - sigma(pos), 0),
        [groups, sample_size - 1]. Differentiable when ``deterministic``
        is False (``scores``)."""
        s = torch.sigmoid(self.scores(batch, deterministic, rng)).reshape(
            -1, sample_size)
        return torch.clamp(self.margin + s[:, 1:] - s[:, :1], min=0.0)
