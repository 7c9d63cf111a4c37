"""Finetuning models (port of uc2_tpu/models/finetune.py): retrieval
(``UC2ForImageTextRetrieval``: pair scores and the rank loss, for scoring
and for finetuning), VQA and VE (``UC2ForVqa``) and NLVR2
(``UC2ForNlvr2`` in its three formats, with ``CrossAttention``,
``AttentionPool`` and ``Nlvr2PairedAttnHead``; ``expand_type_embeddings``
grows a loaded token-type table to NLVR2's three rows).

Every model takes ``device`` (CUDA by default; asking for CUDA without a
GPU raises), ``seed`` and ``params``: without ``params`` the weights are
drawn from ``seed`` as the reference initialises them (normal(0,
initializer_range) weights and embeddings, zero biases, unit LayerNorm
scales); with ``params``, a reference parameter tree (nested dicts of
arrays from ``uc2_tpu``'s ``init_params`` or a converted checkpoint), they
are loaded from it. The heads' module names are the reference tree's, so
``models/convert.py`` maps ``vqa_output``, ``nlvr2_output`` and
``attn_head`` both ways. A deterministic call (``logits``, ``scores``)
runs without autograd (the fused inference blocks it routes to have no
backward); a training call (``deterministic=False``, dropout from ``rng``,
a ``DropoutRng``) keeps the graph.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config
from uc2_torch.models import heads as H
from uc2_torch.models.encoder import (Dense, UC2Model, compute_dtype, gelu,
                                      init_weights, share_parameters)
from uc2_torch.ops.dropout import dropout
from uc2_torch.ops.mp import einsum_f32


def _init(module, config, dev, seed, params):
    """Weights from ``seed``, or from the reference tree ``params``."""
    if params is None:
        init_weights(module, torch.Generator(device=dev).manual_seed(seed),
                     config.initializer_range)
    else:
        from uc2_torch.models.convert import load_params
        load_params(module, params)


class UC2ForImageTextRetrieval(nn.Module):
    """Rank-score model with the margin triplet loss."""

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
        _init(self, config, dev, seed, params)

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

    def serving(self, quant: str) -> "UC2ForImageTextRetrieval":
        """This model scoring under ``quant`` ("none" or "int8") over the
        same ``nn.Parameter`` objects, as the reference's ``eval_model``
        shares the training model's parameter tree: an update of one is an
        update of the other. Itself when ``quant`` is its own."""
        if quant == self.config.quant:
            return self
        return share_parameters(self, self.config.replace(quant=quant))

    def rank_loss(self, batch: Dict[str, torch.Tensor], sample_size: int,
                  deterministic=True, rng=None) -> torch.Tensor:
        """Margin triplet over groups of ``sample_size`` rows (row 0 of each
        group is the positive): clamp(margin + sigma(neg) - sigma(pos), 0),
        [groups, sample_size - 1]. Differentiable when ``deterministic``
        is False (``scores``)."""
        s = torch.sigmoid(self.scores(batch, deterministic, rng)).reshape(
            -1, sample_size)
        return torch.clamp(self.margin + s[:, 1:] - s[:, :1], min=0.0)


def _encode(encoder, batch, deterministic, rng, **extra):
    """(sequence output, pooled) of a batch."""
    return encoder(input_ids=batch["input_ids"], img_feat=batch["img_feat"],
                   img_pos_feat=batch["img_pos_feat"],
                   attn_mask=batch["attn_mask"], deterministic=deterministic,
                   rng=rng, **extra)


class UC2ForVqa(nn.Module):
    """VQA: ``VqaHead`` over the pooled output, BCE with logits against
    the soft targets; VE is ``num_answer`` = 3."""

    def __init__(self, config: UC2Config, num_answer: int, device="cuda",
                 seed: int = 0, params: Optional[Dict] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.num_answer = num_answer
        self.roberta = UC2Model(config, dev)
        self.vqa_output = H.VqaHead(config, num_answer, dev)
        _init(self, config, dev, seed, params)

    def logits(self, batch: Dict[str, torch.Tensor], deterministic=True,
               rng=None) -> torch.Tensor:
        """[B, num_answer] fp32 answer logits."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not deterministic):
            _, pooled = _encode(self.roberta, batch, deterministic, rng)
            return self.vqa_output(pooled)

    def loss(self, batch: Dict[str, torch.Tensor], deterministic=False,
             rng=None) -> torch.Tensor:
        """[B, num_answer] BCE elements against ``soft_targets``."""
        return H.bce_with_logits(self.logits(batch, deterministic, rng),
                                 batch["soft_targets"])


def expand_type_embeddings(params, n_types: int = 3):
    """A loaded reference tree's token-type table grown to ``n_types`` rows
    (NLVR2's), the new rows copied from row 1; in place, returned."""
    t = np.asarray(params["roberta"]["token_type_embeddings"])
    if t.shape[0] >= n_types:
        return params
    rows = [t[i] for i in range(t.shape[0])] + \
        [t[1]] * (n_types - t.shape[0])
    params["roberta"]["token_type_embeddings"] = np.stack(rows)
    return params


class AttentionPool(nn.Module):
    """Softmax pooling over a sequence: score gelu(fc(x)) plus -1e4 at
    pads, softmax in fp32, dropout on the probabilities, the weighted sum
    in x's dtype."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        self.fc = Dense(cfg.hidden_size, 1, compute_dtype(cfg), device)

    def forward(self, x, pad_mask, rng=None):
        score = gelu(self.fc(x))[..., 0]
        score = score + pad_mask.to(score.dtype) * -1e4
        p = torch.softmax(score.float(), dim=1)
        p = dropout(p, self.config.attention_probs_dropout_prob, rng)
        return torch.einsum("bt,btd->bd", p.to(x.dtype), x)


class CrossAttention(nn.Module):
    """One multi-head cross-attention layer: q from ``q_in``, k and v from
    ``kv_in``; scores bf16 in, fp32 out (``einsum_f32``) over sqrt(d),
    -1e4 at the keys' pads, softmax in fp32 and dropout on the
    probabilities, P . V in v's dtype, then the ``out`` projection."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H_, dt = cfg.hidden_size, compute_dtype(cfg)
        self.q = Dense(H_, H_, dt, device)
        self.k = Dense(H_, H_, dt, device)
        self.v = Dense(H_, H_, dt, device)
        self.out = Dense(H_, H_, dt, device)

    def forward(self, q_in, kv_in, kv_pad, rng=None):
        cfg = self.config
        B, Lq, Hd = q_in.shape
        Lk = kv_in.shape[1]
        n, d = cfg.num_attention_heads, cfg.head_dim
        q = self.q(q_in).reshape(B, Lq, n, d)
        k = self.k(kv_in).reshape(B, Lk, n, d)
        v = self.v(kv_in).reshape(B, Lk, n, d)
        scores = einsum_f32("blnd,bmnd->bnlm", q, k)
        scores = scores / math.sqrt(d) + torch.where(
            kv_pad[:, None, None, :], -1e4, 0.0)
        p = torch.softmax(scores, dim=-1)
        p = dropout(p, cfg.attention_probs_dropout_prob, rng)
        ctx = torch.einsum("bnlm,bmnd->blnd", p.to(v.dtype), v)
        return self.out(ctx.reshape(B, Lq, Hd))


class Nlvr2PairedAttnHead(nn.Module):
    """paired-attn's head: cross-attention left to right (``attn1``) and
    right to left (``attn2``); ``fc`` (dense, gelu, hidden dropout) over
    each side's [cross | own] states and ``attn_pool``, both shared by the
    two sides; ``nlvr2_output`` Linear(2H -> 2) over the two pooled
    vectors, fp32 logits."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H_, dt = cfg.hidden_size, compute_dtype(cfg)
        self.attn1 = CrossAttention(cfg, device)
        self.attn2 = CrossAttention(cfg, device)
        self.fc = Dense(2 * H_, H_, dt, device)
        self.attn_pool = AttentionPool(cfg, device)
        self.nlvr2_output = Dense(2 * H_, 2, dt, device)

    def forward(self, left, right, left_pad, right_pad, rng=None):
        rate = self.config.hidden_dropout_prob
        l2r = self.attn1(left, right, right_pad, rng)
        r2l = self.attn2(right, left, left_pad, rng)

        def fc(x):
            return dropout(gelu(self.fc(x)), rate, rng)
        left_p = self.attn_pool(fc(torch.cat([l2r, left], -1)), left_pad,
                                rng)
        right_p = self.attn_pool(fc(torch.cat([r2l, right], -1)), right_pad,
                                 rng)
        return self.nlvr2_output(torch.cat([left_p, right_p], -1)).float()


class UC2ForNlvr2(nn.Module):
    """NLVR2 in three formats, over an encoder with three token types
    (``img_type_ids`` 1 and 2 tell the two images apart):

    * "triplet": one row an example with both images; ``nlvr2_output``
      Linear(H -> 2) on the pooled output, in fp32;
    * "paired": two rows an example (2i, 2i + 1); Linear(2H -> 2) on the
      pair's pooled outputs side by side, in fp32;
    * "paired-attn": the rows of "paired" through ``Nlvr2PairedAttnHead``.

    The loss is the CE of the logits against ``targets``, one an
    example."""

    FORMATS = ("triplet", "paired", "paired-attn")

    def __init__(self, config: UC2Config, fmt: str = "triplet",
                 device="cuda", seed: int = 0,
                 params: Optional[Dict] = None):
        super().__init__()
        if fmt not in self.FORMATS:
            raise ValueError(f"unknown NLVR2 format {fmt!r}")
        dev = resolve_device(device)
        self.config = config
        self.fmt = fmt
        self.roberta = UC2Model(config.replace(type_vocab_size=3), dev)
        H_ = config.hidden_size
        if fmt == "paired-attn":
            self.attn_head = Nlvr2PairedAttnHead(config, dev)
        else:
            # the reference's raw fp32 kernel and bias: the pooled output
            # is promoted to fp32 for this product
            self.nlvr2_output = nn.Linear(
                H_ if fmt == "triplet" else 2 * H_, 2, device=dev)
        _init(self, config, dev, seed, params)

    def logits(self, batch: Dict[str, torch.Tensor], deterministic=True,
               rng=None) -> torch.Tensor:
        """[examples, 2] fp32 logits."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not deterministic):
            seq, pooled = _encode(self.roberta, batch, deterministic, rng,
                                  img_type_ids=batch.get("img_type_ids"))
            if self.fmt == "triplet":
                return self.nlvr2_output(pooled.float())
            if self.fmt == "paired":
                return self.nlvr2_output(
                    pooled.float().reshape(pooled.shape[0] // 2, -1))
            B, L, D = seq.shape
            pair = seq.reshape(B // 2, 2, L, D)
            pad = (batch["attn_mask"] == 0).reshape(B // 2, 2, L)
            return self.attn_head(pair[:, 0], pair[:, 1], pad[:, 0],
                                  pad[:, 1], rng if not deterministic
                                  else None)

    def loss(self, batch: Dict[str, torch.Tensor], deterministic=False,
             rng=None) -> torch.Tensor:
        """[examples] CE against ``targets``."""
        return H.cross_entropy_with_logits(
            self.logits(batch, deterministic, rng), batch["targets"])
