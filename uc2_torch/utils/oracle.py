"""An independent plain PyTorch UC2 encoder and rank head, a yardstick for
logit parity (a copy of the repository's tests/torch_oracle.py encoder,
``OracleUC2.encode`` and its modules).

Its parameter names are the original UC2 checkpoint's (``roberta.*``,
``cls.*``, ``feat_regress.*``, ``region_classifier.*``, ``itm_output``,
``rank_output``, ``vqa_output.*``), so a released state dict loads into it
without the port's converter; ``uc2_torch.verify_real_ckpt`` scores one
batch through it in fp32 beside the port's model. Nothing on the serving
or training path calls it.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def t_gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def make_positions(input_ids, pad):
    mask = input_ids.ne(pad).int()
    return (torch.cumsum(mask, 1).type_as(mask) * mask).long() + pad


class OracleEncoderLayer(nn.Module):
    def __init__(self, h, n, ffn, eps_block=1e-12):
        super().__init__()
        self.n = n
        self.d = h // n
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        self.attention.self.query = nn.Linear(h, h)
        self.attention.self.key = nn.Linear(h, h)
        self.attention.self.value = nn.Linear(h, h)
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(h, h)
        self.attention.output.LayerNorm = nn.LayerNorm(h, eps=eps_block)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(h, ffn)
        self.output = nn.Module()
        self.output.dense = nn.Linear(ffn, h)
        self.output.LayerNorm = nn.LayerNorm(h, eps=eps_block)

    def forward(self, x, bias):
        B, L, H = x.shape
        s = self.attention.self
        q = s.query(x).view(B, L, self.n, self.d).transpose(1, 2)
        k = s.key(x).view(B, L, self.n, self.d).transpose(1, 2)
        v = s.value(x).view(B, L, self.n, self.d).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d) + bias
        ctx = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, L, H)
        x = self.attention.output.LayerNorm(
            self.attention.output.dense(ctx) + x)
        h = t_gelu(self.intermediate.dense(x))
        x = self.output.LayerNorm(self.output.dense(h) + x)
        return x


class OracleUC2(nn.Module):
    def __init__(self, vocab=1000, h=64, n_layers=2, n_heads=4, ffn=128,
                 max_pos=66, type_vocab=2, img_dim=32, img_label_dim=11,
                 eps=1e-5, eps_block=1e-12, pad=1, num_answer=7):
        super().__init__()
        self.pad = pad
        self.roberta = nn.Module()
        emb = nn.Module()
        emb.word_embeddings = nn.Embedding(vocab, h, padding_idx=pad)
        emb.position_embeddings = nn.Embedding(max_pos, h, padding_idx=pad)
        emb.new_token_type_embeddings = nn.Embedding(type_vocab, h)
        emb.LayerNorm = nn.LayerNorm(h, eps=eps)
        self.roberta.embeddings = emb
        ie = nn.Module()
        ie.img_linear = nn.Linear(img_dim, h)
        ie.pos_linear = nn.Linear(7, h)
        ie.img_layer_norm = nn.LayerNorm(h, eps=eps)
        ie.pos_layer_norm = nn.LayerNorm(h, eps=eps)
        ie.LayerNorm = nn.LayerNorm(h, eps=eps)
        ie.mask_embedding = nn.Embedding(2, img_dim, padding_idx=0)
        self.roberta.img_embeddings = ie
        enc = nn.Module()
        enc.layer = nn.ModuleList(
            [OracleEncoderLayer(h, n_heads, ffn, eps_block)
             for _ in range(n_layers)])
        self.roberta.encoder = enc
        pooler = nn.Module()
        pooler.dense = nn.Linear(h, h)
        self.roberta.pooler = pooler
        # the checkpoint's heads, so that its keys load by name; only
        # rank_output is scored
        self.cls = nn.Module()
        self.cls.dense = nn.Linear(h, h)
        self.cls.layer_norm = nn.LayerNorm(h, eps=eps)
        self.cls.bias = nn.Parameter(torch.zeros(vocab))
        self.feat_regress = nn.Module()
        self.feat_regress.net = nn.ModuleList(
            [nn.Linear(h, h), nn.Identity(), nn.LayerNorm(h, eps=1e-12)])
        self.feat_regress.bias = nn.Parameter(torch.zeros(img_dim))
        self.region_classifier = nn.Module()
        self.region_classifier.net = nn.ModuleList(
            [nn.Linear(h, h), nn.Identity(), nn.LayerNorm(h, eps=1e-12),
             nn.Linear(h, img_label_dim)])
        self.itm_output = nn.Linear(h, 2)
        self.rank_output = nn.Linear(h, 1)
        self.vqa_output = nn.ModuleList(
            [nn.Linear(h, 2 * h), nn.Identity(), nn.LayerNorm(2 * h, eps=eps),
             nn.Linear(2 * h, num_answer)])

    def encode(self, input_ids, img_feat, img_pos_feat, attn_mask):
        """(sequence output, pooled) of [text | regions]."""
        emb = self.roberta.embeddings
        position_ids = make_positions(input_ids, self.pad)
        txt = (emb.word_embeddings(input_ids)
               + emb.position_embeddings(position_ids)
               + emb.new_token_type_embeddings(torch.zeros_like(input_ids)))
        txt = emb.LayerNorm(txt)
        ie = self.roberta.img_embeddings
        img = (ie.img_layer_norm(ie.img_linear(img_feat))
               + ie.pos_layer_norm(ie.pos_linear(img_pos_feat))
               + emb.new_token_type_embeddings(
                   torch.ones(img_feat.shape[:2], dtype=torch.long)))
        img = ie.LayerNorm(img)
        x = torch.cat([txt, img], dim=1)
        bias = (1.0 - attn_mask.float())[:, None, None, :] * -10000.0
        for layer in self.roberta.encoder.layer:
            x = layer(x, bias)
        pooled = torch.tanh(self.roberta.pooler.dense(x[:, 0]))
        return x, pooled

    def rank_scores(self, input_ids, img_feat, img_pos_feat, attn_mask):
        """[B] fp32 rank scores."""
        return self.rank_output(self.encode(
            input_ids, img_feat, img_pos_feat, attn_mask)[1])[:, 0]
