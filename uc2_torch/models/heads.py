"""Output heads and losses (port of uc2_tpu/models/heads.py).

Weight tying is explicit, as in the reference: the LM decoder is the
encoder's word-embedding table, passed in by the caller, so the head owns
no copy (and the parameter trees of the two packages line up); the region
regression head is tied to the transposed ``img_linear`` weight the same
way.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uc2_torch.config import UC2Config
from uc2_torch.models.encoder import Dense, LayerNorm, compute_dtype, gelu
from uc2_torch.ops.mp import einsum_f32
from uc2_torch.parallel import tensor as TP


class _Transform(nn.Module):
    """dense -> gelu -> LayerNorm, the front of every pretraining head."""

    def __init__(self, cfg: UC2Config, eps: float, device=None):
        super().__init__()
        dt = compute_dtype(cfg)
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dt, device)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps, dt, device)

    def transform(self, h):
        return self.layer_norm(gelu(self.dense(h)))


class UniqueRows(torch.autograd.Function):
    """``table[idx]`` for indices that are all distinct (the label
    vocabulary's sorted ``valid_ids``): the backward writes each picked
    row of the table's gradient once, with no adds, so no float atomics
    decide its bits."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.rows, *grad.shape[1:])
        return out.index_copy_(0, idx, grad), None


class RobertaLMHead(_Transform):
    """dense -> gelu -> LN(config eps) -> decoder tied to the word
    embeddings + bias. ``valid_ids`` (sorted, distinct) restricts the output
    vocabulary (the mmxlm-soft/vmlm-soft objectives); its index tensor is
    built on the table's device once per array and reused. ``transform_only``
    stops before the decoder (the chunked CE computes it itself). Logits
    are fp32; the decoder product's backward runs in the compute dtype
    (``einsum_f32``).

    Under tensor parallelism the table and the bias are this process's
    vocabulary shard: the logits are the shard's [..., V_m] (for
    ``TP.vocab_parallel_cross_entropy``), and with ``valid_ids`` the rows
    of the whole table are gathered (``TP.vocab_parallel_rows``), so the
    restricted logits are whole on every process."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__(cfg, cfg.layer_norm_eps, device)
        self.vocab_size = cfg.vocab_size
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))
        self._valid = (None, None)    # (valid_ids given, its index tensor)

    def _index(self, valid_ids, device):
        if self._valid[0] is not valid_ids or self._valid[1].device != device:
            self._valid = (valid_ids, torch.as_tensor(
                valid_ids, device=device).long())
        return self._valid[1]

    def forward(self, h, embedding_table, valid_ids=None,
                transform_only: bool = False):
        x = self.transform(h)
        if transform_only:
            return x
        table, bias = embedding_table, self.bias
        if valid_ids is not None:
            idx = self._index(valid_ids, table.device)
            if TP.tp_size() == 1:
                table = UniqueRows.apply(table, idx)
                bias = UniqueRows.apply(bias, idx)
            else:
                table, bias = (TP.vocab_parallel_rows(
                    t, idx, self.vocab_size, UniqueRows.apply)
                    for t in (table, bias))
        else:
            x = TP.copy_to_model(x)
        logits = einsum_f32("...h,vh->...v", x, table.to(x.dtype))
        return logits + bias.float()


class RegionFeatureRegression(_Transform):
    """The mrfr head: dense -> gelu -> LN(1e-12) -> the transposed
    ``img_linear`` weight (tied, passed in) + bias, fp32 out."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__(cfg, cfg.block_layer_norm_eps, device)
        self.bias = nn.Parameter(torch.zeros(cfg.img_dim, device=device))

    def forward(self, h, img_linear_weight):
        """img_linear_weight [hidden, img_dim] (``nn.Linear`` layout)."""
        x = self.transform(h)
        out = einsum_f32("...h,vh->...v", x,
                         img_linear_weight.to(x.dtype).t())
        return out + self.bias.float()


class RegionClassification(_Transform):
    """The mrc head: dense -> gelu -> LN(1e-12) -> linear(img_label_dim),
    fp32 logits."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__(cfg, cfg.block_layer_norm_eps, device)
        self.out = Dense(cfg.hidden_size, cfg.img_label_dim,
                         compute_dtype(cfg), device)

    def forward(self, h):
        return self.out(self.transform(h)).float()


class NceHead(_Transform):
    """The mrm-nce projection: dense -> gelu -> LN(1e-12) ->
    linear(img_dim), in the compute dtype."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__(cfg, cfg.block_layer_norm_eps, device)
        self.out = Dense(cfg.hidden_size, cfg.img_dim, compute_dtype(cfg),
                         device)

    def forward(self, h):
        return self.out(self.transform(h))


class ItmHead(nn.Module):
    """Linear(hidden -> 2), fp32 logits."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.out = Dense(cfg.hidden_size, 2, compute_dtype(cfg), device)

    def forward(self, pooled):
        return self.out(pooled).float()


class RankHead(nn.Module):
    """Linear(hidden -> 1) for retrieval, fp32 scores."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.out = Dense(cfg.hidden_size, 1, compute_dtype(cfg), device)

    def forward(self, pooled):
        return self.out(pooled).float()


class VqaHead(nn.Module):
    """pooled -> Linear(H -> 2H) -> gelu -> LN(config eps) ->
    Linear(2H -> num_answer), fp32 logits (VE: three answers). The
    LayerNorm takes ``layer_norm_eps`` (1e-5 for uc2-base), not the
    in-block eps."""

    def __init__(self, cfg: UC2Config, num_answer: int, device=None):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.dense = Dense(H, 2 * H, dt, device)
        self.layer_norm = LayerNorm(2 * H, cfg.layer_norm_eps, dt, device)
        self.out = Dense(2 * H, num_answer, dt, device)

    def forward(self, pooled):
        return self.out(self.layer_norm(gelu(self.dense(pooled)))).float()


def cross_entropy_with_logits(logits, labels, weights=None):
    """Per-element CE: logits [..., V] (fp32), labels [...] int. Returns
    logsumexp - gold logit, times ``weights`` when given."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.logsumexp(logits, dim=-1) - gold
    return loss if weights is None else loss * weights


def kl_div_with_logits(logits, target_probs, weights=None,
                       elementwise: bool = False):
    """KL(target || softmax(logits)) with 0 log 0 = 0, in fp32:
    ``elementwise`` gives the per-class elements [..., V] (the soft losses
    reduce with a flat mean over them), else their sum over the classes,
    times ``weights`` when given."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = target_probs.float()
    elem = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-30))
                                   - logp), 0.0)
    if elementwise:
        return elem
    loss = elem.sum(-1)
    return loss if weights is None else loss * weights


def _chunk_lse(h, tbl, b, m, s):
    """Online logsumexp step over one vocabulary chunk."""
    logits = einsum_f32("...h,vh->...v", h.to(tbl.dtype), tbl) + b.float()
    new_m = torch.maximum(m, logits.max(dim=-1).values)
    s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(-1)
    return new_m, s


def chunked_softmax_cross_entropy(h, table, bias, labels, weights,
                                  n_chunks: int = 8, vocab_size=None):
    """CE over a large vocabulary without the [N, V] logits: the decoder
    table is streamed in ``n_chunks`` chunks with an online logsumexp, each
    chunk recomputed in the backward (``torch.utils.checkpoint``), as the
    reference's ``jax.checkpoint``-ed scan.

    h [N, H] (head transform output), table [V, H], bias [V], labels [N],
    weights [N]. Returns the per-element weighted CE [N]. Under tensor
    parallelism table and bias are this process's vocabulary shard and
    ``vocab_size`` the whole vocabulary's: each process streams its shard,
    and the running max and sum, and the gold logit from its owner, are
    combined over the model group."""
    if TP.tp_size() > 1:
        return _chunked_ce_tp(h, table, bias, labels, weights, n_chunks,
                              vocab_size)
    labels = labels.long()
    gold = ((h.float() * table[labels].float()).sum(-1) + bias[labels])
    m, s = _online_lse(h, table, bias, n_chunks)
    loss = m + torch.log(s) - gold
    return loss if weights is None else loss * weights


def _online_lse(h, table, bias, n_chunks):
    """The running (max, sum of exp) over ``n_chunks`` chunks of the rows
    of ``table``, each chunk recomputed in the backward."""
    N, H = h.shape
    pad = (-table.shape[0]) % n_chunks
    if pad:
        table = torch.cat([table, table.new_zeros(pad, H)])
        # padded rows must never win the logsumexp
        bias = torch.cat([bias, bias.new_full((pad,), -1e30)])
    C = table.shape[0] // n_chunks
    m = torch.full((N,), -torch.inf, device=h.device)
    s = torch.zeros(N, device=h.device)
    for i in range(n_chunks):
        m, s = checkpoint(_chunk_lse, h, table[i * C:(i + 1) * C],
                          bias[i * C:(i + 1) * C], m, s, use_reentrant=False)
    return m, s


def _chunked_ce_tp(h, table, bias, labels, weights, n_chunks, vocab_size):
    """``chunked_softmax_cross_entropy`` over a vocabulary shard."""
    h = TP.copy_to_model(h)
    labels = labels.long()
    owned, local = TP.vocab_owned(labels, vocab_size)
    gold = (h.float() * table[local].float()).sum(-1) + bias[local]
    gold = TP.reduce_from_model(torch.where(owned, gold, 0.0))
    m, s = _online_lse(h, table, bias, n_chunks)
    mx = TP.max_over_model(m)
    total = TP.reduce_from_model(s * torch.exp(m - mx))
    loss = mx + torch.log(total) - gold
    return loss if weights is None else loss * weights


def bce_with_logits(logits, targets):
    """Per-element binary CE with logits in fp32 (the VQA loss):
    max(x, 0) - x t + log1p(exp(-|x|)); the max's gradient at x = 0 is
    0, as the reference's ``jnp.maximum(x, 0)`` gives it."""
    x = logits.float()
    t = targets.float()
    return torch.relu(x) - x * t + torch.log1p(torch.exp(-x.abs()))
