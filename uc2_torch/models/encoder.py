"""Single-stream vision-language encoder (port of uc2_tpu/models/encoder.py).

Same layout and numerics as the reference package: the joint sequence is
``[txt_0..txt_{Lt-1} | img_0..img_{Nb-1}]`` at fixed offsets, validity is
carried only by the additive mask ``(1 - m) * -10000``, parameters are fp32
and activations run in ``config.dtype`` with fp32 softmax and LayerNorm
statistics, and the QKV projection is one fused [H, 3H] matmul.

Module names follow the reference's parameter tree (``layer_0`` becomes
``layer.0``), and linear weights are in ``nn.Linear`` layout ([out, in]);
``models/convert.py`` maps one onto the other.

Training (``deterministic=False``) takes a ``DropoutRng`` (``ops/dropout.py``)
and drops at the reference's sites: hidden dropout after both embedding
LayerNorms, after the attention out-projection and after the FFN down
projection, and attention-probs dropout inside attention
(``ops/attention.py``). The fused inference blocks run only when
deterministic, as in the reference.

``quant="int8"`` is the serving path: the four products of every block
(``qkv``, ``attention_output_dense``, ``intermediate_dense``,
``output_dense``) run ``ops/int8.py``'s ``int8_linear``, the embeddings'
products, the pooler and the heads stay in ``dtype``, and the fused
blocks are off, so attention runs ``flash_attention`` (#1, #4 at long L);
a training call raises (the reference's rounding has a zero gradient and
its drivers never train the int8 model). ``share_parameters`` builds a
second module tree over the same parameters under another config, the
reference's second model over one parameter tree.

Under tensor parallelism (``uc2_torch/parallel/tensor.py``, a model cut by
``shard_module`` into a model group's shards) each layer holds its
process's heads (QKV column-parallel, head-aligned) and intermediate
columns: QKV and the FFN's first product read ``copy_to_model`` of the
input, attention runs on the local heads (the training kernels and the
eager dropout draw those heads' masks of the whole layer), the
out-projection and the FFN's second product are row-parallel, their fp32
partial products summed by ``reduce_from_model`` before the bias,
dropout, residual and LayerNorm; on the fused route #2 (or #7 under
``UC2_ATTN_V2``) and #3 run in their partial modes and ``block_epilogue``
follows the sum; in training under "pallas-train" with ``UC2_FFN_TRAIN=1``
#9 and #10 run in theirs (``fused_ffn_block_train_partial``: each shard
masks its own partial, and the residual and LayerNorm follow the sum);
under ``quant="int8"`` the row-parallel products are
``int8_linear_row_parallel`` (maxima over the model group, exact integer
sums). The word table is vocab-parallel (``vocab_parallel_embedding``).

``remat="full"`` or ``"dots"`` recomputes each layer of a training call in
the backward (``torch.utils.checkpoint``, non-reentrant; the reference's
``nn.remat`` around each layer): "full" saves only the layer's inputs,
"dots" also the outputs of the aten products (``mm``, ``addmm``, ``bmm``,
``baddbmm``; ``dots_saveable``), so the rest, the hand kernels included,
runs again. ``DropoutRng``'s generators are not the ones checkpoint
restores, so ``remat_layer`` replays them: the recompute draws the
forward's seeds and masks, and the streams end where a run without remat
leaves them.
"""

from __future__ import annotations

import copy
import functools
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from uc2_torch.config import UC2Config
from uc2_torch.ops.attention import multi_head_attention, resolve_impl
from uc2_torch.ops.dropout import dropout
from uc2_torch.ops.ffn_train import (ffn_train_enabled, fused_ffn_block_train,
                                     fused_ffn_block_train_partial)
from uc2_torch.ops.fused_block import (block_epilogue, fused_attn_block,
                                       fused_attn_block_partial,
                                       fused_attn_block_v2,
                                       fused_attn_block_v2_partial,
                                       fused_block_profitable,
                                       fused_ffn_block,
                                       fused_ffn_block_partial,
                                       fused_ffn_profitable, layer_norm_f32)
from uc2_torch.ops.int8 import int8_linear, int8_linear_row_parallel
from uc2_torch.parallel import tensor as TP

QUANTS = ("none", "int8")
REMATS = ("none", "full", "dots")


def compute_dtype(cfg: UC2Config) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class SmallTableLookup(torch.autograd.Function):
    """``weight[ids]`` for a table of a few rows (the token types, the
    region mask embedding), whose backward is one masked sum a row.

    Every id of a batch hits one of these rows, so a row has tens of
    thousands of copies: the CUDA embedding backward then adds the row's
    partial sums with float atomics (its gradient differed between two
    runs of one step on the H100), and indexing's sorted ``index_put_``
    walks the copies one warp a row (7 ms at 20800 ids). A masked sum is a
    reduction of fixed order: the same bits on every run, and fast."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        grad = grad.reshape(-1, grad.shape[-1])
        ids = ids.reshape(-1, 1)
        return torch.stack([torch.where(ids == r, grad, 0.0).sum(0)
                            for r in range(ctx.rows)]), None


def create_position_ids_from_input_ids(input_ids, padding_idx: int):
    """XLM-R position ids: non-pad tokens numbered from padding_idx + 1."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


def gelu(x):
    """erf-form gelu."""
    return F.gelu(x, approximate="none")


def row_parallel(x, dense: "Dense", quant: str = "none"):
    """The row-parallel product of ``x`` (this process's input columns)
    and ``dense``'s weight shard, summed over the model group in fp32, plus
    the bias; in the compute dtype. ``quant="int8"`` takes the int8
    serving product of the whole rows (``int8_linear_row_parallel``)."""
    if quant == "int8":
        return int8_linear_row_parallel(x, dense.weight, dense.bias,
                                        dense.dtype)
    part = F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype)).float()
    return (TP.reduce_from_model(part) + dense.bias.float()).to(dense.dtype)


class Dense(nn.Linear):
    """Linear layer with fp32 parameters that computes in ``dtype``;
    ``quant="int8"`` takes the int8 serving product."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype

    def forward(self, x, quant: str = "none"):
        if quant == "int8":
            return int8_linear(x, self.weight, self.bias, self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class TextEmbeddings(nn.Module):
    """Word + position (+ caller-supplied token-type) embeddings -> LN."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                H, device=device)
        self.LayerNorm = LayerNorm(H, cfg.layer_norm_eps, compute_dtype(cfg),
                                   device)

    def forward(self, input_ids, type_embeddings, position_ids=None,
                rng=None):
        cfg = self.config
        if position_ids is None:
            if cfg.position_style == "bert":
                position_ids = torch.arange(
                    input_ids.shape[1], device=input_ids.device
                ).expand_as(input_ids)
            else:
                position_ids = create_position_ids_from_input_ids(
                    input_ids, cfg.pad_token_id)
        words = (self.word_embeddings(input_ids) if TP.tp_size() == 1 else
                 TP.vocab_parallel_embedding(input_ids,
                                             self.word_embeddings.weight,
                                             cfg.vocab_size))
        x = words + self.position_embeddings(position_ids) + type_embeddings
        return dropout(self.LayerNorm(x), cfg.hidden_dropout_prob, rng)


class ImageEmbeddings(nn.Module):
    """LN(img_linear(feat)) + LN(pos_linear(bbox7)) + type_emb -> LN.

    MRM-masked regions get row 1 of ``mask_embedding`` added; row 0 is
    zero in every forward, as in the reference."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        eps = cfg.layer_norm_eps
        self.img_linear = Dense(cfg.img_dim, H, dt, device)
        self.img_layer_norm = LayerNorm(H, eps, dt, device)
        self.pos_linear = Dense(7, H, dt, device)
        self.pos_layer_norm = LayerNorm(H, eps, dt, device)
        self.LayerNorm = LayerNorm(H, eps, dt, device)
        self.mask_embedding = nn.Parameter(
            torch.zeros(2, cfg.img_dim, device=device))

    def forward(self, img_feat, img_pos_feat, type_embeddings,
                img_masks=None, rng=None):
        if img_masks is not None:
            mask_emb = torch.cat([torch.zeros_like(self.mask_embedding[:1]),
                                  self.mask_embedding[1:]])
            img_feat = img_feat + SmallTableLookup.apply(
                mask_emb, img_masks.long()).to(img_feat.dtype)
        x = (self.img_layer_norm(self.img_linear(img_feat))
             + self.pos_layer_norm(self.pos_linear(img_pos_feat))
             + type_embeddings)
        return dropout(self.LayerNorm(x), self.config.hidden_dropout_prob, rng)


class SelfAttention(nn.Module):
    """Multi-head self-attention with the fused [H, 3H] QKV projection."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.qkv = Dense(H, 3 * H, compute_dtype(cfg), device)

    def heads(self, x):
        """The projected q, k, v as [B, L, n, d] views into one tensor (n
        the heads this process holds: all, or its shard's)."""
        cfg = self.config
        B, L, _ = x.shape
        d = cfg.head_dim
        n = self.qkv.weight.shape[0] // (3 * d)
        q, k, v = self.qkv(x, cfg.quant).split(n * d, dim=-1)
        return (q.view(B, L, n, d), k.view(B, L, n, d), v.view(B, L, n, d))

    def attend(self, q, k, v, attn_bias, rng=None):
        """Attention over the heads q, k, v hold, [B, L, n d]. ``rng`` is
        None when deterministic. Attention gets it only when there is probs
        dropout or the impl is "pallas-train", as in the reference (which
        then keeps the training kernel at rate 0). A shard's heads draw
        the masks of those heads of the whole layer."""
        cfg = self.config
        rate = cfg.attention_probs_dropout_prob if rng is not None else 0.0
        if not (rate > 0.0 or cfg.use_pallas_attention == "pallas-train"):
            rng = None
        n = q.shape[2]
        heads = (None if n == cfg.num_attention_heads
                 else (TP.tp_rank() * n, cfg.num_attention_heads))
        ctx = multi_head_attention(q, k, v, attn_bias, dropout_rate=rate,
                                   rng=rng, use_pallas=cfg.use_pallas_attention,
                                   heads=heads)
        B, L = q.shape[:2]
        return ctx.reshape(B, L, -1)

    def forward(self, x, attn_bias, rng=None):
        return self.attend(*self.heads(x), attn_bias, rng)


class EncoderLayer(nn.Module):
    """Post-LN transformer block; in-block LayerNorms use
    ``block_layer_norm_eps``. Routing follows the reference: when
    deterministic (``rng`` None), the fused attention block where
    ``fused_block_profitable`` (or "fused-force") says so, else attention
    -> out-projection -> LN; then the fused FFN block where
    ``fused_ffn_profitable`` says so, else the eager chain. In training
    the unfused chains run, with hidden dropout after the out-projection
    and after the FFN, except that under "pallas-train" with
    ``UC2_FFN_TRAIN=1`` the FFN is the training FFN block
    (``ops/ffn_train.py``, kernels #9/#10), as in the reference. On the
    fused route, ``UC2_ATTN_V2`` (read at every forward, as the reference
    reads it at trace time) selects the attention block with the QKV
    projection inside the kernel (``fused_attn_block_v2``, kernel #7).
    Under ``quant="int8"`` nothing is fused, "fused-force" included, and
    the four products take the int8 path."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.config = cfg
        H, Fi, dt = cfg.hidden_size, cfg.intermediate_size, compute_dtype(cfg)
        eps = cfg.block_layer_norm_eps
        self.attention = SelfAttention(cfg, device)
        self.attention_output_dense = Dense(H, H, dt, device)
        self.attention_output_LayerNorm = LayerNorm(H, eps, dt, device)
        self.intermediate_dense = Dense(H, Fi, dt, device)
        self.output_dense = Dense(Fi, H, dt, device)
        self.output_LayerNorm = LayerNorm(H, eps, dt, device)

    def forward(self, x, attn_bias, rng=None):
        if TP.tp_size() > 1:
            return self._forward_tp(x, attn_bias, rng)
        cfg = self.config
        dt = compute_dtype(cfg)
        eps = cfg.block_layer_norm_eps
        rate = cfg.hidden_dropout_prob
        impl = resolve_impl(cfg.use_pallas_attention)
        force = impl == "fused-force"
        fusable = (rng is None and cfg.quant == "none"
                   and (force or impl in ("pallas", "pallas-train")))
        L = x.shape[1]
        if fusable and (force or fused_block_profitable(
                L, cfg.num_attention_heads)):
            od, ln = self.attention_output_dense, self.attention_output_LayerNorm
            if os.environ.get("UC2_ATTN_V2"):
                qkv = self.attention.qkv
                x = fused_attn_block_v2(x, qkv.weight.to(dt), qkv.bias,
                                        attn_bias, od.weight.to(dt), od.bias,
                                        ln.weight, ln.bias,
                                        cfg.num_attention_heads, eps=eps)
            else:
                q, k, v = self.attention.heads(x)
                x = fused_attn_block(q, k, v, attn_bias, x, od.weight.to(dt),
                                     od.bias, ln.weight, ln.bias, eps=eps)
        else:
            attn_out = self.attention_output_dense(
                self.attention(x, attn_bias, rng), cfg.quant)
            x = self.attention_output_LayerNorm(dropout(attn_out, rate, rng)
                                                + x)
        inter, down = self.intermediate_dense, self.output_dense
        ln = self.output_LayerNorm
        if fusable and (force or fused_ffn_profitable(L)):
            return fused_ffn_block(x, inter.weight.to(dt), inter.bias,
                                   down.weight.to(dt), down.bias, ln.weight,
                                   ln.bias, eps=eps)
        if rng is not None and impl == "pallas-train" and ffn_train_enabled():
            seed = rng.kernel_seed() if rate > 0 else 0
            return fused_ffn_block_train(x, inter.weight.to(dt), inter.bias,
                                         down.weight.to(dt), down.bias,
                                         ln.weight, ln.bias, seed, rate, eps)
        h = self.output_dense(gelu(self.intermediate_dense(x, cfg.quant)),
                              cfg.quant)
        return self.output_LayerNorm(dropout(h, rate, rng) + x)

    def _forward_tp(self, x, attn_bias, rng=None):
        """The layer on this process's shards (the module's docstring): the
        routing of ``forward``, with #2 (#7 under ``UC2_ATTN_V2``), #3 and,
        in training, #9/#10 in their partial modes."""
        cfg = self.config
        dt = compute_dtype(cfg)
        eps = cfg.block_layer_norm_eps
        rate = cfg.hidden_dropout_prob
        impl = resolve_impl(cfg.use_pallas_attention)
        force = impl == "fused-force"
        fusable = (rng is None and cfg.quant == "none"
                   and (force or impl in ("pallas", "pallas-train")))
        L = x.shape[1]
        od, ln = self.attention_output_dense, self.attention_output_LayerNorm
        if fusable and (force or fused_block_profitable(
                L, cfg.num_attention_heads)):
            xa = TP.copy_to_model(x)
            if os.environ.get("UC2_ATTN_V2"):
                qkv = self.attention.qkv
                n = qkv.weight.shape[0] // (3 * cfg.head_dim)
                y = fused_attn_block_v2_partial(xa, qkv.weight.to(dt),
                                                qkv.bias, attn_bias,
                                                od.weight.to(dt), n)
            else:
                y = fused_attn_block_partial(*self.attention.heads(xa),
                                             attn_bias, od.weight.to(dt))
            x = block_epilogue(TP.reduce_from_model(y), od.bias, x, ln.weight,
                               ln.bias, eps)
        else:
            q, k, v = self.attention.heads(TP.copy_to_model(x))
            attn_out = row_parallel(self.attention.attend(q, k, v, attn_bias,
                                                          rng), od, cfg.quant)
            x = ln(dropout(attn_out, rate, rng) + x)
        inter, down = self.intermediate_dense, self.output_dense
        ln = self.output_LayerNorm
        xf = TP.copy_to_model(x)
        if fusable and (force or fused_ffn_profitable(L)):
            y = fused_ffn_block_partial(xf, inter.weight.to(dt), inter.bias,
                                        down.weight.to(dt))
            return block_epilogue(TP.reduce_from_model(y), down.bias, x,
                                  ln.weight, ln.bias, eps)
        if rng is not None and impl == "pallas-train" and ffn_train_enabled():
            seed = rng.kernel_seed() if rate > 0 else 0
            y = fused_ffn_block_train_partial(
                xf, inter.weight.to(dt), inter.bias, down.weight.to(dt),
                down.bias, seed, rate, TP.tp_rank() == 0)
            return layer_norm_f32(TP.reduce_from_model(y) + x.float(),
                                  ln.weight, ln.bias, eps).to(x.dtype)
        h = row_parallel(gelu(inter(xf, cfg.quant)), down, cfg.quant)
        return ln(dropout(h, rate, rng) + x)


class Pooler(nn.Module):
    """tanh(dense(first token))."""

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           compute_dtype(cfg), device)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class UC2Model(nn.Module):
    """Joint vision-language encoder.

    Inputs as the reference's UC2Model: input_ids [B, Lt], img_feat
    [B, Nb, img_dim], img_pos_feat [B, Nb, 7], attn_mask [B, Lt + Nb]
    (1 = valid), and optional position_ids, img_masks, txt_type_ids,
    img_type_ids. Returns (sequence_output [B, Lt + Nb, H], pooled [B, H]).
    ``deterministic=False`` trains: dropout on, drawn from ``rng`` (a
    ``DropoutRng``), which is then required; under ``remat`` each layer
    of such a call is recomputed in the backward (``remat_layer``).
    """

    def __init__(self, cfg: UC2Config, device=None):
        super().__init__()
        if cfg.quant not in QUANTS or cfg.remat not in REMATS:
            raise ValueError(f"uc2_torch: quant {cfg.quant!r} (one of "
                             f"{QUANTS}), remat {cfg.remat!r} (one of "
                             f"{REMATS})")
        self.config = cfg
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, device=device)
        self.embeddings = TextEmbeddings(cfg, device)
        self.img_embeddings = ImageEmbeddings(cfg, device)
        self.layer = nn.ModuleList(EncoderLayer(cfg, device)
                                   for _ in range(cfg.num_hidden_layers))
        self.pooler = Pooler(cfg, device)

    def forward(self, input_ids=None, position_ids=None, img_feat=None,
                img_pos_feat=None, attn_mask=None, img_masks=None,
                txt_type_ids=None, img_type_ids=None, deterministic=True,
                rng=None):
        if deterministic:
            rng = None
        elif rng is None:
            raise ValueError("uc2_torch: a training forward "
                             "(deterministic=False) needs a DropoutRng")
        cfg = self.config
        if rng is not None and cfg.quant != "none":
            raise NotImplementedError(
                f"uc2_torch: quant={cfg.quant!r} is a serving path; train "
                f"the model without it")
        dt = compute_dtype(cfg)
        parts = []
        if input_ids is not None:
            if txt_type_ids is None:
                txt_type_ids = torch.zeros_like(input_ids)
            parts.append(self.embeddings(
                input_ids, SmallTableLookup.apply(
                    self.token_type_embeddings.weight, txt_type_ids),
                position_ids, rng))
        if img_feat is not None:
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                          device=img_feat.device)
            parts.append(self.img_embeddings(
                img_feat.to(dt), img_pos_feat.to(dt),
                SmallTableLookup.apply(self.token_type_embeddings.weight,
                                       img_type_ids), img_masks, rng))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        attn_bias = ((1.0 - attn_mask.float()) * -10000.0)[:, None, None, :]
        remat = (rng is not None and cfg.remat != "none"
                 and torch.is_grad_enabled())
        for layer in self.layer:
            x = (remat_layer(layer, x, attn_bias, rng, cfg.remat) if remat
                 else layer(x, attn_bias, rng))
        return x, self.pooler(x)


DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
        torch.ops.aten.baddbmm)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_saveable``: keep the products' outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer, x, attn_bias, rng, remat: str):
    """``layer(x, attn_bias, rng)`` under activation checkpointing
    (``remat`` "full" or "dots"). The recompute in the backward starts
    ``rng``'s two generators where the forward started them and puts back
    afterwards the states it found (also when checkpoint stops the
    recompute early), so it draws the forward's kernel seeds and masks and
    the step's streams end as without remat."""
    start = rng.get_state()
    ran = []

    def run(x, attn_bias):
        if not ran:
            ran.append(True)
            return layer(x, attn_bias, rng)
        after = rng.get_state()
        rng.set_state(start)
        try:
            return layer(x, attn_bias, rng)
        finally:
            rng.set_state(after)

    context = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
        if remat == "dots" else {})
    return checkpoint(run, x, attn_bias, use_reentrant=False, **context)


def share_parameters(module: nn.Module, config) -> nn.Module:
    """A copy of ``module``'s tree over the same parameters and buffers
    (the same objects) in which every module that keeps a ``config``
    keeps ``config`` instead."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: None if m is None else share_parameters(m, config)
                    for k, m in module._modules.items()}
    if "config" in module.__dict__:
        new.config = config
    return new


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator, std: float):
    """Initialise ``model`` as the reference does: normal(0, std) Linear
    weights and embedding tables, zero biases, unit LayerNorm scales, and
    normal(0, std) MRM mask embeddings, drawn from ``gen`` in module
    order."""
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, ImageEmbeddings):
            mod.mask_embedding.normal_(0.0, std, generator=gen)
