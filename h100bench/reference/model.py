"""Plain fp32 reference of the single-stream encoder of UC2 (Zhou et al.,
CVPR 2021) and UNITER (Chen et al., ECCV 2020), with the heads the cells
use and a plain AdamW.

The weights are a dict of fp32 tensors under the checkpoint's names
(``roberta.layer.<i>.attention.qkv.weight``, ...; linear weights are
[out, in], the QKV projection one [3H, H] matrix with the q, k and v rows
in that order). The encoder follows the published description:

* text: word + position + token-type (0) embeddings, LayerNorm (the
  config's ``layer_norm_eps``); positions from the pad mask (XLM-R) or
  0, 1, ... (BERT);
* regions: LN(W_img feat) + LN(W_pos box7) + token-type (1, or the
  batch's ``img_type_ids``), LayerNorm;
* twelve post-LN layers (in-block eps 1e-12): softmax(QK^T / sqrt(d) +
  bias) V with bias -10000 at padded keys, the output projection, the
  residual and LayerNorm; gelu (erf) FFN, the residual and LayerNorm;
* the pooler tanh(W x_0 + b).

Training draws dropout as a run of the program draws it from the same
seeds (``DropoutStreams``): the hidden dropout masks are uniforms of a
torch generator on the device in the program's order (text embedding,
region embedding, then per layer after the output projection and after
the FFN), the attention masks Philox bits keyed on a seed per layer drawn
from a CPU generator (``reference/philox.py``).

``prec="fp8"`` is the lower-precision control, the model at float8 e4m3
where the configuration states bf16: every product's operands and every
activation where the port keeps one in its compute dtype (the embeddings'
and each LayerNorm's output, the projections, the attention
probabilities and context, the FFN's hidden layer, the pooled output)
rounded to e4m3 with a per-tensor scale, and in the backward each of
their gradients to e5m2 (the hybrid recipe of fp8 training), sums and
statistics in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from h100bench.reference.philox import keep_mask

BLOCK_EPS = 1e-12
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def set_fp32_products():
    """fp32 products: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _quantize(x, prec, grad=False):
    """x rounded to fp8 with a per-tensor scale: e4m3 for a value, e5m2 for
    a gradient (the usual fp8 training recipe)."""
    if prec == "fp8":
        dt, top = ((torch.float8_e5m2, E5M2_MAX) if grad
                   else (torch.float8_e4m3fn, E4M3_MAX))
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(dt).float() * scale
    raise ValueError(f"unknown precision {prec!r}")


class _Round(torch.autograd.Function):
    """x rounded to ``prec``, and its gradient rounded so in the backward."""

    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return _quantize(x, prec)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, ctx.prec, grad=True), None


def _round(x, prec):
    return x if prec is None else _Round.apply(x, prec)


def matmul(a, b, prec=None):
    return _round(_round(a, prec) @ _round(b, prec), prec)


def linear(x, P, name, prec=None):
    y = _round(x, prec) @ _round(P[name + ".weight"], prec).t()
    b = P.get(name + ".bias")
    return _round(y if b is None else y + b, prec)


def layer_norm(x, P, name, eps, prec=None):
    return _round(F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                               P[name + ".bias"], eps), prec)


class DropoutStreams:
    """The two random streams of one training step, from its seed: the
    device generator draws the hidden masks, the CPU generator the seed of
    each layer's attention mask."""

    def __init__(self, seed: int, hidden_rate: float, attn_rate: float,
                 device):
        self.rate, self.attn_rate = hidden_rate, attn_rate
        self.dev = torch.Generator(device=device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed + 0x9E3779B9)

    def hidden(self, x):
        keep = torch.rand(x.shape, generator=self.dev,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


def encoder(P: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
            drop: Optional[DropoutStreams] = None, prec=None):
    """(sequence output [B, L, H], pooled [B, H]) of a batch: ``input_ids``
    [B, Lt], ``attn_mask`` [B, Lt + Nb] (1 = valid), ``img_feat`` [B, Nb,
    img_dim], ``img_pos_feat`` [B, Nb, 7], optional ``img_type_ids``."""
    ids = batch["input_ids"].long()
    mask = batch["attn_mask"].float()
    pad = cfg["pad_token_id"]
    if cfg.get("position_style") == "bert":
        pos = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
    else:
        valid = (ids != pad).long()
        pos = torch.cumsum(valid, dim=1) * valid + pad
    tt = P["roberta.token_type_embeddings.weight"]
    eps = cfg["layer_norm_eps"]
    txt = (P["roberta.embeddings.word_embeddings.weight"][ids]
           + P["roberta.embeddings.position_embeddings.weight"][pos] + tt[0])
    txt = layer_norm(txt, P, "roberta.embeddings.LayerNorm", eps, prec)
    if drop is not None:
        txt = drop.hidden(txt)
    feat = batch["img_feat"].float()
    if "img_masks" in batch:        # masked regions get mask_embedding[1]
        feat = feat + batch["img_masks"][..., None].float() * P[
            "roberta.img_embeddings.mask_embedding"][1]
    types = batch.get("img_type_ids")
    ttype = tt[1] if types is None else tt[types.long()]
    img = (layer_norm(linear(feat, P, "roberta.img_embeddings.img_linear",
                             prec),
                      P, "roberta.img_embeddings.img_layer_norm", eps, prec)
           + layer_norm(linear(batch["img_pos_feat"].float(), P,
                               "roberta.img_embeddings.pos_linear", prec),
                        P, "roberta.img_embeddings.pos_layer_norm", eps, prec)
           + ttype)
    img = layer_norm(img, P, "roberta.img_embeddings.LayerNorm", eps, prec)
    if drop is not None:
        img = drop.hidden(img)
    x = torch.cat([txt, img], dim=1)
    B, L, H = x.shape
    n = cfg["num_attention_heads"]
    d = H // n
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"roberta.layer.{i}."
        q, k, v = (t.reshape(B, L, n, d).transpose(1, 2) for t in
                   linear(x, P, pre + "attention.qkv", prec).split(H, -1))
        probs = _round(torch.softmax(matmul(q, k.transpose(-1, -2), prec)
                                     / math.sqrt(d) + bias, dim=-1), prec)
        if drop is not None:
            keep = keep_mask(drop.attention_seed(), drop.attn_rate, B, n, L,
                             x.device)
            probs = torch.where(keep, probs / (1.0 - drop.attn_rate), 0.0)
        ctx = matmul(probs, v, prec).transpose(1, 2).reshape(B, L, H)
        y = linear(ctx, P, pre + "attention_output_dense", prec)
        if drop is not None:
            y = drop.hidden(y)
        x = layer_norm(y + x, P, pre + "attention_output_LayerNorm",
                       BLOCK_EPS, prec)
        y = linear(_round(F.gelu(linear(x, P, pre + "intermediate_dense",
                                        prec)), prec),
                   P, pre + "output_dense", prec)
        if drop is not None:
            y = drop.hidden(y)
        x = layer_norm(y + x, P, pre + "output_LayerNorm", BLOCK_EPS, prec)
    pooled = _round(torch.tanh(linear(x[:, 0], P, "roberta.pooler.dense",
                                      prec)), prec)
    return x, pooled


def rank_scores(P, cfg, batch, prec=None):
    """[B] retrieval scores: the rank head over the pooled output."""
    _, pooled = encoder(P, cfg, batch, None, prec)
    return linear(pooled, P, "rank_output.out", prec)[:, 0]


def nlvr2_triplet_loss(P, cfg, batch, drop=None, prec=None):
    """The mean cross entropy of NLVR2's triplet head, Linear(H -> 2) over
    the pooled output, against ``targets``."""
    _, pooled = encoder(P, cfg, batch, drop, prec)
    logits = linear(pooled, P, "nlvr2_output", prec)
    return F.cross_entropy(logits, batch["targets"].long())


def pretrain_loss(P, cfg, batch, task, drop=None, prec=None):
    """The loss of one UC2 pretraining batch: itm, the CE of the ITM head
    Linear(H -> 2) over the pooled output against ``targets``, a mean over
    the rows; mlm, tlm and vmlm, the CE of the LM head (dense, gelu,
    LayerNorm, the word embeddings tied as decoder, plus a bias) at the
    slots ``masked_pos`` against ``txt_labels``, weighted by
    ``masked_weight`` and divided by its sum."""
    seq, pooled = encoder(P, cfg, batch, drop, prec)
    if task == "itm":
        return F.cross_entropy(linear(pooled, P, "itm_output.out", prec),
                               batch["targets"].long())
    idx = batch["masked_pos"].long()[:, :, None].expand(-1, -1, seq.shape[-1])
    h = torch.gather(seq, 1, idx)
    h = layer_norm(F.gelu(linear(h, P, "cls.dense", prec)), P,
                   "cls.layer_norm", cfg["layer_norm_eps"], prec)
    logits = matmul(h, P["roberta.embeddings.word_embeddings.weight"].t(),
                    prec) + P["cls.bias"]
    w = batch["masked_weight"]
    ce = F.cross_entropy(logits.flatten(0, 1), batch["txt_labels"].long()
                         .flatten(), reduction="none").view_as(w)
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def no_decay(name: str) -> bool:
    """Biases and LayerNorm parameters take no weight decay."""
    return (name.rsplit(".", 1)[-1] == "bias" or "LayerNorm" in name
            or "layer_norm" in name)


def warmup_linear(lr, warmup, total):
    """Linear warm-up over ``warmup`` steps, then linear decay to 0 at
    ``total``, floored at 1e-8."""
    def f(step):
        warm = step / max(warmup, 1)
        decay = max(0.0, (total - step) / max(total - warmup, 1))
        return max(lr * (warm if step < warmup else decay), 1e-8)
    return f


def train(P0: Dict[str, torch.Tensor], loss_fn, batches, drops, opt: Dict,
          prec=None) -> Dict:
    """Follow ``len(batches)`` AdamW steps from the weights ``P0`` (left
    unchanged): the loss of each step (``loss_fn(P, batch, drop)``), the
    norm of every leaf's first gradient as the optimizer gets it, before
    its clipping (``grad1``; ``norm1`` their global norm), and of every
    leaf's change over the steps (``change``). A ``loss_fn`` may run the
    backward itself (of micro-batches one by one) and return the loss
    detached. ``opt``: lr, warmup, total, start (the schedule's step of the
    first update), betas, eps, weight_decay, grad_norm. Clipping is g * max / norm where norm >= max;
    decay is decoupled, p * (1 - lr wd) before the Adam update."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P0.items()}
    s = {k: torch.zeros_like(v) for k, v in P0.items()}
    b1, b2 = opt["betas"]
    sched = warmup_linear(opt["lr"], opt["warmup"], opt["total"])
    out = {"losses": []}
    for t, (batch, drop) in enumerate(zip(batches, drops)):
        loss = loss_fn(P, batch, drop)
        if loss.requires_grad:
            loss.backward()
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in P.items()}
            norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
            if t == 0:
                out["grad1"] = {k: float(v.norm()) for k, v in g.items()}
                out["norm1"] = float(norm)
            if opt["grad_norm"] > 0 and norm >= opt["grad_norm"]:
                g = {k: v * (opt["grad_norm"] / norm).float()
                     for k, v in g.items()}
            lr = sched(opt["start"] + t)
            bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for k, p in P.items():
                if not no_decay(k):
                    p.mul_(1.0 - lr * opt["weight_decay"])
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (s[k].sqrt() / math.sqrt(bc2)).add_(opt["eps"])
                p.addcdiv_(m[k], denom, value=-lr / bc1)
                p.grad = None
    out["change"] = {k: float((P[k].detach() - P0[k]).norm()) for k in P}
    return out
