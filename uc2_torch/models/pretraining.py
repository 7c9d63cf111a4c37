"""UC2 pretraining model: encoder + task heads (port of
uc2_tpu/models/pretraining.py): mlm, tlm, tlm-ni, vmlm/mmxlm hard and
soft, mrfr, mrm-nce, mrc/mrc-kl, and itm with and without optimal
transport.

The module tree matches the reference's parameter tree ``{"roberta",
"cls", "feat_regress", "region_classifier", "itm_output",
"nce_output"}``, so ``models/convert.py`` loads a full reference tree.
The LM decoder is tied to ``roberta.embeddings.word_embeddings.weight``
and the region regression to ``roberta.img_embeddings.img_linear.weight``
by passing them in, as the reference does.

Prediction slots are static: every batch carries ``masked_pos [B, M]``
(joint-sequence indices) and ``masked_weight [B, M]`` (1 for live slots),
built by ``data/collate.py``; the heads run on the gathered [B, M, H]
block and the loss is a weighted sum.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config
from uc2_torch.models import heads as H
from uc2_torch.models.encoder import UC2Model, init_weights
from uc2_torch.models.ot import optimal_transport_dist
from uc2_torch.parallel import tensor as TP
from uc2_torch.utils.profiling import span


def gather_slots(seq, pos):
    """seq [B, L, Hd], pos [B, M] -> [B, M, Hd]."""
    idx = pos.long()[:, :, None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx)


class UC2ForPretraining(nn.Module):
    """Encoder and pretraining heads.

    The parameters live on ``device`` (CUDA by default; asking for CUDA
    without a GPU raises). Without ``params`` they are drawn from ``seed``
    as the reference initialises them; with ``params``, a reference
    parameter tree (``uc2_tpu``'s ``UC2ForPretraining.init_params`` output
    or a converted checkpoint), they are loaded from it.
    ``lm_ce_chunks > 0`` streams the LM decoder in that many vocabulary
    chunks in the mlm loss (``heads.chunked_softmax_cross_entropy``).
    ``nce_temp`` is mrm-nce's softmax temperature; ``ot_pos_only`` is the
    itm-ot reduction's switch, kept here as the reference keeps it (the
    loss reads it from ``make_loss_fn``).
    """

    def __init__(self, config: UC2Config, lm_ce_chunks: int = 0,
                 device="cuda", seed: int = 0,
                 params: Optional[Dict] = None, nce_temp: float = 1.0,
                 ot_pos_only: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.lm_ce_chunks = lm_ce_chunks
        self.nce_temp = nce_temp
        self.ot_pos_only = ot_pos_only
        self.roberta = UC2Model(config, dev)
        self.cls = H.RobertaLMHead(config, dev)
        self.feat_regress = H.RegionFeatureRegression(config, dev)
        self.region_classifier = H.RegionClassification(config, dev)
        self.itm_output = H.ItmHead(config, dev)
        self.nce_output = H.NceHead(config, dev)
        if params is None:
            init_weights(self, torch.Generator(device=dev).manual_seed(seed),
                         config.initializer_range)
        else:
            from uc2_torch.models.convert import load_params
            load_params(self, params)

    def _encode(self, batch, deterministic, rng, with_image=True,
                img_masks=None):
        return self.roberta(
            input_ids=batch.get("input_ids"),
            position_ids=batch.get("position_ids"),
            img_feat=batch.get("img_feat") if with_image else None,
            img_pos_feat=batch.get("img_pos_feat") if with_image else None,
            attn_mask=batch["attn_mask"],
            img_masks=img_masks,
            img_type_ids=batch.get("img_type_ids"),
            deterministic=deterministic, rng=rng)

    def _lm_loss(self, seq, batch, compute_loss=True):
        """The tied LM head at the prediction slots and its CE weighted by
        ``masked_weight``: (loss_sum, n_slots); with ``compute_loss=False``
        the logits [B, M, V] instead. Under tensor parallelism the head
        gives the vocabulary shard's logits: the CE is the vocab-parallel
        one and the returned logits are gathered whole. Under a profiler
        it is the span ``train.lm_head``, marked on the card's stream."""
        with span("train.lm_head", stream=True):
            h = gather_slots(seq, batch["masked_pos"])
            emb = self.roberta.embeddings.word_embeddings.weight
            if not compute_loss:
                return TP.gather_from_model(self.cls(h, emb))
            w = batch["masked_weight"]
            if self.lm_ce_chunks:
                B, M, _ = h.shape
                x = self.cls(h, emb, transform_only=True)
                loss = H.chunked_softmax_cross_entropy(
                    x.reshape(B * M, -1), emb, self.cls.bias,
                    batch["txt_labels"].reshape(B * M), w.reshape(B * M),
                    n_chunks=self.lm_ce_chunks,
                    vocab_size=self.config.vocab_size)
                return loss.sum(), w.sum()
            if TP.tp_size() > 1:
                loss = TP.vocab_parallel_cross_entropy(
                    self.cls(h, emb), batch["txt_labels"],
                    self.config.vocab_size, w)
            else:
                loss = H.cross_entropy_with_logits(self.cls(h, emb),
                                                   batch["txt_labels"], w)
            return loss.sum(), w.sum()

    def forward_mlm(self, batch, deterministic=True, rng=None,
                    with_image=True, compute_loss=True):
        """MLM / TLM (with the image unless ``with_image=False``, the
        tlm-ni task): predict the masked text tokens. Returns (loss_sum,
        n_slots) for the caller to reduce, or with ``compute_loss=False``
        the logits at the slots [B, M, V]."""
        seq, _ = self._encode(batch, deterministic, rng, with_image)
        return self._lm_loss(seq, batch, compute_loss)

    def forward_mmxlm(self, batch, deterministic=True, rng=None,
                      compute_loss=True):
        """Masked-region-to-token with hard targets (vmlm; mmxlm masks text
        too, folded into the slots by the collate): the masked regions get
        ``mask_embedding``, and the LM head predicts label-word tokens at
        the slots. Returns (loss_sum, n_slots), or the logits with
        ``compute_loss=False``."""
        seq, _ = self._encode(batch, deterministic, rng,
                              img_masks=batch["img_masks"])
        return self._lm_loss(seq, batch, compute_loss)

    def forward_mmxlm_soft(self, batch, valid_ids, deterministic=True,
                           rng=None, compute_loss=True):
        """Soft masked-region-to-token: KL between the slots' target
        distributions (``label_targets`` [B, M, n_valid]) and the LM logits
        restricted to ``valid_ids``. Returns (elementwise sum, slots x
        n_valid), the reference's flat mean, or the logits [B, M, n_valid]
        with ``compute_loss=False``."""
        seq, _ = self._encode(batch, deterministic, rng,
                              img_masks=batch["img_masks"])
        h = gather_slots(seq, batch["masked_pos"])
        logits = self.cls(h, self.roberta.embeddings.word_embeddings.weight,
                          valid_ids)
        if not compute_loss:
            return logits
        w = batch["masked_weight"]
        elem = H.kl_div_with_logits(logits, batch["label_targets"],
                                    elementwise=True) * w[:, :, None]
        return elem.sum(), w.sum() * logits.shape[-1]

    def forward_mrfr(self, batch, deterministic=True, rng=None,
                     compute_loss=True):
        """Masked-region feature regression: the squared error against
        ``feat_targets`` (fp32; fp16 on disk) at the slots. Returns (sum,
        slots x img_dim), the reference's flat mean, or the predictions
        [B, M, img_dim] (fp32) with ``compute_loss=False``."""
        seq, _ = self._encode(batch, deterministic, rng,
                              img_masks=batch["img_masks"])
        h = gather_slots(seq, batch["masked_pos"])
        pred = self.feat_regress(
            h, self.roberta.img_embeddings.img_linear.weight)
        if not compute_loss:
            return pred
        w = batch["masked_weight"]
        err = (pred.float() - batch["feat_targets"].float()) ** 2
        err = err * w[:, :, None]
        return err.sum(), w.sum() * pred.shape[-1]

    def forward_mrm_nce(self, batch, deterministic=True, rng=None,
                        compute_loss=True, with_stats=False):
        """Masked-region contrastive objective: the slots' projections
        against [own targets | the other slots' targets | ``neg_feats``]
        by dot product over ``nce_temp``; padded slots' target columns are
        masked with -1e4, and each slot's own column stays its own score.
        Returns (loss_sum, n_slots, n_correct), with ``with_stats`` also the
        sums of the slots' L2 distance and cosine similarity to their
        targets; the logits [BM, BM + N] with ``compute_loss=False``."""
        seq, _ = self._encode(batch, deterministic, rng,
                              img_masks=batch["img_masks"])
        h = gather_slots(seq, batch["masked_pos"])
        pred = self.nce_output(h)
        B, M, D = pred.shape
        pred = pred.reshape(B * M, D).float()
        w = batch["masked_weight"].reshape(B * M)
        targets = batch["feat_targets"].reshape(B * M, D).float()
        negs = batch["neg_feats"].float()
        cands = torch.cat([targets, negs], dim=0)
        logits = pred @ cands.t() / self.nce_temp
        col_mask = torch.cat([(1.0 - w) * -1e4,
                              w.new_zeros(negs.shape[0])])
        logits = logits + col_mask[None, :]
        diag = (pred * targets).sum(-1) / self.nce_temp
        logits = torch.diagonal_scatter(logits, diag)
        if not compute_loss:
            return logits
        labels = torch.arange(B * M, device=logits.device)
        loss = H.cross_entropy_with_logits(logits, labels, w)
        correct = ((logits.argmax(-1) == labels) * w).sum()
        if with_stats:
            l2 = torch.sqrt(((pred - targets) ** 2).sum(-1) + 1e-12)
            cos = (pred * targets).sum(-1) / (
                torch.linalg.vector_norm(pred, dim=-1)
                * torch.linalg.vector_norm(targets, dim=-1) + 1e-12)
            return (loss.sum(), w.sum(), correct, (l2 * w).sum(),
                    (cos * w).sum())
        return loss.sum(), w.sum(), correct

    def forward_mrc(self, batch, kl: bool, deterministic=True, rng=None,
                    compute_loss=True):
        """Masked-region classification over the detector classes: with
        ``kl`` (mrc-kl) the KL against ``label_targets`` as a flat mean
        (sum, slots x classes), else the CE against the argmax of the
        non-background classes (sum, slots); the logits with
        ``compute_loss=False``."""
        seq, _ = self._encode(batch, deterministic, rng,
                              img_masks=batch["img_masks"])
        h = gather_slots(seq, batch["masked_pos"])
        logits = self.region_classifier(h)
        if not compute_loss:
            return logits
        w = batch["masked_weight"]
        if kl:
            elem = H.kl_div_with_logits(logits, batch["label_targets"],
                                        elementwise=True) * w[:, :, None]
            return elem.sum(), w.sum() * logits.shape[-1]
        labels = batch["label_targets"][..., 1:].argmax(-1) + 1
        return H.cross_entropy_with_logits(logits, labels, w).sum(), w.sum()

    def forward_itm(self, batch, deterministic=True, rng=None,
                    compute_ot=False, compute_loss=True):
        """Image-text matching: the ITM head on the pooled output, CE
        against ``targets``, and with ``compute_ot`` the OT distance [B]
        between the text block ``seq[:, :Lt]`` and the image block
        ``seq[:, Lt:]`` (else None). Returns (loss_sum, B, ot) with B the
        padded batch size, as the reference reduces, or with
        ``compute_loss=False`` (scores [B, 2], ot)."""
        seq, pooled = self._encode(batch, deterministic, rng)
        scores = self.itm_output(pooled)
        ot = None
        if compute_ot:
            tl = batch["input_ids"].shape[1]
            pad = batch["attn_mask"] == 0
            ot = optimal_transport_dist(seq[:, :tl], seq[:, tl:],
                                        pad[:, :tl], pad[:, tl:])
        if not compute_loss:
            return scores, ot
        loss = H.cross_entropy_with_logits(scores, batch["targets"])
        return loss.sum(), scores.shape[0], ot
