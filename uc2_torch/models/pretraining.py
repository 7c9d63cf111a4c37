"""UC2 pretraining model: encoder + task heads (port of
uc2_tpu/models/pretraining.py: the mlm family, vmlm/mmxlm and
itm without optimal transport).

The module tree matches the reference's parameter tree ``{"roberta",
"cls", "feat_regress", "region_classifier", "itm_output",
"nce_output"}``, so ``models/convert.py`` loads a full reference tree.
The LM decoder is tied to ``roberta.embeddings.word_embeddings.weight``
by passing the table in, as the reference does.

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
    """

    def __init__(self, config: UC2Config, lm_ce_chunks: int = 0,
                 device="cuda", seed: int = 0,
                 params: Optional[Dict] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.lm_ce_chunks = lm_ce_chunks
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
        the logits [B, M, V] instead."""
        h = gather_slots(seq, batch["masked_pos"])
        emb = self.roberta.embeddings.word_embeddings.weight
        if not compute_loss:
            return self.cls(h, emb)
        w = batch["masked_weight"]
        if self.lm_ce_chunks:
            B, M, _ = h.shape
            x = self.cls(h, emb, transform_only=True)
            loss = H.chunked_softmax_cross_entropy(
                x.reshape(B * M, -1), emb, self.cls.bias,
                batch["txt_labels"].reshape(B * M), w.reshape(B * M),
                n_chunks=self.lm_ce_chunks)
            return loss.sum(), w.sum()
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

    def forward_itm(self, batch, deterministic=True, rng=None,
                    compute_ot=False, compute_loss=True):
        """Image-text matching: the ITM head on the pooled output, CE
        against ``targets``. Returns (loss_sum, B) with B the padded batch
        size, as the reference reduces, or with ``compute_loss=False`` the
        scores [B, 2] and the OT distances (None: the optimal-transport
        term, IPOT, is not ported yet and raises)."""
        if compute_ot:
            raise NotImplementedError("uc2_torch: itm with optimal transport "
                                      "(itm-ot) is not ported yet")
        _, pooled = self._encode(batch, deterministic, rng)
        scores = self.itm_output(pooled)
        if not compute_loss:
            return scores, None
        loss = H.cross_entropy_with_logits(scores, batch["targets"])
        return loss.sum(), scores.shape[0]

    def _not_ported(self, *args, **kwargs):
        raise NotImplementedError("uc2_torch: only the mlm, tlm, tlm-ni, "
                                  "vmlm/mmxlm and itm objectives are ported "
                                  "so far")

    forward_mmxlm_soft = forward_mrfr = forward_mrm_nce = forward_mrc = \
        _not_ported
