"""Retrieval scoring: ``uc2_torch.evalu.retrieval.score_matrix`` on a
``UC2ForImageTextRetrieval``, as ``full_retrieval_eval`` and
``mine_hard_negatives`` run it.

Set-up draws the weights and the gallery (``frozen/generators.py``), puts
them into the port's in-memory databases and scores the first captions
once, which builds the kernels and visits every batch shape. The window
scores slices of ``captions_per_call`` captions against the whole gallery,
walking the captions in order, until ``--seconds`` have passed; each call
loads the gallery again, as each evaluation does. The check draws
``check_pairs`` entries of the window's score matrices from the seed, with
the longest pair among them, and holds them to the plain fp32 reference.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from h100bench.drivers.common import ModelDriver
from h100bench.frozen import flops as FL
from h100bench.frozen.generators import gallery, sub_seed
from h100bench.reference import model as R


class Driver(ModelDriver):

    def setup(self):
        from uc2_torch.data.memdb import MemImgDb, MemTxtDb
        from uc2_torch.models.finetune import UC2ForImageTextRetrieval
        t, c = self.traffic, self.cfg
        self.mark("imports")
        self.model = self.load(UC2ForImageTextRetrieval(self.port_config(),
                                                       device=self.device))
        self.mark("model and weights")
        tok = dict(t, vocab_size=c["vocab_size"], img_dim=c["img_dim"],
                   first_word_id=c["first_word_id"])
        (self.feats, self.bb7, self.nbb, caps,
         self.cap2img) = gallery(self.seed, tok, t["num_bb"], self.device)
        self.img_ids = [f"img_{i:06d}" for i in range(t["n_imgs"])]
        self.txt_ids = [f"txt_{i:07d}" for i in range(len(caps))]
        self.caps = caps
        self.txt_db = MemTxtDb(
            {tid: {"img_fname": self.img_ids[self.cap2img[i]],
                   "input_ids": caps[i]}
             for i, tid in enumerate(self.txt_ids)},
            cls_=c["cls_token_id"], sep=c["sep_token_id"],
            vocab=c["vocab_size"])
        k = np.minimum(self.nbb, t["num_bb"])
        self.img_db = MemImgDb({im: (self.feats[j, :k[j]], self.bb7[j, :k[j]])
                                for j, im in enumerate(self.img_ids)})
        # joint lengths of a caption (with CLS and SEP, cut to txt_len) and
        # an image's scored regions
        self.txt_tokens = np.minimum([len(x) + 2 for x in caps], t["txt_len"])
        self.regions = k
        self.next = 0
        self.calls = []
        self.mark("gallery")
        self.call(t["warmup_captions"])
        self.sync()
        self.calls.clear()
        self.next = 0
        self.mark("warm-up call")

    def call(self, n: int) -> np.ndarray:
        """Score the next ``n`` captions against the gallery."""
        from uc2_torch.evalu.retrieval import score_matrix
        t = self.traffic
        rows = [(self.next + i) % len(self.txt_ids) for i in range(n)]
        self.next = (self.next + n) % len(self.txt_ids)
        m = score_matrix(self.model, self.txt_db, self.img_db,
                         [self.txt_ids[i] for i in rows], self.img_ids,
                         t["txt_len"], t["num_bb"],
                         batch_size=t["batch_size"], device=self.device)
        self.calls.append((np.asarray(rows), m))
        return m

    def pair_flops(self, rows) -> float:
        """The encoder forward and image embedding FLOPs of captions
        ``rows`` against every image, each pair at its own length."""
        c = self.cfg
        L = self.txt_tokens[rows][:, None] + self.regions[None, :]
        f = FL.encoder_fwd_flops_per_pair(L, c["num_hidden_layers"],
                                          c["hidden_size"],
                                          c["intermediate_size"])
        f = f + FL.img_embed_flops(self.regions, c["hidden_size"],
                                   c["img_dim"])[None, :]
        return float(f.sum())

    def window(self, seconds: float) -> Dict:
        n = self.traffic["captions_per_call"]
        self.sync()
        t0 = time.perf_counter()
        ends = []
        while True:
            self.call(n)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        dt = time.perf_counter() - t0
        print("h100bench: window calls ended at " + ", ".join(
            f"{e:.3f}" for e in ends) + " s", file=sys.stderr)
        pairs = sum(m.size for _, m in self.calls)
        bad = sum(int((~np.isfinite(m)).sum()) for _, m in self.calls)
        flops = sum(self.pair_flops(r) for r, _ in self.calls)
        return {"metrics": {"score_pairs_per_s": pairs / dt},
                "attempted": pairs, "failed": bad, "seconds": dt,
                "flops": flops, "units": len(self.calls)}

    def traced_slice(self):
        """One more call of the window's size; returns (scored batches,
        their (B, L) shapes)."""
        from uc2_torch.evalu.retrieval import bucket_edges
        t = self.traffic
        self.call(t["captions_per_call"])
        rows, _ = self.calls.pop()
        edges = bucket_edges(t["txt_len"], t["num_bb"])
        which = np.searchsorted(np.asarray(edges), self.regions)
        shapes = []
        for bi, nb in enumerate(edges):
            tiles = -(-int((which == bi).sum()) // t["batch_size"])
            shapes += [(t["batch_size"], t["txt_len"] + nb)] * (
                tiles * len(rows))
        return len(shapes), shapes

    def free(self):
        self.model = None
        super().free()

    def sample(self):
        """(call, row, column) of the checked entries: ``check_pairs`` drawn
        from the seed over every entry of the window, and the pair of the
        longest caption and the image with the most regions."""
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        sizes = np.asarray([m.size for _, m in self.calls])
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        n_img = len(self.img_ids)
        out = set()
        for f in rng.choice(sizes.sum(), min(self.traffic["check_pairs"],
                                             sizes.sum()), replace=False):
            ci = int(np.searchsorted(starts, f, "right") - 1)
            out.add((ci, *divmod(int(f - starts[ci]), n_img)))
        ci = max(range(len(self.calls)),
                 key=lambda i: self.txt_tokens[self.calls[i][0]].max())
        out.add((ci, int(np.argmax(self.txt_tokens[self.calls[ci][0]])),
                 int(np.argmax(self.regions))))
        return sorted(out)

    def reference_scores(self, entries, prec=None) -> np.ndarray:
        """The reference's scores of (caption, image) pairs, each pair at
        its own length ([text | regions], padded to the longest of a block
        of ``ref_block`` pairs and masked)."""
        c, t = self.cfg, self.traffic
        P = self.weights()
        caps = [self.caps[i] for i, _ in entries]
        order = np.argsort([len(x) + self.regions[j] for x, (_, j) in
                            zip(caps, entries)])
        out = np.zeros(len(entries), np.float64)
        B = t["ref_block"]
        with torch.no_grad():
            for s in range(0, len(order), B):
                idx = order[s:s + B]
                toks = [([c["cls_token_id"]] + list(caps[i])
                         + [c["sep_token_id"]])[:t["txt_len"]] for i in idx]
                imgs = [entries[i][1] for i in idx]
                lt = max(len(x) for x in toks)
                nr = int(max(self.regions[j] for j in imgs))
                ids = np.full((len(idx), lt), c["pad_token_id"], np.int64)
                mask = np.zeros((len(idx), lt + nr), np.int64)
                feat = np.zeros((len(idx), nr, c["img_dim"]), np.float32)
                bb = np.zeros((len(idx), nr, 7), np.float32)
                for b, (x, j) in enumerate(zip(toks, imgs)):
                    k = int(self.regions[j])
                    ids[b, :len(x)] = x
                    mask[b, :len(x)] = 1
                    mask[b, lt:lt + k] = 1
                    feat[b, :k] = self.feats[j, :k]
                    bb[b, :k] = self.bb7[j, :k]
                batch = {k_: torch.from_numpy(v).to(self.device) for k_, v in
                         (("input_ids", ids), ("attn_mask", mask),
                          ("img_feat", feat), ("img_pos_feat", bb))}
                out[idx] = R.rank_scores(P, c, batch, prec).double().cpu(
                ).numpy()
        return out

    def gap(self, got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
        """``score_gap``, the widest gap between a checked score and the
        reference's."""
        return {"score_gap": float(np.abs(got - want).max())}

    def checked(self) -> np.ndarray:
        """The checked entries' scores in the window's matrices."""
        return np.asarray([self.calls[ci][1][r, col] for ci, r, col in
                           self.sample()], np.float64)

    def reference_of_sample(self, prec=None) -> np.ndarray:
        return self.reference_scores(
            [(int(self.calls[ci][0][r]), col) for ci, r, col in
             self.sample()], prec)

    def check(self) -> Dict[str, float]:
        self.want = self.reference_of_sample()
        return self.gap(self.checked(), self.want)

    def control(self) -> Dict[str, float]:
        """The check's numbers of the reference computed in fp8 (after
        ``check``)."""
        return self.gap(self.reference_of_sample("fp8"), self.want)
