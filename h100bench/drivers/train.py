"""Training: ``uc2_torch.training.step.train_step`` with the port's AdamW,
one step a batch, as the drivers' loops run it.

The traffic's ``task`` names the model and the batches: "nlvr2-triplet"
is ``UC2ForNlvr2(fmt="triplet")`` on ``frozen/generators.nlvr2_batch``;
"pretrain-mix" is ``UC2ForPretraining`` on ``pretrain_batch``, a task of
the mix and ``accum`` stacked micro-batches a step (set-up also runs one
step of every task in every bucket it routes rows to, so the window meets
no new shape).
Each step's batch is drawn from (seed, step) and put on the card just
before the step is queued (the host runs ahead of the card, so it is
fed ahead), with dropout from a ``DropoutRng`` of (seed, step), as the
drivers' ``step_seed``. The optimizer's schedule starts at ``start``
(the end of the warm-up, where a job spends its steps).

Set-up builds the model and optimizer and runs the check's steps (the
first ``check_steps``; in the mix one of each (task, bucket) of its
``check`` list) through the window's own call: they warm up the shapes
and are the ones the check follows. It keeps their losses,
each leaf's first gradient as the optimizer got it (its first moment
over 1 - beta1) and each leaf's change over them. The window then trains
the same objects on. The check runs the plain reference through the same
steps from the same weights, batches and dropout.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from h100bench.drivers.common import ModelDriver
from h100bench.frozen import flops as FL
from h100bench.frozen.generators import (bucket_rows, nlvr2_batch,
                                        pretrain_batch, sub_seed)
from h100bench.reference import model as R


class Driver(ModelDriver):

    def setup(self):
        from uc2_torch.models.finetune import UC2ForNlvr2
        from uc2_torch.models.pretraining import UC2ForPretraining
        from uc2_torch.training import optim as O
        t, o = self.traffic, self.traffic["optimizer"]
        if t["task"] not in ("nlvr2-triplet", "pretrain-mix"):
            raise ValueError(f"unknown training task {t['task']!r}")
        self.mark("imports")
        if t["task"] == "nlvr2-triplet":
            model = UC2ForNlvr2(self.port_config(), fmt="triplet",
                                device=self.device)
        else:
            model = UC2ForPretraining(self.port_config(), device=self.device)
        self.model = self.load(model)
        self.mark("model and weights")
        self.opt = O.build_optimizer(
            self.model, O.get_lr_schedule("linear", o["lr"], o["warmup"],
                                          o["total"]),
            o["weight_decay"], tuple(o["betas"]), o["eps"], o["grad_norm"],
            "adamw")
        self.opt.count = o["start"]
        self.gen = dict(t, **{k: self.cfg[k] for k in (
            "vocab_size", "img_dim", "first_word_id", "pad_token_id",
            "cls_token_id", "sep_token_id")})
        self.step_i = 0
        losses = []
        for s in range(self.n_check):
            m, _ = self.step()
            losses.append(m["loss"])
            if s == 0:
                self.norm1 = float(m["grad_norm"])
                self.grad1 = self.first_grads(self.norm1)
                self.mark("the first step")
        self.losses = [float(x) for x in losses]
        self.mark("the check's other steps")
        w = self.weights()
        with torch.no_grad():
            self.change = {n: float((p - w[n]).norm())
                           for n, p in self.model.named_parameters()}
        self.mark("their changes")
        if t["task"] == "pretrain-mix":
            for task in sorted(t["mix"]):
                for bi, rows in enumerate(bucket_rows(t, task)):
                    if len(rows):
                            self.step(pretrain_batch(
                            self.seed, ("warm", task, bi), self.gen,
                            self.device, (task, bi)))
            self.sync()
            self.mark("a step of every task and bucket")

    @property
    def n_check(self) -> int:
        t = self.traffic
        return len(t["check"]) if "check" in t else t["check_steps"]

    def batch(self, i: int):
        """(task, batch, (text tokens, regions, slots) of each row) of step
        ``i``."""
        if self.traffic["task"] == "nlvr2-triplet":
            b, (lt, nr) = nlvr2_batch(self.seed, i, self.gen, self.device)
            return "nlvr2", b, (lt, nr, np.zeros_like(lt))
        return pretrain_batch(self.seed, i, self.gen, self.device)

    def drop_seed(self, i: int) -> int:
        return sub_seed(self.seed, "dropout", i)

    def step(self, given=None):
        """One training step on the next batch (or on ``given``, a
        ``batch`` triple, outside the step count): (its metrics as device
        tensors, the batch triple)."""
        from uc2_torch.ops.dropout import DropoutRng
        from uc2_torch.training.step import train_step
        b = self.batch(self.step_i) if given is None else given
        task, batch, _ = b
        m = train_step(self.model, self.opt, batch,
                       DropoutRng(self.drop_seed(self.step_i), self.device),
                       task=task)
        if given is None:
            self.step_i += 1
        return m, b

    def first_grads(self, norm: float) -> Dict[str, float]:
        """Each leaf's first gradient norm as the optimizer got it, before
        its clipping: Adam's first moment after one step over 1 - beta1,
        times the clip's factor (the global norm ``norm`` over the
        maximum, where it clipped)."""
        o = self.traffic["optimizer"]
        clip = max(norm / o["grad_norm"], 1.0) if o["grad_norm"] > 0 else 1.0
        st = self.opt.opt.state
        return {n: float(st[p]["exp_avg"].norm()) / (1 - o["betas"][0]) * clip
                for n, p in self.model.named_parameters()}

    def example_flops(self, lens) -> float:
        """The frozen FLOP model's training work of a batch's rows, each at
        its own text tokens, regions and prediction slots."""
        c = self.cfg
        return float(sum(FL.grad_flops_per_example(
            int(lt), int(nr), int(m), c["num_hidden_layers"],
            c["hidden_size"], c["intermediate_size"], c["vocab_size"],
            c["img_dim"]) for lt, nr, m in zip(*lens)))

    def window(self, seconds: float) -> Dict:
        self.sync()
        stamps = [self.stamp()]
        losses, flops, rows = [], 0.0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            m, (_, _, lens) = self.step()
            stamps.append(self.stamp())
            losses.append(m["loss"])
            flops += self.example_flops(lens)
            rows += len(lens[0])
        self.sync()
        dt = time.perf_counter() - t0
        ms = [self.elapsed_ms(a, b) for a, b in zip(stamps, stamps[1:])]
        print(f"h100bench: window {len(ms)} steps in {dt:.3f} s, step ms "
              f"median {np.median(ms):.2f} p90 {np.percentile(ms, 90):.2f} "
              f"max {max(ms):.2f}", file=sys.stderr)
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"metrics": {"train_examples_per_s": rows / dt,
                            "train_step_p90_ms": float(np.percentile(ms, 90))},
                "attempted": len(losses), "failed": bad, "seconds": dt,
                "flops": flops, "units": len(losses)}

    def stamp(self):
        """A mark on the card's stream (on the CPU: the host's clock)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def traced_slice(self):
        """``trace_steps`` more steps; returns (steps, the (B, L) of each
        micro-batch they ran)."""
        shapes = []
        for _ in range(self.traffic["trace_steps"]):
            _, (_, batch, _) = self.step()
            mask = batch["attn_mask"]
            shapes += [tuple(mask.shape[-2:])] * (
                mask.shape[0] if mask.dim() == 3 else 1)
        return self.traffic["trace_steps"], shapes

    def free(self):
        self.model = self.opt = None
        super().free()

    def reference(self, prec=None, half=False) -> Dict:
        """The reference's losses, first gradients and changes over the
        check's steps (``half``: on the first half of each batch's rows, a
        fault)."""
        c, t = self.cfg, self.traffic
        n = self.n_check
        batches = []
        for i in range(n):
            task, b, _ = self.batch(i)
            cut = slice(None, b["input_ids"].shape[-2] // 2 if half else None)
            batches.append((task, {k: v[:, cut] if b["input_ids"].dim() == 3
                                   else v[cut] for k, v in b.items()}))
        drops = [R.DropoutStreams(self.drop_seed(i), c["hidden_dropout_prob"],
                                  c["attention_probs_dropout_prob"],
                                  self.device) for i in range(n)]

        def loss(P, task_batch, d):
            task, b = task_batch
            if task == "nlvr2":
                return R.nlvr2_triplet_loss(P, c, b, d, prec)
            A, total = b["input_ids"].shape[0], 0.0
            for a in range(A):      # micro-batches one by one, as the port
                micro = R.pretrain_loss(P, c, {k: v[a] for k, v in
                                               b.items()}, task, d, prec) / A
                micro.backward()
                total += float(micro.detach())
            return torch.tensor(total)
        return R.train(self.weights(), loss, batches, drops, t["optimizer"],
                       prec)

    def gaps(self, got: Dict, ref: Dict) -> Dict[str, float]:
        """The check's numbers of ``got`` (losses, grad1, norm1, change)
        against the reference ``ref``: ``loss_gap``, the widest relative
        gap of a step's loss; by leaf, over the larger of the reference
        leaf's value and the median leaf's, the gap of the first gradient's
        norm at the worst leaf (``grad_gap``), of the leaf's share of the
        first gradient's global norm at the median leaf
        (``share_median_gap``) and of the norm of the leaf's change over
        the steps at the worst leaf (``step_gap``). Leaves whose reference
        gradient is under a thousandth of the median leaf's are left
        out."""
        g_med = float(np.median(list(ref["grad1"].values())))
        live = [k for k, v in ref["grad1"].items() if v >= 1e-3 * g_med]
        c_med = float(np.median([ref["change"][k] for k in live]))

        def rel(a, b, med):
            return sorted(abs(a[k] - b[k]) / max(b[k], med) for k in live)

        def shares(v):
            return {k: v["grad1"][k] / v["norm1"] for k in live}
        rs = rel(shares(got), shares(ref), g_med / ref["norm1"])
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                                zip(got["losses"], ref["losses"])),
                "grad_gap": rel(got["grad1"], ref["grad1"], g_med)[-1],
                "share_median_gap": rs[len(rs) // 2],
                "step_gap": rel(got["change"], ref["change"], c_med)[-1]}

    def check(self) -> Dict[str, float]:
        self.ref = self.reference()
        return self.gaps({"losses": self.losses, "grad1": self.grad1,
                          "norm1": self.norm1, "change": self.change},
                         self.ref)

    def control(self) -> Dict[str, float]:
        """The check's numbers of the reference computed in fp8 (after
        ``check``)."""
        return self.gaps(self.reference("fp8"), self.ref)

    def faults(self) -> Dict:
        """The check's numbers of the reference put in the program's place
        with half of each batch's rows left out (the mean over the rest),
        and of a step that leaves the state unchanged (after ``check``)."""
        half = self.reference(half=True)
        still = dict(self.ref, change={k: 0.0 for k in self.ref["change"]})
        return {"fault_half_batch": self.gaps(half, self.ref),
                "fault_unchanged": self.gaps(still, self.ref)}
