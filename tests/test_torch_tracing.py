"""The port's spans and counters (``uc2_torch.utils.profiling``) on the
CPU:

* with no profiler running, ``score_matrix`` and ``train_step`` record
  nothing and build no span;
* under ``torch.profiler.profile`` a tiny ``score_matrix`` records
  ``score.call`` with its ``score.gallery``, ``score.upload`` and
  ``score.chunk`` children, and counts its pairs and padded slots as a
  hand count of a gallery whose last tiles are partly empty;
* a stacked step of two micro-batches records one ``train.step`` with two
  ``train.forward``, two ``train.backward`` and one ``train.update``,
  nested and in order, ``train.lm_head`` inside each forward of the LM
  tasks and of no other;
* scores, and a step's loss, gradient norm and parameters, are bit for
  bit the same with the profiler on and off;
* the ring keeps only its newest records.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uc2_torch.config import UC2Config
from uc2_torch.data.memdb import MemImgDb, MemTxtDb
from uc2_torch.evalu.retrieval import score_matrix
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training import optim
from uc2_torch.training.step import train_step, train_step_micro
from uc2_torch.utils import profiling

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, img_dim=16, img_label_dim=11,
            dtype="float32")
TXT_LEN, NUM_BB = 12, 8
# bucket edges (4, 8): four images of <= 4 regions, three of 5-8
NBBS = (3, 4, 2, 4, 6, 8, 7)
N_TXT, BATCH, CHUNK = 5, 3, 2
B, LT, NB, M = 3, 10, 7, 5


@pytest.fixture(autouse=True)
def fresh_ring(monkeypatch):
    """Each test reads a ring of its own."""
    monkeypatch.setattr(profiling, "_ring",
                        collections.deque(maxlen=profiling.RING))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _gallery():
    rng = np.random.default_rng(3)
    img_ids = [f"img{j}" for j in range(len(NBBS))]
    img_db = MemImgDb({im: (rng.standard_normal((n, TINY["img_dim"]))
                            .astype(np.float16),
                            rng.random((n, 7)).astype(np.float32))
                       for im, n in zip(img_ids, NBBS)})
    txt_ids = [f"txt{i}" for i in range(N_TXT)]
    txt_db = MemTxtDb({t: {"img_fname": img_ids[i % len(img_ids)],
                           "input_ids": list(rng.integers(5, 200, 3 + i))}
                       for i, t in enumerate(txt_ids)},
                      vocab=TINY["vocab_size"])
    return txt_db, img_db, txt_ids, img_ids


def _scores(model):
    txt_db, img_db, txt_ids, img_ids = _gallery()
    return score_matrix(model, txt_db, img_db, txt_ids, img_ids, TXT_LEN,
                        NUM_BB, batch_size=BATCH, txt_chunk=CHUNK,
                        device="cpu")


def _retrieval():
    return UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu", seed=4)


def _batch(seed, task):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, TINY["vocab_size"], (B, LT))
    ids[:, 0] = 0
    mask = np.ones((B, LT + NB), np.int64)
    mask[0, LT - 3:LT] = 0
    mask[1, LT + NB // 2:] = 0
    b = {"input_ids": ids, "attn_mask": mask,
         "img_feat": rng.standard_normal((B, NB, TINY["img_dim"])).astype(
             np.float32),
         "img_pos_feat": rng.random((B, NB, 7)).astype(np.float32)}
    if task == "itm":
        b["targets"] = rng.integers(0, 2, B)
    else:
        b.update(masked_pos=rng.integers(1, LT - 3, (B, M)),
                 masked_weight=np.ones((B, M), np.float32),
                 txt_labels=rng.integers(5, TINY["vocab_size"], (B, M)))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _step(task, how):
    """A fresh model's one step on two micro-batches (``how``: stacked
    through ``train_step``, or given one by one to ``train_step_micro``):
    (the step's metrics, the model)."""
    model = UC2ForPretraining(UC2Config(**TINY), device="cpu", seed=5)
    opt = optim.build_optimizer(model, optim.constant(1e-3), grad_norm=1.0)
    micro = [_batch(s, task) for s in (1, 2)]
    if how == "stacked":
        stacked = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
        met = train_step(model, opt, stacked, DropoutRng(7, "cpu"),
                         task=task)
    else:
        met = train_step_micro(model, opt, [(m, DropoutRng(7, "cpu"))
                                            for m in micro], task=task)
    return met, model


def test_no_profiler_records_nothing_and_builds_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was built with no profiler running")
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling, "_mark", refuse)
    assert profiling.span("x") is profiling._OFF
    assert profiling.span("x", stream=True) is profiling._OFF
    profiling.count("pairs", 3)
    _scores(_retrieval())
    _step("mlm", "stacked")
    assert profiling.records() == []


def test_score_matrix_spans_and_counts():
    sc = _profiled(lambda: _scores(_retrieval()))
    recs = profiling.records()
    call = recs[0]
    assert call.name == "score.call" and call.parent is None
    assert call.root == call.id
    # two buckets (4 and 3 images), each of ceil(5 / 2) = 3 chunks
    assert [r.name for r in recs[1:]] == (
        ["score.gallery"] + (["score.upload"] + ["score.chunk"] * 3) * 2)
    assert all(r.parent == call.id and r.root == call.id for r in recs[1:])
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    assert all(call.start_ns <= r.start_ns and r.end_ns <= call.end_ns
               for r in recs[1:])
    # 4 images take 2 tiles of 3, the last holding one image; 3 take one
    assert call.counts == {"pairs": N_TXT * 7, "slots": N_TXT * (6 + 3)}
    assert all(r.counts == {} for r in recs[1:])
    assert sc.shape == (N_TXT, len(NBBS))


def test_scores_bit_for_bit_with_the_profiler_on():
    off = _scores(_retrieval())
    on = _profiled(lambda: _scores(_retrieval()))
    assert np.array_equal(off, on)
    assert profiling.records()


@pytest.mark.parametrize("task,how", [("mlm", "stacked"), ("itm", "stacked"),
                                      ("mlm", "micro")])
def test_train_step_spans_nest_in_order(task, how):
    _profiled(lambda: _step(task, how))
    recs = profiling.records()
    step = recs[0]
    head = ["train.lm_head"] if task == "mlm" else []
    assert [r.name for r in recs] == (
        ["train.step"] + (["train.forward"] + head + ["train.backward"]) * 2
        + ["train.update"])
    assert step.parent is None
    by_id = {r.id: r for r in recs}
    for r in recs[1:]:
        assert r.root == step.id
        want = "train.forward" if r.name == "train.lm_head" else "train.step"
        assert by_id[r.parent].name == want
        assert by_id[r.parent].start_ns <= r.start_ns
        assert r.end_ns <= by_id[r.parent].end_ns
    for a, b in zip(recs[1:], recs[2:]):
        if a.parent == b.parent:
            assert a.end_ns <= b.start_ns
    # on the CPU every span is marked on the host's clock
    assert all(not r.on_device and r.stream_ms() >= 0 for r in recs)
    assert sum(r.stream_ms() for r in recs
               if r.parent == step.id) <= step.stream_ms()


@pytest.mark.parametrize("task", ["mlm", "itm"])
def test_train_step_bit_for_bit_with_the_profiler_on(task):
    m_off, off = _step(task, "stacked")
    m_on, on = _profiled(lambda: _step(task, "stacked"))
    assert profiling.records()
    for k in ("loss", "grad_norm"):
        assert torch.equal(m_off[k], m_on[k]), k
    for (n, p), q in zip(off.named_parameters(), on.parameters()):
        assert torch.equal(p, q), n


def test_the_ring_keeps_its_newest_records():
    n = profiling.RING + 10

    def spans():
        for i in range(n):
            with profiling.span(f"s{i}"):
                profiling.count("i", i)
    _profiled(spans)
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert [r.name for r in recs] == [f"s{i}" for i in range(10, n)]
    assert recs[-1].counts == {"i": n - 1}
    ids = [r.id for r in recs]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)


def test_count_outside_a_span_and_the_stream_of_a_plain_span():
    def body():
        profiling.count("lost", 1)
        with profiling.span("plain") as rec:
            profiling.count("n", 2)
            profiling.count("n", 3)
        return rec
    rec = _profiled(body)
    assert profiling.records() == [rec]
    assert rec.counts == {"n": 5}
    assert rec.stream_ms() is None and not rec.on_device
