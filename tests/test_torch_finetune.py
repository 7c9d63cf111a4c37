"""The VQA, VE and NLVR2 finetuning modules of uc2_torch against the
reference package at a tiny config (hidden 32, two layers, fp32, dropout
0) on the CPU:

* ``vqa_answers`` (normalisation, scores, answer maps, targets) on a list
  of raw answers, and the copied answer maps byte for byte;
* ``nlvr2_eval``;
* ``VqaDataset``, ``VeDataset``, ``Nlvr2TwoRowDataset`` and
  ``Nlvr2PairedDataset`` over one store the port writes: examples,
  collated batches and a ``TaskLoader``'s batches bit for bit;
* ``bce_with_logits`` (at +-80 too) and its gradient;
* ``UC2ForVqa``'s logits, loss and gradients under "xla" and
  "pallas-train" (the reference's ``flash_attention_train`` in interpret
  mode), and ``UC2ForNlvr2``'s in its three formats (with
  ``img_type_ids``, the three-row type table and pads on both sides of
  paired-attn's pairs), through ``make_loss_fn`` as the drivers reduce
  them;
* ``expand_type_embeddings`` and the converter's round trip of the new
  heads' trees."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import datasets as jax_datasets
from uc2_tpu.data import db as jax_db
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.data.collate import BucketSpec as JaxBucketSpec
from uc2_tpu.evalu import itm_metrics as jax_metrics
from uc2_tpu.models import finetune as jax_finetune
from uc2_tpu.models import heads as jax_heads
from uc2_tpu.ops import attention as jax_attention
from uc2_tpu.utils import vqa_answers as jax_answers
from uc2_torch.config import UC2Config
from uc2_torch.data import datasets, db, loader
from uc2_torch.data.collate import BucketSpec
from uc2_torch.data.synth import synth_corpus, synth_finetune_texts
from uc2_torch.evalu import itm_metrics
from uc2_torch.models import convert, finetune, heads
from uc2_torch.ops import flash_attention as port_fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training.step import make_loss_fn
from uc2_torch.utils import vqa_answers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, img_dim=16, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
CORPUS = dict(txt_per_img=2, min_bb=4, max_bb=8, img_dim=16, n_classes=11,
              max_words=6, vocab=512)
TXT_LEN, NUM_BB, N_ANSWER = 18, 8, 9
MAPS = ["ans2label.json", "ans2label_en_trans2_ja.json",
        "ans2label_ja.json", "ans2label_ja_trans2_en.json",
        "ans2label_vg.json"]


# ------------------------------------------------------------- answers
RAW = ["Yes", "yes.", "two", "Two dogs", "the man", "a, b", "1,000",
       "dont know", "It's red!", "10:30", "(none)", "zero", "an apple",
       "isnt it", "3.5", "Ive got", "left/right", "ten", "no", "yes"]


def test_answer_normalisation_and_targets_match_reference(tmp_path):
    for n in range(6):
        assert vqa_answers.get_score(n) == jax_answers.get_score(n)
    for a in RAW:
        for f in ("process_punctuation", "process_digit_article",
                  "preprocess_answer"):
            assert getattr(vqa_answers, f)(a) == getattr(jax_answers, f)(a)
    entries = [{"multiple_choice_answer": a, "question_id": i % 7}
               for i, a in enumerate(RAW * 3)]
    for k in (1, 2, 3):
        got = vqa_answers.filter_answers(entries, k)
        assert got == jax_answers.filter_answers(entries, k)
    occ = vqa_answers.filter_answers(entries, 1)
    a2l = vqa_answers.create_ans2label(occ, str(tmp_path / "port.json"))
    assert a2l == jax_answers.create_ans2label(occ, str(tmp_path / "r.json"))
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "r.json").read_bytes()
    answers = [{"answer": a} for a in RAW[:10] + RAW[:4] + RAW[:2]]
    assert vqa_answers.compute_target(answers, a2l) == \
        jax_answers.compute_target(answers, a2l)
    ve = ["entailment", "neutral", "entailment", "contradiction", "other"]
    assert vqa_answers.compute_target_ve(ve) == \
        jax_answers.compute_target_ve(ve)
    assert vqa_answers.VE_ANS2LABEL == jax_answers.VE_ANS2LABEL


@pytest.mark.parametrize("name", MAPS)
def test_answer_maps_are_the_reference_bytes(name):
    port = os.path.join(ROOT, "uc2_torch", "assets", "ans2label", name)
    ref = os.path.join(ROOT, "uc2_tpu", "assets", "ans2label", name)
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    got = vqa_answers.load_ans2label(name)
    assert got == jax_answers.load_ans2label(name)
    assert len(got) == (3129 if name in MAPS[:2] else 3000)


def test_nlvr2_eval_matches_reference():
    rng = np.random.default_rng(0)
    ids = [f"dev-{i // 4:04d}-{i % 4}-{i % 2}" for i in range(40)]
    ids += ["test1-7", "odd"]
    labels = {k: ("true" if rng.random() < 0.5 else "false") for k in ids}
    for flip in (0.0, 0.2, 1.0):
        preds = {k: (v if rng.random() >= flip else
                     ("false" if v == "true" else "true"))
                 for k, v in labels.items()}
        got = itm_metrics.nlvr2_eval(preds, labels)
        assert got == jax_metrics.nlvr2_eval(preds, labels)
    assert itm_metrics.nlvr2_eval(labels, labels) == {"acc": 1.0,
                                                      "consistency": 1.0}


# ------------------------------------------------------------ datasets
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_stores")
    c = synth_corpus(str(root / "c"), n_imgs=10, seed=13, **CORPUS)
    return {"img_db": c["img_db"],
            "vqa": synth_finetune_texts(str(root / "vqa"), c["txt_db"],
                                        "vqa", seed=1,
                                        num_answer=N_ANSWER)["txt_db"],
            "ve": synth_finetune_texts(str(root / "ve"), c["txt_db"], "vqa",
                                       seed=3, num_answer=3)["txt_db"],
            "nlvr2": synth_finetune_texts(str(root / "nlvr2"), c["txt_db"],
                                          "nlvr2", seed=2)["txt_db"]}


def _dbs(pkg_db, stores, task):
    return (pkg_db.TxtTokDb(stores[task], max_txt_len=16),
            pkg_db.DetectFeatDb(stores["img_db"], 0.2, NUM_BB, 4, 36))


DATASETS = {
    "vqa": ("VqaDataset", "vqa", (N_ANSWER,), NUM_BB, 4),
    "ve": ("VeDataset", "ve", (), NUM_BB, 4),
    "nlvr2-two-row": ("Nlvr2TwoRowDataset", "nlvr2", (), NUM_BB, 3),
    "nlvr2-two-row-no-type": ("Nlvr2TwoRowDataset", "nlvr2", (False,),
                              NUM_BB, 3),
    "nlvr2-paired": ("Nlvr2PairedDataset", "nlvr2", (), 2 * NUM_BB, 4),
    "nlvr2-paired-no-type": ("Nlvr2PairedDataset", "nlvr2", (False,),
                             2 * NUM_BB, 4)}


def _build(name, stores):
    cls, task, args, _, _ = DATASETS[name]
    return (getattr(datasets, cls)(*_dbs(db, stores, task), *args),
            getattr(jax_datasets, cls)(*_dbs(jax_db, stores, task), *args))


def _assert_batches_equal(got, want):
    keys = set(want) - {"_bucket"}
    assert set(got) - {"_bucket"} == keys
    for k in keys:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("name", list(DATASETS))
def test_finetune_datasets_match_reference(stores, name):
    """Every example, a collated batch of the first five, and a loader's
    first three batches and its unshuffled epoch, bit for bit."""
    got, want = _build(name, stores)
    _, _, _, nb, bsz = DATASETS[name]
    assert len(got) == len(want) == 20
    assert got.lens == want.lens and got.txt_lens == want.txt_lens
    assert getattr(got, "sample_size", None) == getattr(want, "sample_size",
                                                        None)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    ex = [got.get_example(i, rng) for i in range(len(got))]
    jex = [want.get_example(i, jrng) for i in range(len(want))]
    flat = [e for x in ex for e in (x if isinstance(x, list) else [x])]
    jflat = [e for x in jex for e in (x if isinstance(x, list) else [x])]
    assert len(flat) == len(jflat)
    for g, w in zip(flat, jflat):
        _assert_batches_equal(g, w)
    n = 10 if isinstance(ex[0], list) else 5
    _assert_batches_equal(
        got.collate(flat[:n], BucketSpec(TXT_LEN, nb, 12)),
        want.collate(jflat[:n], JaxBucketSpec(TXT_LEN, nb, 12)))
    for kw in ({"seed": 5}, {"seed": 0, "shuffle": False,
                             "drop_last": False}):
        tl = loader.TaskLoader(name, got, [BucketSpec(TXT_LEN, nb, bsz)],
                               **kw)
        jtl = jax_loader.TaskLoader(name, want,
                                    [JaxBucketSpec(TXT_LEN, nb, bsz)], **kw)
        if kw.get("shuffle") is False:
            pairs = list(zip(tl.one_epoch(), jtl.one_epoch()))
            assert len(pairs) == -(-20 // bsz)
        else:
            pairs = [(tl.next_batch(), jtl.next_batch()) for _ in range(3)]
        for g, w in pairs:
            _assert_batches_equal(g, w)


def test_vqa_soft_targets_are_the_records_scores(stores):
    (txt, img) = _dbs(db, stores, "vqa")
    ds = datasets.VqaDataset(txt, img, N_ANSWER)
    for i in range(len(ds)):
        rec = txt[ds.ids[i]]["target"]
        t = ds.get_example(i, None)["soft_target"]
        want = np.zeros(N_ANSWER, np.float32)
        want[rec["labels"]] = rec["scores"]
        assert np.array_equal(t, want) and t.dtype == np.float32
    assert len({txt[k]["target"]["scores"][0] for k in ds.ids}) > 1


# ---------------------------------------------------------------- heads
def test_bce_with_logits_matches_reference():
    x = np.array([[-80.0, -20.0, -1.5, 0.0, 0.0, 1e-3, 2.5, 20.0, 80.0]],
                 np.float32)
    t = np.array([[0.0, 1.0, 0.3, 0.6, 0.0, 1.0, 0.9, 0.0, 1.0]], np.float32)
    want = jax_heads.bce_with_logits(jnp.asarray(x), jnp.asarray(t))
    wgrad = jax.grad(lambda a: jax_heads.bce_with_logits(
        a, jnp.asarray(t)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = heads.bce_with_logits(xt, torch.from_numpy(t))
    got.sum().backward()
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgrad),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- models
def _perturbed(tree, seed=0):
    """Parameters moved away from init so that every logit moves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2, tree)


def _batch(stores, name, n):
    ds, _ = _build(name, stores)
    rng = np.random.default_rng(3)
    ex = [ds.get_example(i, rng) for i in range(n)]
    flat = [e for x in ex for e in (x if isinstance(x, list) else [x])]
    b = ds.collate(flat, BucketSpec(TXT_LEN, DATASETS[name][3], len(flat)))
    return {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in b.items()}


def _ref_loss_and_grads(jm, params, batch, reduce, kernel):
    def loss(p, b):
        return reduce(jm.loss(p, b, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1)}))
    fn = jax.jit(jax.value_and_grad(loss))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if not kernel:
        return fn(params, jb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "_on_tpu", lambda: True)
        with pltpu.force_tpu_interpret_mode():
            return fn(params, jb)


def _check_step(model, jm, params, batch, task, monkeypatch, impl):
    """make_loss_fn(task)'s loss and every gradient against the
    reference's at dropout 0, the kernel route running its kernel's plain
    version in every layer; then the deterministic logits."""
    reduce = ((lambda l: jnp.mean(jnp.sum(l, -1))) if task == "vqa"
              else jnp.mean)
    want, wgrads = _ref_loss_and_grads(jm, params, batch, reduce,
                                       kernel=impl != "xla")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    calls = []
    if impl == "pallas-train":
        real = port_fa.flash_attention_train
        monkeypatch.setattr(port_fa, "flash_attention_train",
                            lambda *a: calls.append(1) or real(*a))
    loss, m = make_loss_fn(task)(model, tb, DropoutRng(1, "cpu"))
    assert len(calls) == (TINY["num_hidden_layers"]
                          if impl == "pallas-train" else 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_g = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            wgrads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) - set(want_g) == {
        "roberta.img_embeddings.mask_embedding"}
    for n in want_g:
        g = got_g[n] if got_g[n] is not None else torch.zeros_like(want_g[n])
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), err_msg=n,
                                   **TOL)
    logits = model.logits(tb)
    assert not logits.requires_grad and logits.dtype == torch.float32
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.logits(params, jb)), **TOL)
    return m


@pytest.mark.parametrize("impl", ["xla", "pallas-train"])
def test_vqa_loss_and_grads_match_reference(stores, monkeypatch, impl):
    cfg = dict(TINY, use_pallas_attention=impl)
    jm = jax_finetune.UC2ForVqa(JaxConfig(**cfg), N_ANSWER)
    params = _perturbed(jm.init_params(jax.random.PRNGKey(0)))
    model = finetune.UC2ForVqa(UC2Config(**cfg), N_ANSWER, device="cpu",
                               params=params)
    batch = _batch(stores, "vqa", 6)
    assert batch["soft_targets"].shape == (6, N_ANSWER)
    m = _check_step(model, jm, params, batch, "vqa", monkeypatch, impl)
    assert m["n_units"].item() == 6
    elems = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                       rng=DropoutRng(1, "cpu"))
    assert elems.shape == (6, N_ANSWER)


NLVR2 = [("triplet", "xla"), ("paired", "xla"), ("paired-attn", "xla"),
         ("paired-attn", "pallas-train")]


@pytest.mark.parametrize("fmt,impl", NLVR2,
                         ids=[f"{f}-{i}" for f, i in NLVR2])
def test_nlvr2_loss_and_grads_match_reference(stores, monkeypatch, fmt,
                                              impl):
    cfg = dict(TINY, use_pallas_attention=impl)
    jm = jax_finetune.UC2ForNlvr2(JaxConfig(**cfg), fmt=fmt)
    params = _perturbed(jm.init_params(jax.random.PRNGKey(0)))
    assert params["roberta"]["token_type_embeddings"].shape == (3, 32)
    model = finetune.UC2ForNlvr2(UC2Config(**cfg), fmt=fmt, device="cpu",
                                 params=params)
    name = "nlvr2-paired" if fmt == "triplet" else "nlvr2-two-row"
    batch = _batch(stores, name, 5)
    rows = 5 if fmt == "triplet" else 10
    assert batch["input_ids"].shape[0] == rows
    assert batch["targets"].shape == (5,)
    assert set(np.unique(batch["img_type_ids"])) == {1, 2}
    if fmt != "triplet":
        # pads on both sides of every pair
        pad = batch["attn_mask"].reshape(5, 2, -1) == 0
        assert pad.any(-1).all()
    m = _check_step(model, jm, params, batch, "nlvr2", monkeypatch, impl)
    assert m["n_units"].item() == 5
    # the image type ids reach the model: the logits move without them
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    plain = dict(tb)
    plain.pop("img_type_ids")
    assert not torch.allclose(model.logits(tb), model.logits(plain))


def test_nlvr2_refuses_an_unknown_format():
    with pytest.raises(ValueError, match="format"):
        finetune.UC2ForNlvr2(UC2Config(**TINY), fmt="pair", device="cpu")


def test_expand_type_embeddings_matches_reference():
    rng = np.random.default_rng(0)
    for rows in (2, 3):
        t = rng.standard_normal((rows, 8)).astype(np.float32)
        got = finetune.expand_type_embeddings(
            {"roberta": {"token_type_embeddings": t.copy()}})
        want = jax_finetune.expand_type_embeddings(
            {"roberta": {"token_type_embeddings": t.copy()}})
        g = got["roberta"]["token_type_embeddings"]
        assert g.shape == (3, 8)
        assert np.array_equal(g, want["roberta"]["token_type_embeddings"])
        assert np.array_equal(g[:rows], t)
        assert np.array_equal(g[2], t[2 if rows == 3 else 1])


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and np.array_equal(g, w), f"{path}/{k}"


@pytest.mark.parametrize("what", ["vqa", "triplet", "paired", "paired-attn"])
def test_convert_round_trip_of_the_heads(what):
    """Reference tree -> the port's model -> reference tree, exactly (the
    Dense kernels transposed both ways), with the heads' keys in the
    reference's layout."""
    cfg = JaxConfig(**TINY)
    if what == "vqa":
        jm = jax_finetune.UC2ForVqa(cfg, N_ANSWER)
    else:
        jm = jax_finetune.UC2ForNlvr2(cfg, fmt=what)
    tree = _perturbed(jm.init_params(jax.random.PRNGKey(1)))
    model = (finetune.UC2ForVqa(UC2Config(**TINY), N_ANSWER, device="cpu",
                                params=tree) if what == "vqa" else
             finetune.UC2ForNlvr2(UC2Config(**TINY), fmt=what, device="cpu",
                                  params=tree))
    back = convert.params_to_jax(model.state_dict())
    back["roberta"]["img_embeddings"].pop("mask_embedding")
    _assert_trees_equal(back, tree)
    sd = model.state_dict()
    if what == "vqa":
        w = tree["vqa_output"]["dense"]["kernel"]
        assert np.array_equal(sd["vqa_output.dense.weight"].numpy(), w.T)
        assert sd["vqa_output.out.weight"].shape == (N_ANSWER, 64)
    elif what == "paired-attn":
        head = tree["attn_head"]
        for a in ("attn1", "attn2"):
            for p in ("q", "k", "v", "out"):
                assert np.array_equal(
                    sd[f"attn_head.{a}.{p}.weight"].numpy(),
                    head[a][p]["kernel"].T)
        assert np.array_equal(sd["attn_head.attn_pool.fc.weight"].numpy(),
                              head["attn_pool"]["fc"]["kernel"].T)
        assert sd["attn_head.fc.weight"].shape == (32, 64)
    else:
        k = tree["nlvr2_output"]["kernel"]
        assert k.shape == ((32 if what == "triplet" else 64), 2)
        assert np.array_equal(sd["nlvr2_output.weight"].numpy(), k.T)
    assert sd["roberta.token_type_embeddings.weight"].shape[0] == (
        2 if what == "vqa" else 3)
    # a port milestone loads back through the partial-tree path
    again = (finetune.UC2ForVqa(UC2Config(**TINY), N_ANSWER, device="cpu",
                                seed=5) if what == "vqa" else
             finetune.UC2ForNlvr2(UC2Config(**TINY), fmt=what, device="cpu",
                                  seed=5))
    convert.load_partial_tree(again, convert.params_to_jax(sd))
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k
