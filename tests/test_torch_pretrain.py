"""The pretraining task mix of config/uc2_pretrain.json (itm, mlm, vmlm,
tlm) in uc2_torch against the reference package at fp32 on the CPU: the
loss and every gradient of itm, vmlm and tlm under "pallas-train" with and
without UC2_FFN_TRAIN=1 (the reference then runs its Pallas FFN kernel in
interpret mode, the port the kernels' plain versions), one AdamW step of a
vmlm batch, the itm and itm-ot reductions, and the data side bit for bit:
co-masking and region masking, the label vocabulary, the synthetic
pretraining corpus, each task's dataset and its collate. Both packages
read one in-memory corpus (``uc2_torch/data/memdb.py``). Dropout is 0
where values are compared: the two packages draw different masks."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import collate as jax_collate
from uc2_tpu.data import datasets as jax_datasets
from uc2_tpu.data import labels as jax_labels
from uc2_tpu.data import masking as jax_masking
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.training import optim as jax_optim
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, datasets, labels, masking
from uc2_torch.data.memdb import synth_pretrain_corpus
from uc2_torch.models.convert import params_from_jax
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import ffn_train
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training import optim
from uc2_torch.training.step import make_loss_fn, train_step

VOCAB = 1000
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
            use_pallas_attention="pallas-train")
TOL = dict(rtol=1e-4, atol=1e-4)
# one bucket: pairs of 2-4 words a language (at most 18 raw tokens) fit
# Lt = 24; 3-8 regions
LT, NB, B, SLOTS = 24, 8, 4, 8
CORPUS = dict(n_imgs=6, txt_per_img=2, vocab=VOCAB, img_dim=32, min_bb=3,
              max_bb=NB, max_words=4)


def _tok(word):
    return labels.hash_tokenize(word, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def corpus():
    return synth_pretrain_corpus(5, **CORPUS)


@pytest.fixture(scope="module")
def vocabs():
    """The label vocabulary of each package, hashed into the tiny vocab."""
    return (labels.LabelVocab(tokenize=_tok),
            jax_labels.LabelVocab(tokenize=_tok))


@pytest.fixture(scope="module")
def params():
    """Reference pretraining parameters, moved away from init."""
    tree = JaxPretraining(JaxConfig(**TINY)).init_params(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


def _datasets(pkg, vocab, txt_db, img_db):
    """task -> dataset of ``pkg`` (uc2_torch.data.datasets or the
    reference's), as config/uc2_pretrain.json's cc_de builds them."""
    return {"itm": pkg.ItmDataset(txt_db, img_db, neg_sample_p=0.5),
            "mlm": pkg.MlmDataset(txt_db, img_db),
            "vmlm": pkg.VmlmDataset(txt_db, img_db, label_vocab=vocab,
                                    lang="de"),
            "tlm": pkg.TlmDataset(txt_db, img_db, comasking_mode="mix")}


def _examples(ds, seed):
    rng = np.random.default_rng(seed)
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    return [ds.get_example(i, rng) for i in range(len(ds))]


def _spec(task):
    return collate.BucketSpec(LT, NB, B, 0 if task == "itm" else SLOTS)


def _batch(corpus, vocabs, task, seed=1):
    ds = _datasets(datasets, vocabs[0], *corpus)[task]
    return ds.collate(_examples(ds, seed)[:B], _spec(task))


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _port(params):
    return UC2ForPretraining(UC2Config(**TINY), device="cpu", params=params)


def _assert_trees_close(got: dict, want_tree, **tol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


# ----------------------------------------------------- the slice as a whole
@pytest.mark.parametrize("ffn_kernels", [True, False])
@pytest.mark.parametrize("task", ["itm", "vmlm", "tlm"])
def test_task_loss_and_grads_match_reference(params, corpus, vocabs,
                                             monkeypatch, task, ffn_kernels):
    """With UC2_FFN_TRAIN=1 both packages run their training FFN block in
    every layer (the reference its Pallas kernel in interpret mode)."""
    if ffn_kernels:
        monkeypatch.setenv("UC2_FFN_TRAIN", "1")
    else:
        monkeypatch.delenv("UC2_FFN_TRAIN", raising=False)
    b = _batch(corpus, vocabs, task)
    jm = JaxPretraining(JaxConfig(**TINY))
    (want, wm), wgrads = jax.value_and_grad(
        jax_step.make_loss_fn(jm, task), has_aux=True)(
        params, _jax(b), jax.random.PRNGKey(1))
    model = _port(params)
    calls = []
    real = ffn_train.fused_ffn_block_train_bwd
    monkeypatch.setattr(ffn_train, "fused_ffn_block_train_bwd",
                        lambda *a: calls.append(1) or real(*a))
    loss, m = make_loss_fn(task)(model, _torch(b), DropoutRng(1, "cpu"))
    loss.backward()
    assert len(calls) == (TINY["num_hidden_layers"] if ffn_kernels else 0)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    assert m["n_units"].item() == float(wm["n_units"])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    _assert_trees_close(grads, wgrads, **TOL)


@pytest.mark.parametrize("impl,env,train,want", [
    ("pallas-train", "1", True, 2), ("pallas-train", "0", True, 0),
    ("pallas-train", None, True, 0), ("pallas-train", "1", False, 0),
    (True, "1", True, 0), (False, "1", True, 0)])
def test_ffn_block_routing_follows_the_reference(params, corpus, vocabs,
                                                 monkeypatch, impl, env,
                                                 train, want):
    """The training FFN block runs in every layer exactly when training
    under "pallas-train" with UC2_FFN_TRAIN=1, read at each forward; with
    dropout its seed comes from the rng, else it is 0."""
    from uc2_torch.models import encoder
    if env is None:
        monkeypatch.delenv("UC2_FFN_TRAIN", raising=False)
    else:
        monkeypatch.setenv("UC2_FFN_TRAIN", env)
    seeds = []
    real = encoder.fused_ffn_block_train
    monkeypatch.setattr(encoder, "fused_ffn_block_train",
                        lambda *a: seeds.append(a[7]) or real(*a))
    b = _torch(_batch(corpus, vocabs, "mlm"))
    for rate in (0.0, 0.1):
        seeds.clear()
        model = UC2ForPretraining(
            UC2Config(**{**TINY, "use_pallas_attention": impl,
                         "hidden_dropout_prob": rate}),
            device="cpu", params=params)
        make_loss_fn("mlm")(model, b, DropoutRng(1, "cpu") if train
                            else None)[0].backward()
        assert len(seeds) == want
        assert all((s > 0) == (rate > 0) for s in seeds)


def test_vmlm_train_step_matches_reference(params, corpus, vocabs):
    """One AdamW update of a vmlm batch at lr constant(1e-3), clip 5.0:
    loss, slots, grad norm and every parameter."""
    b = _batch(corpus, vocabs, "vmlm", seed=2)
    jm = JaxPretraining(JaxConfig(**TINY))
    tx = jax_optim.build_optimizer(params, jax_optim.constant(1e-3),
                                   grad_norm=5.0)
    state = jax_step.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, want = jax.jit(jax_step.make_train_step(jm, "vmlm", tx))(
        state, _jax(b), jax.random.PRNGKey(1))
    model = _port(params)
    opt = optim.build_optimizer(model, optim.constant(1e-3), grad_norm=5.0)
    got = train_step(model, opt, _torch(b), DropoutRng(1, "cpu"),
                     task="vmlm")
    for k in ("loss", "n_units", "grad_norm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)
    _assert_trees_close(dict(model.named_parameters()), state.params, **TOL)


def test_itm_reduces_over_the_padded_batch(params, corpus, vocabs):
    """itm divides by the padded batch size (trailing pad rows included),
    as the reference; so does itm-ot's cross-entropy, to which it adds
    lambda times the OT term over the real positive and negative rows
    ((sum pos - sum neg) / (n_pos + n_neg), or the positives' mean): the
    loss and every metric equal the reference's at 1e-4."""
    ds = _datasets(datasets, vocabs[0], *corpus)["itm"]
    b = ds.collate(_examples(ds, 1)[:B - 1], _spec("itm"))
    model = _port(params)
    loss, m = make_loss_fn("itm")(model, _torch(b), None)
    s, n, ot = model.forward_itm(_torch(b))
    assert n == B and m["n_units"].item() == B and ot is None
    np.testing.assert_allclose(loss.item(), s.item() / B, rtol=1e-6)
    jm = JaxPretraining(JaxConfig(**TINY))
    for pos_only in (False, True):
        want, wm = jax_step.make_loss_fn(jm, "itm-ot", itm_ot_lambda=0.5,
                                         ot_pos_only=pos_only)(
            params, _jax(b), None)
        got, gm = make_loss_fn("itm-ot", itm_ot_lambda=0.5,
                               ot_pos_only=pos_only)(model, _torch(b), None)
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k].item(), float(wm[k]),
                                       err_msg=k, **TOL)
        np.testing.assert_allclose(got.item(), float(want), **TOL)
        np.testing.assert_allclose(
            got.item(), gm["xe"].item() + 0.5 * gm["ot"].item(), rtol=1e-6)
    np.testing.assert_allclose(gm["xe"].item(), loss.item(), rtol=1e-6)
    for task in ("itm-ot", "vmlm-soft", "mrfr"):
        make_loss_fn(task)
    with pytest.raises(ValueError):
        make_loss_fn("nsp")


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comasking_and_region_masks_match_reference(corpus, vocabs, seed):
    txt_db, img_db = corpus
    v_range, mask = txt_db.v_range, txt_db.mask
    for i, tid in enumerate(txt_db.ids):
        rec = txt_db[tid]
        soft = img_db.get_dump(rec["img_fname"])["soft_labels"]
        nbb = img_db.name2nbb[rec["img_fname"]]
        calls = [
            lambda m, r, v: m.comask_tokens(rec, v_range, mask, r, "full"),
            lambda m, r, v: m.comask_tokens(rec, v_range, mask, r, "random"),
            lambda m, r, v: m.mix_comask(rec, v_range, mask, r),
            lambda m, r, v: (m.region_mask(r, nbb),),
            lambda m, r, v: m.region_mask_with_token_labels(
                r, nbb, soft, v, "de", 0.3)]
        for call in calls:
            got, want = (call(pkg, np.random.default_rng(seed * 100 + i), v)
                         for pkg, v in zip((masking, jax_masking), vocabs))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_label_vocab_matches_reference(vocabs):
    ours, ref = vocabs
    assert ours.source == ref.source == "tokenizer"
    assert np.array_equal(ours.valid_ids, ref.valid_ids)
    assert np.array_equal(ours.label2token_valid, ref.label2token_valid)
    for lang in ("en", "de"):
        for c in (0, 1, 2, 500, labels.BACKGROUND_INDEX + 1, 1600):
            assert ours.class_token_ids(c, lang) == ref.class_token_ids(c,
                                                                        lang)
    assert labels.BACKGROUND_INDEX == jax_labels.BACKGROUND_INDEX
    for lang in labels.LANGS:
        assert labels.label_words(lang) == jax_labels.label_words(lang)
    full = (labels.LabelVocab(tokenize=labels.hash_tokenize),
            jax_labels.LabelVocab(tokenize=jax_labels.hash_tokenize))
    assert np.array_equal(full[0].valid_ids, full[1].valid_ids)
    soft = np.random.default_rng(0).dirichlet(np.ones(1601) * 0.05, 3)
    np.testing.assert_array_equal(full[0].project_soft_labels(soft),
                                  full[1].project_soft_labels(soft))


def test_synth_pretrain_corpus_matches_reference_synth_corpus(tmp_path):
    """The in-memory corpus holds what uc2_tpu/data/synth.py writes to its
    stores from the same seed: records, region features, boxes and soft
    labels."""
    from uc2_tpu.data.store import StoreReader
    from uc2_tpu.data.synth import synth_corpus
    kw = dict(CORPUS, max_bb=12)
    paths = synth_corpus(str(tmp_path), seed=7, paired=True, compress=False,
                         **kw)
    txt_db, img_db = synth_pretrain_corpus(7, **kw)
    txts = StoreReader(os.path.join(paths["txt_db"], "txt.u2s"))
    imgs = StoreReader(os.path.join(paths["img_db"], "feat.u2s"))
    assert list(img_db.name2nbb) == list(imgs["__keys__"])
    for name, (feat, bb7) in img_db.feats.items():
        rec = imgs[name]
        assert np.array_equal(feat, np.asarray(rec["features"]))
        assert np.array_equal(bb7[:, :6], np.asarray(rec["norm_bb"]))
        assert np.array_equal(img_db.get_dump(name)["soft_labels"],
                              np.asarray(rec["soft_labels"]))
    for tid in txt_db.ids:
        want = txts[tid]
        got = txt_db[tid]
        assert set(got) == set(want)
        for k in want:
            assert got[k] == want[k], k
    import json
    with open(os.path.join(paths["txt_db"], "meta.json")) as f:
        meta = json.load(f)
    assert (txt_db.mask, list(txt_db.v_range)) == (meta["MASK"],
                                                    meta["v_range"])
    with open(os.path.join(paths["txt_db"], "id2len.json")) as f:
        assert txt_db.id2len == json.load(f)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("task", ["itm", "mlm", "vmlm", "tlm"])
def test_datasets_and_collate_match_reference(corpus, vocabs, task):
    """get_example over every text after new_epoch (itm), then the
    collated batch, bit for bit."""
    ours = _datasets(datasets, vocabs[0], *corpus)[task]
    ref = _datasets(jax_datasets, vocabs[1], *corpus)[task]
    assert ours.lens == ref.lens and ours.txt_lens == ref.txt_lens
    got, want = _examples(ours, 3), _examples(ref, 3)
    if task == "itm":
        assert ours.train_imgs == ref.train_imgs
        assert np.array_equal(ours.labels, ref.labels)
        assert ours.lens == ref.lens
    for g, w in zip(got, want):
        _assert_same(g, w)
    M = type(ours).slot_budget(LT, NB) if task != "itm" else 0
    assert M == type(ref).slot_budget(LT, NB)
    spec = collate.BucketSpec(LT, NB, len(got) + 1, M)
    _assert_same(collate.collate_batch(got, spec),
                 jax_collate.collate_batch(want, jax_collate.BucketSpec(
                     LT, NB, len(got) + 1, M)))


def test_default_buckets_match_reference():
    for kw in ({}, dict(max_txt_len=40, max_bb=50, tokens_per_batch=4096)):
        got = collate.default_buckets(**kw)
        want = jax_collate.default_buckets(**kw)
        assert [(s.txt_len, s.num_bb, s.batch_size, s.max_masked, s.joint_len)
                for s in got] == [(s.txt_len, s.num_bb, s.batch_size,
                                   s.max_masked, s.joint_len) for s in want]
