"""The pretraining objectives beyond the mix of config/uc2_pretrain.json
(tlm-ni with co-masking, mmxlm, vmlm-soft, mmxlm-soft, mrfr, mrm-nce, mrc,
mrc-kl, itm-ot in both reductions, itm on hard negatives) in uc2_torch
against the reference package at fp32 on the CPU, dropout 0, all at
rtol = atol = 1e-4 unless a test says otherwise:

* each task's loss, metrics and every gradient through ``make_loss_fn``
  under "pallas-train" with and without UC2_FFN_TRAIN=1 (the reference
  then runs its Pallas FFN kernel in interpret mode, the port the
  kernels' plain versions);
* each task's ``eval_step`` against the reference's ``make_eval_step``;
* IPOT (``cost_matrix_cosine``, ``ipot``, ``optimal_transport_dist`` and
  its gradients) against ``uc2_tpu.models.ot`` on padded inputs;
* each new dataset's examples and collated batch bit for bit from the
  same generator, with ``ItmHardNegDataset``'s per-epoch lengths and
  ``MrmNceDataset``'s negative pool;
* three adam and three adamax updates against the reference's optax
  chain;
* the label vocabulary's refusal of a tokenizer without its vocabulary.

Both packages read one in-memory corpus (``uc2_torch/data/memdb.py``)
with an 11-class detector vocabulary."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import collate as jax_collate
from uc2_tpu.data import datasets as jax_datasets
from uc2_tpu.data import labels as jax_labels
from uc2_tpu.models import ot as jax_ot
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.training import optim as jax_optim
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, datasets, labels
from uc2_torch.data.memdb import synth_pretrain_corpus
from uc2_torch.models import ot
from uc2_torch.models.convert import params_from_jax, params_to_jax
from uc2_torch.models.pretraining import UC2ForPretraining, gather_slots
from uc2_torch.ops import ffn_train
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training import optim
from uc2_torch.training.step import eval_step, make_loss_fn

VOCAB = 1000
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
            use_pallas_attention="pallas-train")
TOL = dict(rtol=1e-4, atol=1e-4)
LT, NB, B = 24, 8, 4
CORPUS = dict(n_imgs=6, txt_per_img=2, vocab=VOCAB, img_dim=32, min_bb=3,
              max_bb=NB, max_words=4, n_classes=11)
# 40% of the regions masked, so that every batch has region slots
MRM_PROB = 0.4
WORDS = {lang: [f"{lang}{i}" for i in range(10)] for lang in ("en", "de")}
# task -> (reference task, make_loss_fn keywords)
TASKS = {"tlm-ni": ("tlm-ni", {}), "mmxlm": ("mmxlm", {}),
         "vmlm-soft": ("vmlm-soft", {}), "mmxlm-soft": ("mmxlm-soft", {}),
         "mrfr": ("mrfr", {}), "mrm-nce": ("mrm-nce", {}),
         "mrc": ("mrc", {}), "mrc-kl": ("mrc-kl", {}),
         "itm-ot": ("itm-ot", dict(itm_ot_lambda=0.1)),
         "itm-ot-pos": ("itm-ot", dict(itm_ot_lambda=0.1, ot_pos_only=True)),
         "itm-hard": ("itm", {})}


def _tok(word):
    return labels.hash_tokenize(word, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def corpus():
    return synth_pretrain_corpus(5, **CORPUS)


@pytest.fixture(scope="module")
def vocabs():
    """Each package's label vocabulary of the 11 classes, hashed into the
    tiny vocabulary."""
    return (labels.LabelVocab(tokenize=_tok, words=WORDS),
            jax_labels.LabelVocab(tokenize=_tok, words=WORDS))


@pytest.fixture(scope="module")
def params():
    """A reference parameter tree (the port's initialisation, converted:
    the reference's eager init takes ~20 s), moved away from init."""
    tree = params_to_jax(UC2ForPretraining(UC2Config(**TINY), device="cpu",
                                           seed=0).state_dict())
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


def _dataset(pkg, vocab, txt_db, img_db, task):
    """The dataset ``pkg`` (uc2_torch.data.datasets or the reference's)
    builds for ``task``, as pretrain.py's build_datasets does."""
    kind = task.split("-")[0] if task.startswith("itm") else task
    if kind == "itm":
        cls_ = pkg.ItmHardNegDataset if task == "itm-hard" else pkg.ItmDataset
        return cls_(txt_db, img_db, 0.5)
    return {
        "tlm-ni": lambda: pkg.TlmDataset(txt_db, img_db, "mix",
                                         text_only=True),
        "mmxlm": lambda: pkg.MmxlmDataset(txt_db, img_db, MRM_PROB, vocab,
                                          "de"),
        "vmlm-soft": lambda: pkg.VmlmSoftDataset(txt_db, img_db, MRM_PROB,
                                                 vocab),
        "mmxlm-soft": lambda: pkg.MmxlmSoftDataset(txt_db, img_db, MRM_PROB,
                                                   vocab),
        "mrfr": lambda: pkg.MrfrDataset(txt_db, img_db, MRM_PROB),
        "mrm-nce": lambda: pkg.MrmNceDataset(txt_db, img_db, MRM_PROB,
                                             neg_size=6),
        "mrc": lambda: pkg.MrcDataset(txt_db, img_db, MRM_PROB),
        "mrc-kl": lambda: pkg.MrcDataset(txt_db, img_db, MRM_PROB),
    }[kind]()


def _examples(ds, seed):
    rng = np.random.default_rng(seed)
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    return [ds.get_example(i, rng) for i in range(len(ds))]


def _spec(pkg, ds, n):
    return pkg.BucketSpec(LT, NB, n, type(ds).slot_budget(LT, NB))


def _batch(corpus, vocabs, task, seed=1):
    ds = _dataset(datasets, vocabs[0], *corpus, task)
    return ds.collate(_examples(ds, seed)[:B], _spec(collate, ds, B))


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


# ------------------------------------------------------ losses and grads
@pytest.fixture(scope="module")
def reference(params, corpus, vocabs):
    """task -> the reference's (loss, metrics, gradients) on the task's
    batch, its Pallas FFN kernel (interpret mode) in every layer
    (UC2_FFN_TRAIN=1); computed once a task, for both of the port's
    routes: at dropout 0 the FFN kernel and the eager FFN compute one
    function."""
    cache = {}

    def get(task):
        if task not in cache:
            ref_task, kw = TASKS[task]
            jm = JaxPretraining(JaxConfig(**TINY))
            fn = jax.jit(jax.value_and_grad(jax_step.make_loss_fn(
                jm, ref_task, valid_ids=vocabs[1].valid_ids, **kw),
                has_aux=True))
            mp = pytest.MonkeyPatch()
            mp.setenv("UC2_FFN_TRAIN", "1")
            try:
                cache[task] = fn(params, _jax(_batch(corpus, vocabs, task)),
                                 jax.random.PRNGKey(1))
            finally:
                mp.undo()
        return cache[task]
    return get


@pytest.mark.parametrize("ffn_kernels", [True, False])
@pytest.mark.parametrize("task", list(TASKS))
def test_loss_and_grads_match_reference(params, corpus, vocabs, reference,
                                        monkeypatch, task, ffn_kernels):
    """The loss, every metric the reference reports and every gradient, at
    1e-4; with UC2_FFN_TRAIN=1 the port's training FFN block runs in each
    layer, without it the eager FFN."""
    if ffn_kernels:
        monkeypatch.setenv("UC2_FFN_TRAIN", "1")
    else:
        monkeypatch.delenv("UC2_FFN_TRAIN", raising=False)
    ref_task, kw = TASKS[task]
    b = _batch(corpus, vocabs, task)
    assert b.get("masked_weight", np.ones(1)).sum() > 0
    valid_ids = vocabs[0].valid_ids
    (want, wm), wgrads = reference(task)
    model = _port(params)
    calls = []
    real = ffn_train.fused_ffn_block_train_bwd
    monkeypatch.setattr(ffn_train, "fused_ffn_block_train_bwd",
                        lambda *a: calls.append(1) or real(*a))
    loss, m = make_loss_fn(ref_task, valid_ids=valid_ids, **kw)(
        model, _torch(b), DropoutRng(1, "cpu"))
    loss.backward()
    assert len(calls) == (TINY["num_hidden_layers"] if ffn_kernels else 0)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    assert set(m) == set(wm)
    for k in wm:
        np.testing.assert_allclose(m[k].item(), float(wm[k]), err_msg=k,
                                   **TOL)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    _assert_trees_close(grads, wgrads, **TOL)


@pytest.mark.parametrize("task", list(TASKS))
def test_eval_step_matches_reference(params, corpus, vocabs, task):
    """Every sum ``eval_step`` returns, against ``make_eval_step``, at 1e-4,
    on a batch with a padded trailing row."""
    ref_task, _ = TASKS[task]
    ds = _dataset(datasets, vocabs[0], *corpus, task)
    b = ds.collate(_examples(ds, 2)[:B - 1], _spec(collate, ds, B))
    want = jax.jit(jax_step.make_eval_step(
        JaxPretraining(JaxConfig(**TINY)), ref_task,
        valid_ids=vocabs[1].valid_ids))(params, _jax(b))
    got = eval_step(_port(params), _torch(b), ref_task,
                    valid_ids=vocabs[0].valid_ids)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k,
                                   **TOL)


def test_mrm_nce_keeps_padded_slots_own_columns(params, corpus, vocabs):
    """mrm-nce's logits: padded slots' target columns carry -1e4 for every
    other slot, each slot's own column its own score (pred . target /
    temp), the negatives' columns no mask. (The loss and gradients built
    on them are held to the reference above.)"""
    b = _batch(corpus, vocabs, "mrm-nce")
    model = _port(params)
    got = model.forward_mrm_nce(_torch(b), compute_loss=False).detach()
    w = b["masked_weight"].reshape(-1)
    pad = np.flatnonzero(w == 0)
    n_neg = b["neg_feats"].shape[0]
    assert pad.size and got.shape == (w.size, w.size + n_neg)
    g = got.numpy()
    others = [i for i in range(w.size) if i != pad[0]]
    assert (g[others, pad[0]] < -5e3).all() and g[pad[0], pad[0]] > -5e3
    assert (g[:, w.size:] > -5e3).all()
    tb = _torch(b)
    seq, _ = model._encode(tb, True, None, img_masks=tb["img_masks"])
    pred = model.nce_output(gather_slots(seq, tb["masked_pos"]))
    pred = pred.reshape(w.size, -1).detach().numpy()
    own = (pred * b["feat_targets"].reshape(w.size, -1).astype(
        np.float32)).sum(-1)
    np.testing.assert_allclose(np.diag(g), own, **TOL)


# ------------------------------------------------------------------- OT
def _ot_inputs(seed, dtype=np.float32):
    """Text [3, 7, 16] and image [3, 5, 16] blocks; row 0 has no padding,
    rows 1 and 2 pad text and regions."""
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((3, 7, 16)).astype(dtype)
    img = rng.standard_normal((3, 5, 16)).astype(dtype)
    tpad = np.zeros((3, 7), bool)
    ipad = np.zeros((3, 5), bool)
    tpad[1, 4:] = tpad[2, 6:] = True
    ipad[1, 3:] = ipad[2, 1:] = True
    return txt, img, tpad, ipad


@pytest.mark.parametrize("seed", [0, 1])
def test_ot_matches_reference(seed):
    """cost_matrix_cosine, the plan from ipot, the distance and its
    gradients with respect to both blocks, at 1e-4."""
    txt, img, tpad, ipad = _ot_inputs(seed)
    np.testing.assert_allclose(
        ot.cost_matrix_cosine(torch.from_numpy(txt),
                              torch.from_numpy(img)).numpy(),
        np.asarray(jax_ot.cost_matrix_cosine(txt, img)), **TOL)
    cost = np.asarray(jax_ot.cost_matrix_cosine(txt, img))
    joint = tpad[:, :, None] | ipad[:, None, :]
    cost = np.where(joint, 0.0, cost).astype(np.float32)
    tl = (7 - tpad.sum(1)).astype(np.float32)
    il = (5 - ipad.sum(1)).astype(np.float32)
    want_t = jax.jit(jax_ot.ipot)(cost, tl, tpad, il, ipad, joint)
    got_t = ot.ipot(*(torch.from_numpy(a) for a in (cost, tl, tpad, il, ipad,
                                                    joint)))
    assert got_t.shape == (3, 5, 7)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)

    def jax_fn(x, y):
        d = jax_ot.optimal_transport_dist(x, y, tpad, ipad)
        return (d * jnp.arange(1.0, 4.0)).sum(), d

    (_, want), (wdx, wdy) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(txt, img)
    x = torch.from_numpy(txt).requires_grad_(True)
    y = torch.from_numpy(img).requires_grad_(True)
    got = ot.optimal_transport_dist(x, y, torch.from_numpy(tpad),
                                    torch.from_numpy(ipad))
    (got * torch.arange(1.0, 4.0)).sum().backward()
    assert np.isfinite(got.detach().numpy()).all()
    for a, w in ((got, want), (x.grad, wdx), (y.grad, wdy)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), **TOL)


def test_ot_runs_in_fp32_from_bf16_inputs():
    """bf16 blocks give the fp32 distance of their fp32 values (the 1e4
    pad masks overflow bf16's products), within 1e-4 of the reference's."""
    txt, img, tpad, ipad = _ot_inputs(3)
    to = lambda a: torch.from_numpy(a).bfloat16()       # noqa: E731
    got = ot.optimal_transport_dist(to(txt), to(img), torch.from_numpy(tpad),
                                    torch.from_numpy(ipad))
    want = jax_ot.optimal_transport_dist(
        jnp.asarray(txt).astype(jnp.bfloat16),
        jnp.asarray(img).astype(jnp.bfloat16), tpad, ipad)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ data
def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("task", [t for t in TASKS if t != "itm-ot-pos"])
def test_datasets_and_collate_match_reference(corpus, vocabs, task):
    """get_example over every text after new_epoch (itm), then the
    collated batch (through each dataset's own collate, which merges the
    soft targets and the negative pool), bit for bit."""
    ours = _dataset(datasets, vocabs[0], *corpus, task)
    ref = _dataset(jax_datasets, vocabs[1], *corpus, task)
    assert type(ours).slot_budget(LT, NB) == type(ref).slot_budget(LT, NB)
    assert tuple(ours.slot_target_keys) == tuple(ref.slot_target_keys)
    got, want = _examples(ours, 3), _examples(ref, 3)
    assert ours.lens == ref.lens and ours.txt_lens == ref.txt_lens
    for g, w in zip(got, want):
        _assert_same(g, w)
    n = len(got)
    _assert_same(ours.collate(got, _spec(collate, ours, n + 1)),
                 ref.collate(want, _spec(jax_collate, ref, n + 1)))


def test_hard_negative_epochs_track_the_swaps(corpus, vocabs):
    """ItmHardNegDataset over three epochs: the images, captions, labels,
    text lengths and joint lengths of each epoch equal the reference's,
    and the lengths are those of the swapped captions and images."""
    txt_db, img_db = corpus
    ours = datasets.ItmHardNegDataset(txt_db, img_db, 0.5)
    ref = jax_datasets.ItmHardNegDataset(txt_db, img_db, 0.5)
    for epoch in range(3):
        ours.new_epoch(np.random.default_rng(epoch))
        ref.new_epoch(np.random.default_rng(epoch))
        assert ours.train_imgs == ref.train_imgs
        assert ours.train_raw_ids == ref.train_raw_ids
        assert np.array_equal(ours.labels, ref.labels)
        assert ours.txt_lens == ref.txt_lens and ours.lens == ref.lens
        assert ours.txt_lens == [len(r) for r in ours.train_raw_ids]
        assert ours.lens == [len(r) + img_db.name2nbb[f] for r, f in
                             zip(ours.train_raw_ids, ours.train_imgs)]
    assert (ours.labels == 0).any()


def test_mrm_nce_pool_matches_reference(corpus, vocabs):
    """The negative sampler's draws and the batch's shared pool (the first
    example's rows, then 8 of each other's), bit for bit; no example
    draws its own image."""
    txt_db, img_db = corpus
    ours = datasets.NegativeImageSampler(img_db, 11)
    ref = jax_datasets.NegativeImageSampler(img_db, 11)
    for seed in range(3):
        own = ours.fnames[seed]
        got = ours.sample(np.random.default_rng(seed), own)
        assert got.shape == (11, CORPUS["img_dim"])
        assert np.array_equal(
            got, ref.sample(np.random.default_rng(seed), own))
    ds = _dataset(datasets, vocabs[0], *corpus, "mrm-nce")
    ex = _examples(ds, 4)[:3]
    pool = ds.collate(ex, _spec(collate, ds, 3))["neg_feats"]
    assert pool.shape == (6 + 2 * 6, CORPUS["img_dim"])
    assert np.array_equal(pool[:6], ex[0]["neg_feats"])


def test_collate_keeps_fp16_targets_and_labels_bare_regions(corpus):
    """Region targets keep fp16; a region slot with targets but no
    ``img_txt_labels`` gets label 0; ``txt_*`` targets align with the text
    slots, before the region slots."""
    feat = np.arange(12, dtype=np.float16).reshape(3, 4)
    ex = {"input_ids": np.array([0, 5, 6, 2]),
          "txt_labels": np.array([-1, 7, -1, -1]),
          "img_feat": feat, "img_pos_feat": np.zeros((3, 7), np.float32),
          "img_masks": np.array([False, True, True]),
          "feat_targets": feat, "txt_soft": np.eye(4, dtype=np.float32)}
    spec = collate.BucketSpec(6, 4, 2, 4)
    keys = ("txt_soft", "feat_targets")
    got = collate.collate_batch([ex], spec, slot_target_keys=keys)
    _assert_same(got, jax_collate.collate_batch(
        [ex], jax_collate.BucketSpec(6, 4, 2, 4), slot_target_keys=keys))
    assert got["feat_targets"].dtype == np.float16
    assert got["masked_pos"][0].tolist() == [1, 7, 8, 0]
    assert got["txt_labels"][0].tolist() == [7, 0, 0, 0]
    assert np.array_equal(got["feat_targets"][0, 1:3], feat[1:3])
    assert got["txt_soft"][0, 0].tolist() == [0, 1, 0, 0]


def test_label_vocab_refuses_a_tokenizer_without_its_vocabulary(
        monkeypatch):
    """A tokenizer whose files lack the vocabulary maps every word to its
    unknown token; the label vocabulary then takes the hash ids (where
    the reference, whose private tokenizer call such a release lacks,
    takes them too) instead of one id for every class."""
    import sys
    import types

    class Tok:
        unk_token_id = 3

        @classmethod
        def from_pretrained(cls, name, local_files_only):
            return cls()

        def tokenize(self, word):
            return ["\u2581" + word]

        def convert_tokens_to_ids(self, tokens):
            return [3] * len(tokens)

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(XLMRobertaTokenizer=Tok))
    assert labels.try_xlmr_tokenizer() is None
    vocab = labels.LabelVocab(words=WORDS)
    assert vocab.source == "hash" and len(vocab.valid_ids) > 10


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name", ["adam", "adamax"])
def test_adam_and_adamax_match_the_reference_chain(params, name):
    """Three updates from the same gradients (clip 1.0, active at the
    first; warm-up schedule; decay 0.01 on the decayed group): every
    parameter and both moments after each, at 1e-4 (1e-6 absolute for the
    moments)."""
    model = _port(params)
    opt = optim.build_optimizer(model, optim.warmup_linear(1e-2, 2, 10),
                                grad_norm=1.0, optim=name)
    tx = jax_optim.build_optimizer(params, jax_optim.warmup_linear(
        1e-2, 2, 10), grad_norm=1.0, optim=name)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(5)
    mask = optim.decay_mask(n for n, _ in model.named_parameters())
    # the torch state's order: the decayed group, then the other
    names = ([n for n in mask if mask[n]] + [n for n in mask if not mask[n]])
    for it in range(3):
        gtree = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32)
            * (0.1 if it else 1.0), params)
        updates, state = update(gtree, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        gt = params_from_jax(gtree)
        for n, p in model.named_parameters():
            p.grad = gt[n].clone()
        opt.step()
        _assert_trees_close(dict(model.named_parameters()), jparams, **TOL)
    # optax's moments: chain(clip, chain(scale_by_*, decay, lr)) states
    mom = state[1][0]
    st = opt.state_dict()["state"]["state"]
    second = "exp_avg_sq" if name == "adam" else "exp_inf"
    for i, (want_mu, want_nu) in enumerate(((mom.mu, "mu"), (mom.nu, "nu"))):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_mu))
        key = "exp_avg" if i == 0 else second
        for j, n in enumerate(names):
            np.testing.assert_allclose(st[j][key].numpy(), want[n].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{want_nu} {n}")
    assert opt.count == 3 and opt.state_dict()["optim"] == name


def test_optimizer_state_round_trips_for_each_algorithm(params):
    """state_dict / load_state_dict carry the count and the moments, so a
    fourth update after a reload equals one without it; a state of another
    algorithm is refused."""
    for name in ("adam", "adamax", "adamw"):
        runs = []
        for reload in (False, True):
            model = _port(params)
            opt = optim.build_optimizer(model, optim.constant(1e-3),
                                        optim=name)
            for it in range(4):
                if reload and it == 3:
                    sd = opt.state_dict()
                    opt = optim.build_optimizer(model, optim.constant(1e-3),
                                                optim=name)
                    opt.load_state_dict(sd)
                gen = torch.Generator().manual_seed(it)
                for p in model.parameters():
                    p.grad = torch.randn(p.shape, generator=gen)
                opt.step()
            runs.append([p.detach().clone() for p in model.parameters()])
        assert all(torch.equal(a, b) for a, b in zip(*runs)), name
    other = optim.build_optimizer(_port(params), optim.constant(1e-3),
                                  optim="adamax")
    with pytest.raises(ValueError, match="adamax"):
        optim.build_optimizer(_port(params), optim.constant(1e-3)
                              ).load_state_dict(other.state_dict())
