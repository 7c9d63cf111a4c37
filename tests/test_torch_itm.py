"""The retrieval finetuning modules of uc2_torch against the reference
package at a tiny config (hidden 32, two layers, fp32) on the CPU:

* the rank datasets (``ItmRankDataset``, ``ItmRankHardNegDataset`` with
  its random fallback, mined pools in both formats, a pool file),
  ``ConcatDataset`` and ``ItmEvalDataset`` give the reference's groups bit
  for bit, and a ``TaskLoader`` over them its stacked batches;
* the rank loss and every gradient at dropout 0 within 1e-4 under "xla",
  "pallas" (the port #1's plain version with its eager-recompute backward;
  the reference its Pallas kernel in interpret mode) and "pallas-train"
  (the port #5/#6's plain versions; the reference ``flash_attention_train``
  in interpret mode), and ``train_step`` on a stacked batch as the mean
  over its micro-batches;
* ``pretrained_mask`` and ``build_xlmr_optimizer`` (adamw, adamax) against
  the reference's mask and optax's two-rate chain over three updates;
* ``init_rank_from_itm`` exactly;
* ``quick_validate`` and ``mine_hard_negatives``: the ranking on the
  reference's score matrix bit for bit, and both on the port's own
  matrix against the reference's (matrices within 1e-4).

Stores are written by the port's ``synth_corpus`` (byte for byte the
reference's) and each package reads them with its own databases."""

import json

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
from uc2_tpu.evalu import retrieval as jax_retrieval
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.ops import attention as jax_attention
from uc2_tpu.training import optim as jax_optim
from uc2_torch.config import UC2Config
from uc2_torch.data import datasets, db, loader
from uc2_torch.data.collate import BucketSpec
from uc2_torch.data.synth import synth_corpus
from uc2_torch.evalu import retrieval
from uc2_torch.models import convert
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.ops import flash_attention as port_fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training import optim
from uc2_torch.training.step import make_loss_fn, train_step

TINY = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, img_dim=16, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
CORPUS = dict(txt_per_img=2, min_bb=4, max_bb=8, img_dim=16, n_classes=11,
              max_words=6, vocab=512)
TXT_LEN, NUM_BB = 18, 8


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("itm_stores")
    return [synth_corpus(str(root / f"c{k}"), n_imgs=n, seed=9 + k, **CORPUS)
            for k, n in enumerate((10, 8))]


def _dbs(pkg_db, store):
    return (pkg_db.TxtTokDb(store["txt_db"], max_txt_len=16),
            pkg_db.DetectFeatDb(store["img_db"], 0.2, NUM_BB, 4, 36))


@pytest.fixture(scope="module")
def both_dbs(stores):
    """[(port (txt, img), reference (txt, img))] a store."""
    return [(_dbs(db, s), _dbs(jax_db, s)) for s in stores]


def _assert_examples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def _groups(ds, seed, n=None):
    rng = np.random.default_rng(seed)
    return [e for i in range(n or len(ds)) for e in ds.get_example(i, rng)]


def _pools(txt_db, k=3):
    """Hard pools in the mined format, drawn from a seed."""
    rng = np.random.default_rng(0)
    imgs = sorted(txt_db.img2txts)
    ids = list(txt_db.ids)
    return {"txt2hardimgs": {t: [imgs[j] for j in rng.choice(
                len(imgs), k, replace=False)] for t in ids},
            "img2hardtxts": {im: [ids[j] for j in rng.choice(
                len(ids), k, replace=False)] for im in imgs}}


# ----------------------------------------------------------------- datasets
@pytest.mark.parametrize("neg", [1, 2])
def test_rank_dataset_groups_match_reference(both_dbs, neg):
    (port, ref), _ = both_dbs
    got = datasets.ItmRankDataset(*port, neg)
    want = jax_datasets.ItmRankDataset(*ref, neg)
    assert got.sample_size == want.sample_size == 1 + 2 * neg
    assert got.lens == want.lens and got.txt_lens == want.txt_lens
    assert got.all_imgs == want.all_imgs and got.all_txts == want.all_txts
    _assert_examples_equal(_groups(got, 3), _groups(want, 3))


@pytest.mark.parametrize("pools", ["fallback", "mined", "legacy", "file"])
def test_hard_negative_groups_match_reference(both_dbs, tmp_path, pools):
    """Hard slots from the random fallback (no pools yet), from mined
    pools in both directions, from the legacy flat text -> images format
    and from a pool file."""
    (port, ref), _ = both_dbs
    got = datasets.ItmRankHardNegDataset(*port, 1, 2)
    want = jax_datasets.ItmRankHardNegDataset(*ref, 1, 2)
    assert got.sample_size == want.sample_size == 7
    hard = _pools(port[0])
    src = {"fallback": None, "mined": hard,
           "legacy": hard["txt2hardimgs"]}.get(pools)
    if pools == "file":
        src = str(tmp_path / "hard_negs_0.json")
        with open(src, "w") as f:
            json.dump(hard, f)
    if src is not None:
        got.reload_hard_negs(src)
        want.reload_hard_negs(src)
        assert got.txt2hardimgs == want.txt2hardimgs
        assert got.img2hardtxts == want.img2hardtxts
    _assert_examples_equal(_groups(got, 4), _groups(want, 4))


def test_concat_and_eval_datasets_match_reference(both_dbs):
    (p0, r0), (p1, r1) = both_dbs
    got = datasets.ConcatDataset([datasets.ItmRankHardNegDataset(*p0, 1, 1),
                                  datasets.ItmRankHardNegDataset(*p1, 1, 1)])
    want = jax_datasets.ConcatDataset([
        jax_datasets.ItmRankHardNegDataset(*r0, 1, 1),
        jax_datasets.ItmRankHardNegDataset(*r1, 1, 1)])
    assert len(got) == len(want) == 36
    assert got.lens == want.lens and got.txt_lens == want.txt_lens
    _assert_examples_equal(_groups(got, 6), _groups(want, 6))
    for port, ref in both_dbs:
        ev, jev = datasets.ItmEvalDataset(*port), jax_datasets.ItmEvalDataset(
            *ref)
        # the reference's order, with ties of region count broken by name
        nbb = ref[1].name2nbb
        assert ev.all_img_ids == sorted(jev.all_img_ids,
                                        key=lambda x: (nbb[x], x))
        part = datasets.ItmEvalDataset(*port, ev.ids[:5])
        assert part.ids == ev.ids[:5]
        assert part.all_img_ids == [im for im in ev.all_img_ids
                                    if im in {ev.txt2img[t]
                                              for t in ev.ids[:5]}]
        for i in range(len(ev)):
            assert np.array_equal(ev.text_example(i), jev.text_example(i))


def test_loader_stacks_the_reference_groups(both_dbs):
    """A TaskLoader over two databases' hard-negative datasets (half of
    them with pools): three stacked windows of two micro-batches of four
    groups, every array bit for bit."""
    def build(pkg, ldr, spec, dbs):
        subs = [pkg.ItmRankHardNegDataset(*d, 1, 1) for d in dbs]
        subs[0].reload_hard_negs(_pools(dbs[0][0]))
        return ldr.TaskLoader("itm-rank", pkg.ConcatDataset(subs),
                              [spec(TXT_LEN, NUM_BB, 4, 0)], seed=7)
    got = build(datasets, loader, BucketSpec, [p for p, _ in both_dbs])
    want = build(jax_datasets, jax_loader, JaxBucketSpec,
                 [r for _, r in both_dbs])
    for _ in range(3):
        g, w = got.next_stacked(2), want.next_stacked(2)
        assert g["input_ids"].shape[:2] == (2, 20)
        keys = {k for k in w if not k.startswith("_")} - {"sample_size"}
        assert keys <= set(g)
        for k in keys:
            assert np.array_equal(g[k], np.asarray(w[k])), k
            assert g[k].dtype == np.asarray(w[k]).dtype, k


# ------------------------------------------------------- the rank loss
@pytest.fixture(scope="module")
def params():
    """Reference retrieval parameters, moved away from init so that the
    scores spread over the sigmoid's slope."""
    tree = JaxRetrieval(JaxConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2, tree)


def _rank_batch(both_dbs, seed=2, groups=4):
    (port, _), _ = both_dbs
    ds = datasets.ItmRankDataset(*port, 1)
    rng = np.random.default_rng(seed)
    ex = [e for i in range(groups) for e in ds.get_example(i, rng)]
    b = ds.collate(ex, BucketSpec(TXT_LEN, NUM_BB, len(ex), 0))
    return {k: v for k, v in b.items() if k not in ("targets", "_bucket")}


def _ref_loss_and_grads(params, cfg, batch, S, kernel):
    jm = JaxRetrieval(JaxConfig(**cfg))

    def loss(p, b):
        return jnp.mean(jm.rank_loss(p, b, S, deterministic=False,
                                     rngs={"dropout": jax.random.PRNGKey(1)}))
    fn = jax.jit(jax.value_and_grad(loss))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if not kernel:
        return fn(params, jb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "_on_tpu", lambda: True)
        with pltpu.force_tpu_interpret_mode():
            return fn(params, jb)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas-train"])
def test_rank_loss_and_grads_match_reference(params, both_dbs, monkeypatch,
                                            impl):
    cfg = dict(TINY, use_pallas_attention=impl)
    batch = _rank_batch(both_dbs)
    want, wgrads = _ref_loss_and_grads(params, cfg, batch, 3,
                                       kernel=impl != "xla")
    model = UC2ForImageTextRetrieval(UC2Config(**cfg), device="cpu",
                                     params=params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    elems = model.rank_loss(tb, 3, deterministic=False,
                            rng=DropoutRng(1, "cpu"))
    assert elems.shape == (4, 2)
    # the kernel routes run their kernel's plain version in every layer
    calls = []
    kernel = {"pallas": "flash_attention",
              "pallas-train": "flash_attention_train"}.get(impl)
    if kernel:
        real = getattr(port_fa, kernel)
        monkeypatch.setattr(port_fa, kernel,
                            lambda *a: calls.append(1) or real(*a))
    loss, m = make_loss_fn("itm-rank", sample_size=3)(
        model, tb, DropoutRng(1, "cpu"))
    assert len(calls) == (TINY["num_hidden_layers"] if kernel else 0)
    assert torch.equal(loss, elems.mean()) and m["n_units"].item() == 8
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_g = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            wgrads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    # the port's image embeddings always hold the (unused) MRM mask
    assert set(got_g) - set(want_g) == {
        "roberta.img_embeddings.mask_embedding"}
    for n in want_g:
        g = got_g[n] if got_g[n] is not None else torch.zeros_like(want_g[n])
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), err_msg=n,
                                   **TOL)
    # the scoring path of the same model: no graph
    assert not model.scores(tb).requires_grad


def test_stacked_rank_step_is_the_mean_of_its_micro_batches(params,
                                                            both_dbs):
    """train_step on a stacked [2, rows, ...] batch: the loss and the
    update are those of the mean of the two micro-batches' gradients."""
    cfg = UC2Config(**TINY)
    micro = [_rank_batch(both_dbs, seed=s) for s in (2, 3)]
    stacked = {k: torch.from_numpy(np.stack([m[k] for m in micro]))
               for k in micro[0]}
    losses, grads = [], []
    for m in micro:
        model = UC2ForImageTextRetrieval(cfg, device="cpu", params=params)
        loss, _ = make_loss_fn("itm-rank", sample_size=3)(
            model, {k: torch.from_numpy(v) for k, v in m.items()},
            DropoutRng(1, "cpu"))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    model = UC2ForImageTextRetrieval(cfg, device="cpu", params=params)
    opt = optim.build_optimizer(model, optim.constant(0.0), grad_norm=-1.0)
    met = train_step(model, opt, stacked, DropoutRng(1, "cpu"),
                     task="itm-rank", sample_size=3)
    np.testing.assert_allclose(met["loss"].item(), np.mean(losses),
                               rtol=1e-6)
    for n, p in model.named_parameters():
        if grads[0][n] is None:       # the unused MRM mask: zeros
            assert not p.grad.any(), n
            continue
        torch.testing.assert_close(p.grad, (grads[0][n] + grads[1][n]) / 2,
                                   rtol=1e-5, atol=1e-7, msg=n)
    with pytest.raises(ValueError, match="sample_size"):
        make_loss_fn("itm-rank")


# ------------------------------------------------------------- optimizer
def _names_of(tree_mask):
    """{port name: bool} of a reference mask tree."""
    return {k: bool(v.item()) for k, v in convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree_mask)).items()}


@pytest.mark.parametrize("load_layer", [None, 0, 1])
def test_pretrained_mask_matches_reference(params, load_layer):
    want = _names_of(jax_optim.pretrained_mask(params, load_layer))
    model = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu",
                                     params=params)
    got = optim.pretrained_mask((n for n, _ in model.named_parameters()),
                                load_layer)
    assert not got.pop("roberta.img_embeddings.mask_embedding")
    assert got == want
    assert got["roberta.embeddings.word_embeddings.weight"]
    assert not got["roberta.img_embeddings.img_linear.weight"]
    assert not got["roberta.token_type_embeddings.weight"]
    assert got["roberta.layer.0.attention.qkv.weight"] == (load_layer
                                                           is not None)
    assert got["roberta.layer.1.output_dense.weight"] == (load_layer == 1)


@pytest.mark.parametrize("opt_name", ["adamw", "adamax"])
def test_xlmr_optimizer_matches_optax(params, opt_name):
    """Three updates of build_xlmr_optimizer (load_layer 0, clip 2.0, both
    rates on warm-up-linear schedules) from the same gradients: every
    parameter within 1e-5 of the reference's optax chain."""
    main_fn = jax_optim.get_lr_schedule("linear", 1e-2, 2, 6)
    pre_fn = jax_optim.get_lr_schedule("linear", 1e-3, 2, 6)
    tx = jax_optim.build_xlmr_optimizer(params, main_fn, pre_fn, 0.1,
                                        (0.9, 0.98), grad_norm=2.0,
                                        load_layer=0, optim=opt_name)
    model = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu",
                                     params=params)
    opt = optim.build_xlmr_optimizer(
        model, optim.get_lr_schedule("linear", 1e-2, 2, 6),
        optim.get_lr_schedule("linear", 1e-3, 2, 6), 0.1, (0.9, 0.98),
        grad_norm=2.0, load_layer=0, optim=opt_name)
    assert len(opt.opt.param_groups) == 4
    state = tx.init(params)
    update = jax.jit(tx.update)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                            p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, upd)
        for n, t in convert.params_from_jax(g).items():
            dict(model.named_parameters())[n].grad = t
        opt.step()
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    for n, t in model.named_parameters():
        if n.endswith("mask_embedding"):
            continue
        np.testing.assert_allclose(t.detach().numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_init_rank_from_itm_is_exact(params):
    model = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu",
                                     params=params)
    convert.init_rank_from_itm(model)
    want = jax_convert.init_rank_from_itm(jax.tree_util.tree_map(
        np.copy, params))
    got = convert.params_to_jax(model.state_dict())
    for k in ("kernel", "bias"):
        assert np.array_equal(got["rank_output"]["out"][k],
                              want["rank_output"]["out"][k])
    assert np.array_equal(model.rank_output.out.weight[0].detach().numpy(),
                          params["itm_output"]["out"]["kernel"][:, 1])


# ------------------------------------------------- validation and mining
def test_quick_validate_and_mining_match_reference(params, both_dbs):
    (port, ref), _ = both_dbs
    cfg = dict(TINY, use_pallas_attention=True)
    jm = JaxRetrieval(JaxConfig(**cfg))
    model = UC2ForImageTextRetrieval(UC2Config(**cfg), device="cpu",
                                     params=params)
    # the quick validation's pool: 6 of 10 images, 12 of 20 texts
    kw = dict(n_imgs=6, n_txts=12, batch_size=4)
    want = jax_retrieval.quick_validate(jm, params, *ref, TXT_LEN, NUM_BB,
                                        **kw)
    txt_ids, pool = retrieval.quick_validation_pool(port[0], 6, 12)
    m_ref = jax_retrieval.score_matrix(jm, params, *ref, txt_ids, pool,
                                       TXT_LEN, NUM_BB, 4)
    assert retrieval.pool_ranks(m_ref, txt_ids, pool,
                                port[0].txt2img) == want
    m = retrieval.score_matrix(model, *port, txt_ids, pool, TXT_LEN, NUM_BB,
                               4, device="cpu")
    np.testing.assert_allclose(m, m_ref, **TOL)
    assert retrieval.quick_validate(model, *port, TXT_LEN, NUM_BB,
                                    device="cpu", **kw) == want

    # mining: every text against every image, pools of 3
    hard = jax_retrieval.mine_hard_negatives(jm, params, *ref, TXT_LEN,
                                             NUM_BB, hard_neg_size=3,
                                             batch_size=4)
    txt_ids = list(port[0].ids)
    img_ids = sorted(port[0].img2txts)
    m_ref = jax_retrieval.score_matrix(jm, params, *ref, txt_ids, img_ids,
                                       TXT_LEN, NUM_BB, 4)
    assert retrieval.hard_negative_pools(m_ref, txt_ids, img_ids,
                                         port[0].txt2img, 3) == hard
    got = retrieval.mine_hard_negatives(model, *port, TXT_LEN, NUM_BB,
                                        hard_neg_size=3, batch_size=4,
                                        device="cpu")
    assert got == hard
