"""Long-caption mlm pretraining in uc2_torch against the reference package
on the CPU: kernel #4's plain version against the reference's
``_fwd_pallas`` (Pallas, interpret mode) at L = 419..512, the dispatch
between #1 and #4, the training attention's plain versions at L = 339 and
512 (and the split backward's two parts), the mlm loss and every gradient
at a joint L of 512 on #4's route, the text database's length filter, and
the bucket sampler, the task and meta loaders and the device prefetch bit
for bit; the training forward's plain version at rate 0 against #4's and
both reference kernels; and the encoder's routing under ``UC2_ATTN_V2``
(kernel #7 in every layer of the fused route). Dropout is 0 where values
are compared: the two packages draw different masks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import collate as jax_collate
from uc2_tpu.data import datasets as jax_datasets
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.data import sampler as jax_sampler
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.ops import flash_attention as jax_fa
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, datasets, loader, sampler
from uc2_torch.data.memdb import synth_pretrain_corpus
from uc2_torch.models.convert import params_from_jax, params_to_jax
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import flash_attention as fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.ops.philox import keep_mask
from uc2_torch.training.step import make_loss_fn

TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bias(rng, B, L):
    """Additive padding mask: each row keeps a random prefix of >= L/2 keys."""
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        mask[b, :int(rng.integers(L // 2, L + 1))] = 1.0
    return ((1.0 - mask) * -10000.0)[:, None, None, :]


# ---------------------------------------------------------------- kernel #4
@pytest.mark.parametrize("B,L", [(2, 419), (1, 450), (1, 512)])
def test_long_plain_matches_pallas_kernel(B, L):
    """fp32, 12 heads of 64, at 2e-5: the plain version of #4 against the
    reference's per-(batch, q-block) kernel run in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(L)
    q, k, v = (_f32(rng, B, L, 12, 64) for _ in range(3))
    bias = _bias(rng, B, L)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fa._fwd_pallas(*map(jnp.asarray,
                                                  (q, k, v, bias))))
    before = fa.flash_attention_long.launches
    got = fa.flash_attention_long(*map(torch.from_numpy, (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert fa.flash_attention_long.launches == before   # CPU: no launch


@pytest.mark.parametrize("n,L", [(12, 418), (12, 419), (12, 512), (2, 512)])
def test_dispatch_matches_reference(monkeypatch, n, L):
    """The reference's flash_attention takes _fwd_pallas (#4) exactly where
    the port's uses_long_kernel says so, and the port's flash_attention
    then runs #4's plain version on the CPU."""
    ref, port = [], []
    monkeypatch.setattr(jax_fa, "_fwd_pallas_v3",
                        lambda q, *a: ref.append("v3") or jnp.zeros_like(q))
    monkeypatch.setattr(jax_fa, "_fwd_pallas",
                        lambda q, *a: ref.append("long") or jnp.zeros_like(q))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda q, *a: port.append("v3") or q)
    monkeypatch.setattr(fa, "flash_attention_long_plain",
                        lambda q, *a: port.append("long") or q)
    q = np.zeros((1, L, n, 8), np.float32)
    bias = np.zeros((1, 1, 1, L), np.float32)
    jax_fa.flash_attention(*map(jnp.asarray, (q, q, q, bias)))
    fa.flash_attention(*map(torch.from_numpy, (q, q, q, bias)))
    want = "long" if fa.uses_long_kernel(n, L) else "v3"
    assert ref == port == [want]
    assert want == ("long" if (n, L) in ((12, 419), (12, 512)) else "v3")


# --------------------------------------------------- training attention
def _train_inputs(seed, B, L, n, d):
    """The inputs of tests/test_flash_train.py: keys kept w.p. 0.8 and the
    first four always."""
    rng = np.random.default_rng(seed)
    q, k, v = (_f32(rng, B, L, n, d) for _ in range(3))
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    mask[:, :4] = 1.0
    return q, k, v, ((1.0 - mask) * -10000.0)[:, None, None, :]


@pytest.mark.parametrize("L", [339, 512])
def test_train_plain_matches_pallas_at_long_L(L):
    """rate 0: forward at 2e-5 and dq, dk, dv, dbias at 2e-4 against the
    Pallas training kernels in interpret mode (the JAX test's bars)."""
    q, k, v, bias = _train_inputs(L, 1, L, 2, 32)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jax_loss(*a):
        return jnp.sum(jax_fa.flash_attention_train(*a, jnp.int32(7), 0.0,
                                                    True) * w)

    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    want_out = np.asarray(jax_fa.flash_attention_train(*args, jnp.int32(7),
                                                       0.0, True))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    out = fa.flash_attention_train(*ts, 7, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for t, want, name in zip(ts, want_grads, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("L", [65, 162])
def test_train_plain_at_rate_0_is_the_long_plain(L):
    """#4 and #5 run one kernel core, which rests on this: at rate 0 the
    training forward's plain version is #4's bit for bit, and both match
    the reference kernels at fp32 1e-4: ``_fwd_train`` (interpret=True) and
    ``_fwd_pallas`` in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, bias = _train_inputs(L, 2, L, 2, 64)
    ts = [torch.from_numpy(a) for a in (q, k, v, bias)]
    train = fa.flash_attention_train_plain(*ts, 7, 0.0)
    assert torch.equal(train, fa.flash_attention_long_plain(*ts))
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    want_train = np.asarray(jax_fa._fwd_train(*args, jnp.int32(7), 0.0,
                                              interpret=True))
    with pltpu.force_tpu_interpret_mode():
        want_long = np.asarray(jax_fa._fwd_pallas(*args))
    for want in (want_train, want_long):
        np.testing.assert_allclose(train.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,L", [(3, 1), (1, 1), (3, 65)])
def test_heads_row_stride_of_fused_qkv_views(B, L):
    """The kernels read q, k, v in place as views into the fused QKV
    projection: the token stride is 3 H, also at L = 1 with B > 1, where a
    view may report any stride for the size-1 token dim; one token in all
    (B = L = 1) takes the heads' width."""
    qkv = torch.zeros(B, L, 3 * 768)
    q, k, v = (t.view(B, L, 12, 64) for t in qkv.split(768, dim=-1))
    rs = fa.heads_row_stride(q, k, v)
    assert rs == (3 * 768 if B > 1 or L > 1 else 768)
    for t in (q, k, v):
        assert B == 1 or t.stride(0) == L * rs


@pytest.mark.parametrize("L", [1, 63, 65, 98, 162, 339, 512])
def test_train_bwd_plain_is_the_gradient_at_long_L(L):
    """rate 0.2, float64: the backward formula is the gradient of the
    forward under one seed, and #6's two passes (rows, then keys from the
    rows' statistics and keep bits), which run at every L, give the same
    gradients (1e-10); the last L // 8 keys are padding."""
    rng = np.random.default_rng(L)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, L, 2, 4)))
                  for _ in range(4))
    mask = np.ones((1, L))
    mask[0, L - L // 8:] = 0.0
    bias = torch.from_numpy(((1.0 - mask) * -10000.0)[:, None, None, :])
    ins = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = fa.flash_attention_train_plain(*ins, 11, 0.2)
    auto = torch.autograd.grad(out, ins, g)
    whole = fa.flash_attention_train_bwd_plain(q, k, v, bias, 11, 0.2, g)
    dq, stats, bits = fa.flash_attention_train_bwd_dq(q, k, v, bias, 11,
                                                      0.2, g)
    dk, dv, dbp = fa.flash_attention_train_bwd_dkdv(q, k, v, bias, 11, 0.2,
                                                    g, stats, bits)
    split = (dq, dk, dv, dbp.sum(dim=1).reshape(1, 1, 1, L))
    for a, b, c in zip(whole, auto, split):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("B,L", [(2, 1), (2, 65), (1, 162)])
def test_train_bwd_rows_pass_stats_and_bits(B, L):
    """Pass 1's statistics are finite on every row, padding rows included
    (their keys are the valid prefix), and its keep bits are the Philox
    mask of every score on the [Lp, Lp] grid of 64-row tiles, packed 8
    keys a byte; pass 2 reads its mask from those bits: flipping one kept
    score's bit changes dk."""
    rng = np.random.default_rng(B * L)
    q, k, v, g = (torch.from_numpy(_f32(rng, B, L, 2, 64)) for _ in range(4))
    bias = torch.from_numpy(_bias(rng, B, L))
    bias[0, ..., L // 2 + 1:] = -10000.0     # padding tokens in batch row 0
    rate, seed = 0.3, 5
    dq, stats, bits = fa.flash_attention_train_bwd_dq(q, k, v, bias, seed,
                                                      rate, g)
    Lp = -(-L // 64) * 64
    assert stats.shape == (3, B, 2, L) and torch.isfinite(stats).all()
    assert (stats[1] > 0).all()
    keep = keep_mask(seed, rate, B, 2, Lp, Lp)
    assert bits.dtype == torch.uint8 and bits.shape == (B, 2, Lp, Lp // 8)
    assert torch.equal(fa.unpack_keep_bits(bits, Lp), keep)
    for i, j in ((0, 0), (L - 1, 7), (L - 1, L - 1), (Lp - 1, Lp - 1)):
        byte = int(bits[0, 1, i, j // 8])
        assert bool((byte >> (j % 8)) & 1) == bool(keep[0, 1, i, j])
    dk, _, _ = fa.flash_attention_train_bwd_dkdv(q, k, v, bias, seed, rate,
                                                 g, stats, bits)
    flip = bits.clone()
    i, j = map(int, torch.nonzero(keep[0, 0, :L, :L])[0])
    flip[0, 0, i, j // 8] ^= 1 << (j % 8)
    dk2, _, _ = fa.flash_attention_train_bwd_dkdv(q, k, v, bias, seed, rate,
                                                  g, stats, flip)
    assert not torch.equal(dk, dk2)
    assert fa.flash_attention_train_bwd_dq(q, k, v, bias, seed, 0.0, g)[2] \
        is None


# ----------------------------------------------- the slice as a whole
LONG = dict(vocab_size=1000, hidden_size=96, num_hidden_layers=2,
            num_attention_heads=12, intermediate_size=128,
            max_position_embeddings=514, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# the last long-caption bucket: 412 text tokens + 100 regions = 512
B, LT, NB, M = 2, 412, 100, 16


def _long_batch(seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, LONG["vocab_size"], (B, LT))
    ids[:, 0] = 0
    ids[1, 300:] = 1                              # a shorter caption
    ids[1, 299] = 2
    pos = rng.integers(1, 299, (B, M))
    b = {"input_ids": ids, "masked_pos": pos,
         "masked_weight": np.ones((B, M), np.float32),
         "txt_labels": rng.integers(4, LONG["vocab_size"], (B, M)),
         "img_feat": _f32(rng, B, NB, LONG["img_dim"]),
         "img_pos_feat": rng.random((B, NB, 7)).astype(np.float32)}
    mask = np.ones((B, LT + NB), np.int64)
    mask[1, 300:LT] = 0
    mask[0, LT + 60:] = 0                          # 60 regions
    b["attn_mask"] = mask
    return b


def test_long_caption_mlm_loss_and_grads_match_reference(monkeypatch):
    """Joint L = 512 at 12 heads under "pallas" at dropout 0: the port's
    route takes #4 (its plain version here) in both layers; the loss and
    every gradient match the reference at fp32 and 1e-4."""
    model = UC2ForPretraining(UC2Config(use_pallas_attention=True, **LONG),
                              device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():                         # away from init
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    params = params_to_jax(model.state_dict())
    b = _long_batch()
    jm = JaxPretraining(JaxConfig(use_pallas_attention=True, **LONG))
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        jax_step.make_loss_fn(jm, "mlm"), has_aux=True))(
        params, {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
                 for k, v in b.items()}, jax.random.PRNGKey(1))
    calls = []
    plain = fa.flash_attention_long_plain
    monkeypatch.setattr(fa, "flash_attention_long_plain",
                        lambda *a: calls.append(1) or plain(*a))
    loss, _ = make_loss_fn("mlm")(
        model, {k: torch.from_numpy(v) for k, v in b.items()},
        DropoutRng(1, "cpu"))
    loss.backward()
    assert len(calls) == LONG["num_hidden_layers"]
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4,
                               atol=1e-4)
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, wgrads))
    got_g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n].numpy(), want_g[n].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_attn_v2_route_runs_kernel_7(monkeypatch):
    """Kernel #7 is ported: with UC2_ATTN_V2 set, every layer on the fused
    route runs the QKV-in-kernel block (#7) and not #2; without it, #2 and
    not #7 (the variable is read at every forward)."""
    cfg = UC2Config(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=64,
                    max_position_embeddings=40, img_dim=16, dtype="float32",
                    use_pallas_attention="fused-force")
    model = UC2ForImageTextRetrieval(cfg, device="cpu", seed=0)
    batch = {"input_ids": torch.full((2, 6), 5), "img_feat": torch.zeros(
        2, 4, 16), "img_pos_feat": torch.zeros(2, 4, 7),
        "attn_mask": torch.ones(2, 10, dtype=torch.long)}
    from uc2_torch.models import encoder
    calls = {"v1": 0, "v2": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(encoder, "fused_attn_block",
                        counted("v1", encoder.fused_attn_block))
    monkeypatch.setattr(encoder, "fused_attn_block_v2",
                        counted("v2", encoder.fused_attn_block_v2))
    for env, want in (("1", {"v1": 0, "v2": 2}), (None, {"v1": 2, "v2": 0})):
        if env is None:
            monkeypatch.delenv("UC2_ATTN_V2", raising=False)
        else:
            monkeypatch.setenv("UC2_ATTN_V2", env)
        calls.update(v1=0, v2=0)
        assert torch.isfinite(model.scores(batch)).all()
        assert calls == want, env


# ------------------------------------------------------------ data side
MAX_TXT, MAX_BB = 410, 100
CORPUS = dict(n_imgs=40, txt_per_img=2, vocab=1000, img_dim=16, min_bb=10,
              max_bb=MAX_BB, max_words=100)


@pytest.fixture(scope="module")
def long_corpus():
    return synth_pretrain_corpus(9, max_txt_len=MAX_TXT, **CORPUS)


def _buckets(pkg):
    # the long-caption buckets (joint L 174 / 339 / 512) at a small token
    # budget: 8 rows each
    return pkg.default_buckets(MAX_TXT, MAX_BB, 2048)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_txt_db_drops_texts_longer_than_max_txt_len(tmp_path):
    """As the reference's TxtTokDb over the same corpus on disk."""
    from uc2_tpu.data.db import TxtTokDb
    from uc2_tpu.data.synth import synth_corpus
    kw = dict(CORPUS, n_imgs=12, max_words=40)
    paths = synth_corpus(str(tmp_path), seed=7, paired=True, compress=False,
                         **kw)
    for max_txt_len in (60, -1):
        ours, _ = synth_pretrain_corpus(7, max_txt_len=max_txt_len, **kw)
        ref = TxtTokDb(paths["txt_db"], max_txt_len=max_txt_len)
        assert ours.ids == ref.ids and ours.id2len == ref.id2len
    assert 0 < len(synth_pretrain_corpus(7, max_txt_len=60, **kw)[0].ids) < 24


def test_bucket_batcher_matches_reference():
    rng = np.random.default_rng(4)
    txt = rng.integers(3, 430, 300).tolist()
    nbb = rng.integers(10, 101, 300).tolist()
    for drop_last in (True, False):
        ours = sampler.BucketBatcher(txt, nbb, _buckets(collate), seed=5,
                                     drop_last=drop_last)
        ref = jax_sampler.BucketBatcher(txt, nbb, _buckets(jax_collate),
                                        seed=5, drop_last=drop_last)
        assert ours.routing == ref.routing and ours.n_skipped == ref.n_skipped
        assert ours.batches_per_epoch() == ref.batches_per_epoch()
        for ep in range(3):
            assert list(ours.epoch(ep)) == list(ref.epoch(ep))
    assert [collate.pick_bucket(_buckets(collate), t, n) for t, n in
            zip(txt, nbb)] == [jax_collate.pick_bucket(
                _buckets(jax_collate), t, n) for t, n in zip(txt, nbb)]


def _task_loaders(pkg_ds, pkg_loader, pkg_collate, corpus, seed=2):
    sets = {"mlm": pkg_ds.MlmDataset(*corpus),
            "tlm": pkg_ds.TlmDataset(*corpus, comasking_mode="mix"),
            "itm": pkg_ds.ItmDataset(*corpus, neg_sample_p=0.5)}
    return {k: pkg_loader.TaskLoader(k, ds, _buckets(pkg_collate), seed=seed)
            for k, ds in sets.items()}


def test_task_loader_matches_reference(long_corpus):
    """The same bucket/batch schedule and the same collated batches across
    epochs, stacked windows, and a state-dict round trip, bit for bit."""
    ours = _task_loaders(datasets, loader, collate, long_corpus)["mlm"]
    ref = _task_loaders(jax_datasets, jax_loader, jax_collate,
                        long_corpus)["mlm"]
    assert [b.max_masked for b in ours.buckets] == [b.max_masked
                                                   for b in ref.buckets]
    seen = set()
    for _ in range(14):                      # past the first epoch's end
        got, want = ours.next_batch(), ref.next_batch()
        _assert_same(got, want)
        seen.add(got["_bucket"])
    assert ours._epoch == ref._epoch >= 1 and seen == {0, 1, 2}
    _assert_same(ours.next_stacked(3), ref.next_stacked(3))
    sd = ours.state_dict()
    assert sd == ref.state_dict()
    again = _task_loaders(datasets, loader, collate, long_corpus)["mlm"]
    again.load_state_dict(sd)
    for _ in range(4):
        _assert_same(again.next_batch(), ours.next_batch())


def test_meta_loader_and_prefetch_match_reference(long_corpus):
    """The task schedule of the mix, stacked accumulation windows and
    fast_forward as the reference's; the prefetch worker's batches are the
    meta loader's, as tensors on the device, fp16 features upcast."""
    ratios = {"mlm": 12, "tlm": 3, "itm": 9}
    kw = dict(ratios=ratios, accum_steps=2, seed=3, stack_microbatches=True)
    ours = loader.MetaLoader(_task_loaders(datasets, loader, collate,
                                           long_corpus), **kw)
    ref = jax_loader.MetaLoader(_task_loaders(jax_datasets, jax_loader,
                                              jax_collate, long_corpus), **kw)
    pick = loader.deterministic_task_schedule(list(ratios),
                                              list(ratios.values()), 3)
    want_pick = jax_loader.deterministic_task_schedule(
        list(ratios), list(ratios.values()), 3)
    assert [pick(w) for w in range(50)] == [want_pick(w) for w in range(50)]
    ref_items = [next(ref) for _ in range(6)]
    pre = loader.PrefetchLoader(ours, depth=2,
                                device_put=loader.task_batch_to_device("cpu"))
    try:
        for name, want in ref_items:
            got_name, got = next(pre)
            assert got_name == name
            assert set(got) == set(want) - {"_bucket", "sample_size"}
            for k, t in got.items():
                w = np.asarray(want[k])
                assert t.dtype == (torch.float32 if w.dtype == np.float16
                                   else torch.from_numpy(w).dtype), k
                assert np.array_equal(t.numpy(), w.astype(t.numpy().dtype)), k
    finally:
        pre.close()
    assert not pre.thread.is_alive()
    ff = loader.MetaLoader(_task_loaders(datasets, loader, collate,
                                         long_corpus), **kw)
    ff_ref = jax_loader.MetaLoader(_task_loaders(
        jax_datasets, jax_loader, jax_collate, long_corpus), **kw)
    ff.fast_forward(5)
    ff_ref.fast_forward(5)
    assert ff.state_dict() == ff_ref.state_dict()
    _assert_same(next(ff)[1], next(ff_ref)[1])
