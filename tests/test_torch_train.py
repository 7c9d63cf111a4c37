"""uc2_torch's mlm training step against the reference package at fp32 on
the CPU: the loss and every gradient (mlm with and without the chunked
CE, tlm-ni), one AdamW step with global-norm clipping, gradient
accumulation over a stacked batch, the schedules and the decay mask, and
the data side (token masking and the mlm collate) bit for bit. Dropout is
0 where values are compared: the two packages draw different masks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import collate as jax_collate
from uc2_tpu.data import masking as jax_masking
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.training import optim as jax_optim
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, masking
from uc2_torch.models.convert import params_from_jax, params_to_jax
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import flash_attention as fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training import optim
from uc2_torch.training.step import make_loss_fn, train_step

TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
B, LT, NB, M = 3, 10, 7, 5


@pytest.fixture(scope="module")
def params():
    """Reference pretraining parameters, moved away from init."""
    tree = JaxPretraining(JaxConfig(**TINY)).init_params(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


def _batch(seed=1, with_image=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, LT))
    ids[:, 0] = 0
    ids[0, LT - 3:] = 1                          # padded text tail
    b = {"input_ids": ids, "masked_pos": rng.integers(0, LT - 3, (B, M)),
         "masked_weight": np.ones((B, M), np.float32),
         "txt_labels": rng.integers(3, TINY["vocab_size"], (B, M))}
    b["masked_weight"][0, M - 2:] = 0.0          # padded slots
    b["masked_pos"][0, M - 2:] = 0
    mask = np.ones((B, LT + NB if with_image else LT), np.int64)
    mask[0, LT - 3:LT] = 0
    if with_image:
        b["img_feat"] = rng.standard_normal((B, NB, TINY["img_dim"])).astype(
            np.float32)
        b["img_pos_feat"] = rng.random((B, NB, 7)).astype(np.float32)
        mask[1, LT + NB // 2:] = 0               # padded regions
    b["attn_mask"] = mask
    return b


def _jax(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _port(params, impl=True, chunks=0, **cfg):
    return UC2ForPretraining(UC2Config(use_pallas_attention=impl,
                                       **{**TINY, **cfg}),
                             lm_ce_chunks=chunks, device="cpu", params=params)


def _port_grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _assert_trees_close(got: dict, want_tree, **tol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("task,impl,chunks", [
    ("mlm", True, 0), ("mlm", False, 0), ("mlm", "pallas-train", 0),
    ("mlm", True, 3), ("tlm-ni", True, 0)])
def test_loss_and_grads_match_reference(params, task, impl, chunks):
    b = _batch(with_image=task != "tlm-ni")
    jm = JaxPretraining(JaxConfig(**TINY), lm_ce_chunks=chunks)
    (want, wm), wgrads = jax.value_and_grad(
        jax_step.make_loss_fn(jm, task), has_aux=True)(
        params, _jax(b), jax.random.PRNGKey(1))
    model = _port(params, impl, chunks)
    loss, m = make_loss_fn(task)(model, _torch(b), DropoutRng(1, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    assert m["n_units"].item() == float(wm["n_units"]) == B * M - 2
    _assert_trees_close(_port_grads(model), wgrads, **TOL)


@pytest.mark.parametrize("grad_norm", [1.0, 5.0])
def test_train_step_matches_reference(params, grad_norm):
    """One update at lr constant(1e-3) with the pretraining config's clip
    (5.0; the grad norm here is 4.4, so it stays inactive) and with a clip
    at 1.0 that is active: loss, grad norm and every parameter."""
    b = _batch()
    jm = JaxPretraining(JaxConfig(**TINY))
    tx = jax_optim.build_optimizer(params, jax_optim.constant(1e-3),
                                   grad_norm=grad_norm)
    state = jax_step.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, want = jax.jit(jax_step.make_train_step(jm, "mlm", tx))(
        state, _jax(b), jax.random.PRNGKey(1))
    model = _port(params)
    opt = optim.build_optimizer(model, optim.constant(1e-3),
                                grad_norm=grad_norm)
    got = train_step(model, opt, _torch(b), DropoutRng(1, "cpu"))
    assert (float(want["grad_norm"]) > grad_norm) == (grad_norm == 1.0)
    for k in ("loss", "n_units", "grad_norm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)
    _assert_trees_close(dict(model.named_parameters()), state.params, **TOL)


def test_stacked_batch_matches_accumulated_grads(params):
    """A [2, B, ...] batch: gradients and metrics averaged over the two
    micro-batches, one update, as the reference's accumulated_grads."""
    b1, b2 = _batch(1), _batch(2)
    stacked = {k: np.stack([b1[k], b2[k]]) for k in b1}
    jm = JaxPretraining(JaxConfig(**TINY))
    tx = jax_optim.build_optimizer(params, jax_optim.constant(1e-3),
                                   grad_norm=5.0)
    state = jax_step.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, want = jax.jit(jax_step.make_train_step(jm, "mlm", tx))(
        state, _jax(stacked), jax.random.PRNGKey(1))
    model = _port(params)
    opt = optim.build_optimizer(model, optim.constant(1e-3), grad_norm=5.0)
    got = train_step(model, opt, _torch(stacked), DropoutRng(1, "cpu"))
    for k in ("loss", "n_units", "grad_norm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)
    _assert_trees_close(dict(model.named_parameters()), state.params, **TOL)


def test_schedules_match_reference():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    pairs = [(optim.warmup_linear(4e-5, 10, 100),
              jax_optim.warmup_linear(4e-5, 10, 100)),
             (optim.warmup_linear(1e-3, 0, 20),
              jax_optim.warmup_linear(1e-3, 0, 20)),
             (optim.noam(1e-3, 10), jax_optim.noam(1e-3, 10)),
             (optim.constant(3e-4), jax_optim.constant(3e-4)),
             (optim.get_lr_schedule("vqa", 1e-4, warm_int=5, decay_int=7,
                                    decay_st=20, decay_rate=0.2),
              jax_optim.get_lr_schedule("vqa", 1e-4, warm_int=5, decay_int=7,
                                        decay_st=20, decay_rate=0.2))]
    for ours, ref in pairs:
        for s in steps:   # the reference computes in fp32
            np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6)


def test_decay_mask_and_optimizer_groups_match_reference(params):
    want = params_from_jax(jax_optim.decay_mask(params))
    model = _port(params)
    got = optim.decay_mask(n for n, _ in model.named_parameters())
    assert got == {k: bool(v) for k, v in want.items()}
    opt = optim.build_optimizer(model, optim.constant(1e-3))
    decay, no_decay = opt.opt.param_groups
    assert decay["weight_decay"] == 0.01 and no_decay["weight_decay"] == 0.0
    assert len(decay["params"]) == sum(got.values())
    for name in ("adam", "adamax"):
        # the same groups, decay decoupled from the algorithm's update
        other = optim.build_optimizer(model, optim.constant(1e-3),
                                      optim=name)
        groups = other.opt.param_groups
        assert [len(g["params"]) for g in groups] == \
            [len(decay["params"]), len(no_decay["params"])]
        before = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        norm = other.step()
        assert other.count == 1 and torch.isfinite(norm)
        assert all(not torch.equal(a, p) for a, p in
                   zip(before, model.parameters()))
        with torch.no_grad():
            for a, p in zip(before, model.parameters()):
                p.copy_(a)
    with pytest.raises(ValueError):
        optim.build_optimizer(model, optim.constant(1e-3), optim="sgd")


def test_full_pretraining_tree_round_trips_and_loads(params):
    sd = params_from_jax(params)
    back = params_to_jax(sd)
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(back)[0]] == [p for p, _ in flat(params)[0]]
    for (_, a), (_, b) in zip(flat(back)[0], flat(params)[0]):
        assert np.array_equal(a, b)
    model = _port(params)
    assert set(model.state_dict()) == set(sd)      # the tied decoder has no key
    assert "cls.decoder.weight" not in sd


def test_lm_head_valid_ids_matches_reference(params):
    """The LM head restricted to a subset of the vocabulary (``valid_ids``):
    the logits and the gradients of a weighted sum of them with respect to
    the hidden states and the tied embedding table."""
    from uc2_tpu.models.heads import RobertaLMHead as JaxLMHead
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, M, TINY["hidden_size"])).astype(np.float32)
    ids = np.sort(rng.choice(TINY["vocab_size"], 37, replace=False))
    wts = rng.standard_normal((B, M, len(ids))).astype(np.float32)
    emb = np.asarray(params["roberta"]["embeddings"]["word_embeddings"])
    head = JaxLMHead(JaxConfig(**TINY))

    def jax_fn(h_, emb_):
        logits = head.apply({"params": params["cls"]}, h_, emb_, ids)
        return (logits * wts).sum(), logits

    (_, want), (wdh, wdemb) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(emb))
    model = _port(params)
    th = torch.from_numpy(h).requires_grad_(True)
    temb = model.roberta.embeddings.word_embeddings.weight
    got = model.cls(th, temb, valid_ids=ids)
    (got * torch.from_numpy(wts)).sum().backward()
    assert got.shape == (B, M, len(ids)) and got.dtype == torch.float32
    for a, w in ((got, want), (th.grad, wdh), (temb.grad, wdemb)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), **TOL)


def test_training_routes_through_the_training_kernels(params, monkeypatch):
    """Per layer: "pallas" at rate > 0 and "pallas-train" at any rate run
    flash_attention_train; "pallas" at rate 0 runs flash_attention; "xla"
    neither. The fused inference blocks never run in training."""
    calls = {"train": 0, "flash": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fa, "flash_attention_train",
                        counted("train", fa.flash_attention_train))
    monkeypatch.setattr(fa, "flash_attention",
                        counted("flash", fa.flash_attention))
    b = _torch(_batch())
    for impl, rate, want in [(True, 0.1, (2, 0)), ("pallas-train", 0.0, (2, 0)),
                             (True, 0.0, (0, 2)), (False, 0.1, (0, 0))]:
        calls.update(train=0, flash=0)
        model = _port(params, impl, attention_probs_dropout_prob=rate,
                      hidden_dropout_prob=rate)
        make_loss_fn("mlm")(model, b, DropoutRng(0, "cpu"))[0].backward()
        assert (calls["train"], calls["flash"]) == want, impl


def test_dropout_is_drawn_from_the_rng(params):
    b = _torch(_batch())
    model = _port(params, True, attention_probs_dropout_prob=0.1,
                  hidden_dropout_prob=0.1)
    loss = make_loss_fn("mlm")
    with torch.no_grad():
        a, a2, c = (loss(model, b, DropoutRng(s, "cpu"))[0].item()
                    for s in (5, 5, 6))
        det = loss(model, b, None)[0].item()
    assert a == a2 and a != c and det not in (a, c)
    with pytest.raises(ValueError):          # training needs an rng
        model.forward_mlm(b, deterministic=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_tokens_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cases = [rng.integers(4, 1000, n) for n in (1, 5, 26, 62)]
    for ids in cases:
        for maskable in (None, np.arange(len(ids)) > 0):
            r1, r2 = (np.random.default_rng(seed + len(ids)) for _ in "ab")
            got = masking.mask_tokens(ids, (4, 999), 3, r1, 0.15, maskable)
            want = jax_masking.mask_tokens(ids, (4, 999), 3, r2, 0.15,
                                           maskable)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("with_image,positions", [(True, False),
                                                  (False, True)])
def test_collate_matches_reference(with_image, positions):
    rng = np.random.default_rng(4)
    examples = []
    for _ in range(5):
        n = int(rng.integers(3, 14))
        ids, labels = masking.mask_tokens(rng.integers(4, 1000, n), (4, 999),
                                          3, rng)
        e = {"input_ids": ids, "txt_labels": labels}
        if positions:
            e["position_ids"] = np.arange(2, n + 2)
        if with_image:
            nbb = int(rng.integers(2, 10))
            e["img_feat"] = rng.standard_normal((nbb, 16)).astype(np.float16)
            e["img_pos_feat"] = rng.random((nbb, 7)).astype(np.float32)
        examples.append(e)
    got = collate.collate_batch(examples, collate.BucketSpec(12, 8, 6, 3))
    want = jax_collate.collate_batch(examples,
                                     jax_collate.BucketSpec(12, 8, 6, 3))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
