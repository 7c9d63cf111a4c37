"""Activation recomputation (``remat="full"`` and ``"dots"``) in uc2_torch on
the CPU:

* an mlm step at dropout 0.1 under "xla", "pallas-train" and
  "pallas-train" with the training FFN block (``UC2_FFN_TRAIN=1``): under
  ``full`` and ``dots`` the loss, every gradient and both of
  ``DropoutRng``'s generator states after the step are bit for bit those
  of ``remat="none"``: the recompute draws the forward's kernel seeds and
  masks, and leaves the streams where the step left them;
* at dropout 0, the loss and every gradient against the reference's
  remat step (``nn.remat`` around each layer, the config of
  tests/test_remat_bf16.py) within 1e-4;
* the bytes a step keeps for its backward order as full < dots < none:
  the tensors packed through ``saved_tensors_hooks`` plus, under
  ``dots``, the products' outputs its policy keeps.
"""

import numpy as np
import pytest
import torch
import jax

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.models import encoder
from uc2_torch.models.convert import params_from_jax
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import ffn_train
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training.step import make_loss_fn

TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
# tests/test_remat_bf16.py's model, at dropout 0
REF = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=40, img_dim=16, img_label_dim=7,
           dtype="float32", use_pallas_attention=False,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
ROUTES = {"xla": ("xla", False), "pallas-train": ("pallas-train", False),
          "pallas-train+ffn": ("pallas-train", True)}


def _batch(B=3, Lt=10, Nb=7, M=5, vocab=1000, img_dim=32, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (B, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1                          # padded text tail
    mask = np.ones((B, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0                   # padded regions
    return {"input_ids": ids,
            "img_feat": rng.standard_normal((B, Nb, img_dim)).astype(
                np.float32),
            "img_pos_feat": rng.random((B, Nb, 7)).astype(np.float32),
            "attn_mask": mask,
            "masked_pos": rng.integers(1, Lt - 3, (B, M)),
            "masked_weight": np.ones((B, M), np.float32),
            "txt_labels": rng.integers(3, vocab, (B, M))}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _step(cfg, batch, params=None, seed=7):
    """(loss, {name: gradient}, the rng's state after the step) of one mlm
    forward and backward."""
    model = UC2ForPretraining(cfg, device="cpu", seed=0, params=params)
    rng = DropoutRng(seed, "cpu")
    loss, _ = make_loss_fn("mlm")(model, _torch(batch), rng)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, rng.get_state()


_NONE = {}


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_step_is_bit_for_bit_the_plain_step(route, remat,
                                                  monkeypatch):
    impl, ffn = ROUTES[route]
    if ffn:
        monkeypatch.setenv("UC2_FFN_TRAIN", "1")
        assert ffn_train.ffn_train_enabled()
    else:
        monkeypatch.delenv("UC2_FFN_TRAIN", raising=False)
    batch = _batch()
    if route not in _NONE:
        _NONE[route] = _step(UC2Config(use_pallas_attention=impl, **TINY),
                             batch)
    want = _NONE[route]
    got = _step(UC2Config(use_pallas_attention=impl, remat=remat, **TINY),
                batch)
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1]) and len(want[1]) > 30
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)


def test_remat_without_the_replay_draws_other_masks(monkeypatch):
    """The replay is what makes the step above exact: with the generators
    left as checkpoint leaves them, the recompute draws new masks and the
    gradients are those of another forward."""
    batch = _batch()
    cfg = UC2Config(use_pallas_attention="pallas-train", **TINY)
    want = _step(cfg, batch)
    monkeypatch.setattr(DropoutRng, "set_state", lambda self, state: None)
    got = _step(cfg.replace(remat="full"), batch)
    assert torch.equal(got[0], want[0])
    assert not all(torch.equal(got[1][k], want[1][k]) for k in want[1])


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree_util.tree_map(
        np.asarray, JaxPretraining(JaxConfig(**REF)).init_params(
            jax.random.PRNGKey(0)))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_step_matches_reference_at_dropout_0(ref_params, remat):
    batch = _batch(B=4, Lt=10, Nb=6, M=8, vocab=256, img_dim=16, seed=2)
    jm = JaxPretraining(JaxConfig(remat=remat, **REF))
    jb = {k: jax.numpy.asarray(v, jax.numpy.int32 if v.dtype == np.int64
                               else None) for k, v in batch.items()}
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        jax_step.make_loss_fn(jm, "mlm"), has_aux=True))(
        ref_params, jb, jax.random.PRNGKey(1))
    loss, grads, _ = _step(UC2Config(remat=remat, **REF), batch,
                           params=ref_params)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, wgrads))
    assert set(grads) <= set(want_grads)
    for k, w in want_grads.items():
        g = grads.get(k, torch.zeros_like(w))
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=k, **TOL)


def test_remat_keeps_fewer_bytes_for_the_backward(monkeypatch):
    """Bytes packed for the backward by ``saved_tensors_hooks`` during the
    forward, plus the outputs ``dots`` keeps by its policy (checkpoint
    holds those itself, not through the hooks)."""
    policy = encoder._save_dots
    kept = [0]

    def counting(ctx, op, *args, **kwargs):
        choice = policy(ctx, op, *args, **kwargs)
        if (choice == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                and not ctx.is_recompute):
            kept[0] += ctx.op_output.numel() * ctx.op_output.element_size()
        return choice
    monkeypatch.setattr(encoder, "_save_dots", counting)
    batch = _torch(_batch(B=4, Lt=24, Nb=16))
    saved = {}
    for remat in ("none", "full", "dots"):
        model = UC2ForPretraining(UC2Config(
            use_pallas_attention="pallas-train", remat=remat, **TINY),
            device="cpu", seed=0)
        kept[0] = packed = 0

        def pack(t):
            nonlocal packed
            packed += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = make_loss_fn("mlm")(model, batch,
                                          DropoutRng(7, "cpu"))
        loss.backward()
        saved[remat] = packed + kept[0]
    assert saved["full"] < saved["dots"] < saved["none"], saved
