"""The two attention routes of uc2_torch that follow the reference's own
dispatch beyond its default: the ``UC2_ATTN_V2`` block (kernel #7, the QKV
projection inside the fused attention block) and ``use_pallas_attention=
"flash"`` (kernels #12, #12a, #12b, the counterpart of jax's library TPU
kernel), against the reference package at fp32 on the CPU.

The reference runs #7 in interpret mode on the CPU by itself. It routes
"flash" to the library kernel only on a TPU (``_on_tpu``); these tests
patch ``uc2_tpu.ops.attention._on_tpu`` to return True and run the
reference under ``pltpu.force_tpu_interpret_mode()``, so that the library
kernel, forward and backward, runs in interpret mode; each reference call
there is one ``jax.jit`` program (interpret mode runs the kernel through
host callbacks, which can deadlock against JAX operations dispatched
eagerly while they run). The library kernel
differs from the eager chain at invalid query rows (segment masking and
zero-padded keys), so every position is compared against the kernel."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.ops import attention as jax_attention
from uc2_tpu.ops import fused_block as jfb
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.models import encoder as port_encoder
from uc2_torch.models.convert import params_from_jax
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import segment_flash as sf
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.ops.fused_block import fused_attn_block_v2
from uc2_torch.training.step import make_loss_fn

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)     # one function, fp32
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)       # its backward
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)      # a whole model, fp32
TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mask_bias(mask):
    return ((1.0 - mask.astype(np.float32)) * -10000.0)[:, None, None, :]


@pytest.fixture
def library_kernel(monkeypatch):
    """The reference's "flash" route on the CPU: ``_on_tpu`` patched to
    True and Pallas in interpret mode."""
    monkeypatch.setattr(jax_attention, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


# ------------------------------------------------------------- kernel #7
def _v2_inputs(rng, B, L, n, d):
    H = n * d
    x = _f32(rng, B, L, H)
    w_qkv, b_qkv = _f32(rng, H, 3 * H, scale=0.05), _f32(rng, 3 * H,
                                                         scale=0.05)
    wo, bo = _f32(rng, H, H, scale=0.05), _f32(rng, H, scale=0.05)
    gamma = (1.0 + _f32(rng, H, scale=0.1)).astype(np.float32)
    beta = _f32(rng, H, scale=0.05)
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    mask[:, :2] = 1.0
    return x, w_qkv, b_qkv, _mask_bias(mask), wo, bo, gamma, beta


@pytest.mark.parametrize("BB", [0, 3])
def test_fused_attn_block_v2_plain_matches_pallas(BB):
    """The shapes of tests/test_fused_block.py's v2 test (B 3, L 40, 4 heads
    of 8), at the kernel's default batch block (1 here) and at BB = 3;
    the port takes w_qkv and wo in nn.Linear layout ([out, in])."""
    n, d = 4, 8
    x, w_qkv, b_qkv, bias, wo, bo, gamma, beta = _v2_inputs(
        np.random.default_rng(5), 3, 40, n, d)
    want = np.asarray(jfb.fused_attn_block_v2(
        *map(jnp.asarray, (x, w_qkv, b_qkv, bias, wo, bo, gamma, beta)),
        n=n, eps=1e-12, BB=BB, interpret=True))
    before = fused_attn_block_v2.launches
    got = fused_attn_block_v2(*_t(x, w_qkv.T, b_qkv, bias, wo.T, bo, gamma,
                                  beta), n, eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    assert fused_attn_block_v2.launches == before      # CPU: no launch


@pytest.mark.parametrize("B,L", [(2, 63), (1, 64), (2, 65), (1, 129)])
def test_fused_attn_block_v2_plain_matches_pallas_at_tile_edges(B, L):
    """The edges of the CUDA kernel's 64-row query tiles (and of its
    clusters, one block pair a tile), 2 heads of 16."""
    n, d = 2, 16
    x, w_qkv, b_qkv, bias, wo, bo, gamma, beta = _v2_inputs(
        np.random.default_rng(L), B, L, n, d)
    want = np.asarray(jfb.fused_attn_block_v2(
        *map(jnp.asarray, (x, w_qkv, b_qkv, bias, wo, bo, gamma, beta)),
        n=n, eps=1e-12, interpret=True))
    got = fused_attn_block_v2(*_t(x, w_qkv.T, b_qkv, bias, wo.T, bo, gamma,
                                  beta), n, eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_fused_attn_block_v2_plain_at_uc2_base_width():
    """One layer's attention block at uc2-base width (12 heads of 64), B 2,
    L 162, with the layer's weights carried from the reference's parameter
    tree through params_from_jax."""
    n, d, B, L = 12, 64, 2, 162
    x, w_qkv, b_qkv, bias, wo, bo, gamma, beta = _v2_inputs(
        np.random.default_rng(162), B, L, n, d)
    tree = {"layer_0": {
        "attention": {"qkv": {"kernel": w_qkv, "bias": b_qkv}},
        "attention_output_dense": {"kernel": wo, "bias": bo},
        "attention_output_LayerNorm": {"weight": gamma, "bias": beta}}}
    sd = params_from_jax(tree)
    want = np.asarray(jfb.fused_attn_block_v2(
        *map(jnp.asarray, (x, w_qkv, b_qkv, bias, wo, bo, gamma, beta)),
        n=n, eps=1e-12, interpret=True))
    got = fused_attn_block_v2(
        torch.from_numpy(x), sd["layer.0.attention.qkv.weight"],
        sd["layer.0.attention.qkv.bias"], torch.from_numpy(bias),
        sd["layer.0.attention_output_dense.weight"],
        sd["layer.0.attention_output_dense.bias"],
        sd["layer.0.attention_output_LayerNorm.weight"],
        sd["layer.0.attention_output_LayerNorm.bias"], n, eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


# ------------------------------------------------------------ kernel #12
def _segment_case(L, where, B=2, n=2, d=64, seed=0):
    """q, k, v [B, L, n, d] and a bias whose invalid keys sit at the end of
    the sequence ('end') or inside it ('middle', as the joint sequence's
    text padding sits before the regions); batch row 0 keeps every key."""
    rng = np.random.default_rng(seed + L)
    q, k, v = (_f32(rng, B, L, n, d) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    if where == "end":
        mask[1, L - 13:] = 0.0
    else:
        mask[1, 20:L // 2 + 10] = 0.0
        mask[0, L - 5:] = 0.0
    return q, k, v, _mask_bias(mask)


SEGMENT_CASES = [(128, "end"), (128, "middle"), (130, "end"),
                 (162, "end"), (162, "middle")]


@pytest.mark.parametrize("L,where", SEGMENT_CASES)
def test_segment_flash_plain_matches_library_kernel(library_kernel, L,
                                                    where):
    """#12's plain forward against the reference's _stock_flash_attention
    at every position, invalid query rows included (there the library
    kernel differs from the eager chain, which is checked too)."""
    q, k, v, bias = _segment_case(L, where)
    want = np.asarray(jax.jit(jax_attention._stock_flash_attention)(
        *map(jnp.asarray, (q, k, v, bias))))
    before = sf.segment_flash_fwd.launches
    got, stats = sf.segment_flash_fwd(*_t(q, k, v, bias))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    assert sf.segment_flash_fwd.launches == before     # CPU: no launch
    assert stats.shape == (2, 2, 2, L) and torch.isfinite(stats).all()
    eager = np.asarray(jax_attention._xla_attention(
        *map(jnp.asarray, (q, k, v, bias))))
    valid = bias[:, 0, 0, :] >= -1.0
    np.testing.assert_allclose(got.numpy()[valid], eager[valid],
                               **KERNEL_TOL)
    assert np.abs(got.numpy()[~valid] - eager[~valid]).max() > 1e-2


# (128, "end") and (130, "end") hold the plain dK / dV at the edges of
# #12b's 64-key tiles; L = 192, 200 and 255 end inside the library's last
# 128-key block but at or past a 64-key tile edge, where #12a's sweep stops
# short of the padded length
@pytest.mark.parametrize("L,where", [(128, "middle"), (162, "end"),
                                     (162, "middle"), (128, "end"),
                                     (130, "end"), (192, "end"),
                                     (192, "middle"), (200, "end"),
                                     (200, "middle"), (255, "end"),
                                     (255, "middle")])
def test_segment_flash_backward_plain_matches_library_kernel(
        library_kernel, L, where):
    """dq, dk, dv of #12a/#12b's plain versions (through the port's
    autograd Function) against jax.grad through the library kernel's
    backward, with an output gradient at every position."""
    q, k, v, bias = _segment_case(L, where, seed=7)
    g = _f32(np.random.default_rng(L), *q.shape)

    def loss(q_, k_, v_):
        out = jax_attention._stock_flash_attention(q_, k_, v_,
                                                   jnp.asarray(bias))
        return jnp.sum(out * g)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    before = (sf.segment_flash_bwd_dq.launches,
              sf.segment_flash_bwd_dkdv.launches)
    out = sf.segment_flash_attention(tq, tk, tv, torch.from_numpy(bias))
    out.backward(torch.from_numpy(g))
    assert (sf.segment_flash_bwd_dq.launches,
            sf.segment_flash_bwd_dkdv.launches) == before
    for name, a, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_segment_flash_rounds_where_the_kernel_rounds():
    """On bf16 inputs the plain forward rounds the unnormalised
    probabilities (several blocks) or the normalised ones (one block) to
    bf16 before P.V, and returns bf16; a first block masked for a row
    leaves no NaN."""
    rng = np.random.default_rng(3)
    for L in (128, 200):
        q, k, v = (torch.from_numpy(_f32(rng, 1, L, 2, 64)).bfloat16()
                   for _ in range(3))
        mask = np.ones((1, L), np.float32)
        mask[0, L - 20:] = 0.0         # invalid rows: block 0 all masked
        bias = torch.from_numpy(_mask_bias(mask))
        out, stats = sf.segment_flash_plain(q, k, v, bias)
        assert out.dtype == torch.bfloat16 and torch.isfinite(
            out.float()).all()
        m, l = stats
        assert torch.isfinite(m).all() and (l >= 1.0).all()
        s = sf._scores(q, k, bias)
        p = torch.exp(s - m[..., None]) / l[..., None]
        exact = torch.einsum("bnlm,bmnd->blnd", p,
                             sf._padded(v, sf.padded_len(L)).float())
        assert (out.float() - exact).abs().max().item() < 0.05


# ------------------------------------------------------- the model routes
def _params(pkg_model):
    """Reference parameters (initialised on the eager route, whose tree is
    every route's), moved away from init."""
    tree = pkg_model(JaxConfig(use_pallas_attention=False, **TINY)
                     ).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


@pytest.fixture(scope="module")
def retrieval_params():
    return _params(JaxRetrieval)


def _batch(Lt, Nb, B=3, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1                  # padded text tail
    mask = np.ones((B, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0           # padded regions
    return {"input_ids": ids,
            "img_feat": _f32(rng, B, Nb, TINY["img_dim"]),
            "img_pos_feat": rng.random((B, Nb, 7)).astype(np.float32),
            "attn_mask": mask}


def _jax(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _scores_and_sequence(impl, params, b):
    """(reference scores, reference sequence output, port scores, port
    sequence output) under one routing."""
    jm = JaxRetrieval(JaxConfig(use_pallas_attention=impl, **TINY))
    jb = _jax(b)
    want_s = np.asarray(jax.jit(jm.scores)(params, jb))
    want_seq, _ = jax.jit(lambda p, bb: jm.encoder.apply(
        {"params": p}, input_ids=bb["input_ids"], img_feat=bb["img_feat"],
        img_pos_feat=bb["img_pos_feat"], attn_mask=bb["attn_mask"]))(
        params["roberta"], jb)
    port = UC2ForImageTextRetrieval(
        UC2Config(use_pallas_attention=impl, **TINY), device="cpu",
        params=params)
    with torch.no_grad():
        got_s = port.scores(_torch(b))
        got_seq, _ = port.roberta(**_torch(b))
    return want_s, np.asarray(want_seq), got_s.numpy(), got_seq.numpy()


@pytest.mark.parametrize("Lt,Nb", [(10, 7), (62, 66)])
def test_attn_v2_model_matches_reference(retrieval_params, monkeypatch, Lt,
                                         Nb):
    """"fused-force" with UC2_ATTN_V2=1: #7 and #3 in every layer of both
    packages (interpret mode and plain versions), scores and every position
    of the sequence output, at joint L = 17 and 128."""
    monkeypatch.setenv("UC2_ATTN_V2", "1")
    calls = []
    monkeypatch.setattr(port_encoder, "fused_attn_block_v2",
                        lambda *a, **kw: calls.append(1)
                        or fused_attn_block_v2(*a, **kw))
    want_s, want_seq, got_s, got_seq = _scores_and_sequence(
        "fused-force", retrieval_params, _batch(Lt, Nb))
    np.testing.assert_allclose(got_s, want_s, **MODEL_TOL)
    np.testing.assert_allclose(got_seq, want_seq, **MODEL_TOL)
    assert len(calls) == 2 * TINY["num_hidden_layers"]


@pytest.mark.parametrize("Lt,Nb", [(10, 7), (62, 66), (10, 120)])
def test_flash_model_matches_reference(retrieval_params, library_kernel,
                                       Lt, Nb):
    """"flash": the eager chain at joint L = 17, the library kernel's
    function at 128 (one block) and 130 (two blocks, 126 zero keys); scores
    and every position of the sequence output, invalid ones included."""
    want_s, want_seq, got_s, got_seq = _scores_and_sequence(
        "flash", retrieval_params, _batch(Lt, Nb))
    np.testing.assert_allclose(got_s, want_s, **MODEL_TOL)
    np.testing.assert_allclose(got_seq, want_seq, **MODEL_TOL)


def test_flash_mlm_loss_and_grads_match_reference(library_kernel,
                                                  monkeypatch):
    """The mlm loss and every gradient under "flash" at attention dropout 0
    (hidden dropout 0 too, as the two packages draw different masks), at
    joint L = 130: forward and backward through the library kernel in the
    reference, #12 / #12a / #12b's plain versions in the port."""
    params = _params(JaxPretraining)
    B, Lt, Nb, M = 2, 10, 120, 5
    b = _batch(Lt, Nb, B=B, seed=4)
    rng = np.random.default_rng(4)
    b.update(masked_pos=rng.integers(0, Lt - 3, (B, M)),
             masked_weight=np.ones((B, M), np.float32),
             txt_labels=rng.integers(3, TINY["vocab_size"], (B, M)))
    b["masked_weight"][0, M - 2:] = 0.0
    jm = JaxPretraining(JaxConfig(use_pallas_attention="flash", **TINY))
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        jax_step.make_loss_fn(jm, "mlm"), has_aux=True))(
        params, _jax(b), jax.random.PRNGKey(1))
    model = UC2ForPretraining(UC2Config(use_pallas_attention="flash", **TINY),
                              device="cpu", params=params)
    calls = []
    fwd = sf.segment_flash_fwd
    monkeypatch.setattr(sf, "segment_flash_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    loss, _ = make_loss_fn("mlm")(model, _torch(b), DropoutRng(1, "cpu"))
    loss.backward()
    assert len(calls) == TINY["num_hidden_layers"]
    np.testing.assert_allclose(loss.item(), float(want), **MODEL_TOL)
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, wgrads))
    got_g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n].numpy(), want_g[n].numpy(),
                                   err_msg=n, **MODEL_TOL)
