"""The partial modes that tensor parallelism (``--n_model``) takes on the
kernel routes, on the CPU (their plain versions), at the widths of
tests/test_torch_tp.py (h = 64, 4 heads, F = 128, fp32), without a process
group: each shard's partial is computed here and the model group's sum is
a sum in this process.

* #7's partial mode on the shards of T = 2 and 4 (the QKV rows cut by
  ``shard_tensor``'s "qkv" layout), summed with ``block_epilogue``,
  against the reference's ``fused_attn_block_v2`` in interpret mode;
* #9/#10's partial modes at rate 0, summed with the residual and the
  LayerNorm, against the reference's ``fused_ffn_block_train`` in
  interpret mode and its ``jax.grad``: the output and the gradients of x,
  W1, b1, W2, b2 (on every shard), gamma and beta;
* at rate 0.1, against the port's one-process training FFN block on the
  same seed, the masks bit for bit;
* the int8 row-parallel product: each shard's codes, from the maxima of
  the whole rows and channels, and the exact sum of the shards' int32
  sums bit for bit the whole product's, and the output ``int8_linear``'s;
* #9's partial mode at rate 0 without b2 is #3's, bit for bit, and the
  partial wrappers refuse shards whose pieces disagree.

Each reference call is one ``jax.jit`` program (interpret mode deadlocks
against eagerly dispatched JAX ops)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.ops import fused_block as jfb
from uc2_tpu.ops.ffn_train import fused_ffn_block_train as jax_fft
from uc2_torch.models.convert import shard_tensor
from uc2_torch.ops import ffn_train, int8
from uc2_torch.ops.fused_block import (block_epilogue,
                                       fused_attn_block_v2_partial,
                                       fused_ffn_block_partial,
                                       layer_norm_f32)

TOL = dict(rtol=1e-4, atol=1e-4)
H, N, F = 64, 4, 128
EPS = 1e-12


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------- kernel #7
@pytest.mark.parametrize("T", [2, 4])
def test_v2_partials_summed_are_the_reference_block(T):
    rng = np.random.default_rng(T)
    B, L = 3, 37
    x = _f32(rng, B, L, H)
    w_qkv, b_qkv = _f32(rng, H, 3 * H, scale=0.1), _f32(rng, 3 * H,
                                                        scale=0.1)
    wo, bo = _f32(rng, H, H, scale=0.1), _f32(rng, H, scale=0.1)
    gamma, beta = 1.0 + _f32(rng, H, scale=0.1), _f32(rng, H, scale=0.1)
    mask = np.ones((B, L), np.float32)
    mask[1, 30:] = 0.0
    mask[2, 9:] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    want = np.asarray(jax.jit(lambda *a: jfb.fused_attn_block_v2(
        *a, n=N, eps=EPS, interpret=True))(
        *map(jnp.asarray, (x, w_qkv, b_qkv, bias, wo, bo, gamma, beta))))
    tx, tw, tb, tbias, two = _t(x, w_qkv.T, b_qkv, bias, wo.T)
    parts = []
    for m in range(T):
        parts.append(fused_attn_block_v2_partial(
            tx, shard_tensor(tw, "qkv", m, T), shard_tensor(tb, "qkv", m, T),
            tbias, shard_tensor(two, "row", m, T), N // T))
        assert parts[-1].dtype == torch.float32
    got = block_epilogue(sum(parts), *_t(bo), tx, *_t(gamma, beta), EPS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------- kernels #9 and #10
def _ffn_inputs(seed, B, L):
    """tests/test_torch_kernels.py's FFN inputs, the reference's [in, out]
    weights."""
    rng = np.random.default_rng(seed)
    return (_f32(rng, B, L, H), _f32(rng, H, F, scale=0.05),
            _f32(rng, F, scale=0.01), _f32(rng, F, H, scale=0.05),
            _f32(rng, H, scale=0.01), 1.0 + _f32(rng, H, scale=0.1),
            _f32(rng, H, scale=0.1), _f32(rng, B, L, H))


def _tp_block(args, T, seed, rate):
    """The training FFN block as a model group of T computes it, from
    leaves in ``nn.Linear`` layout: each shard's masked partial (b2 added
    on shard 0, each shard its own copy of b2), the sum, the residual and
    the LayerNorm. Returns (output, leaves, the b2 copies)."""
    x, w1, b1, w2, b2, gamma, beta = (t.requires_grad_(True) for t in _t(
        args[0], args[1].T, args[2], args[3].T, args[4], args[5], args[6]))
    b2s = [b2.detach().clone().requires_grad_(True) for _ in range(T)]
    Fl = F // T
    parts = [ffn_train.fused_ffn_block_train_partial(
        x, w1[m * Fl:(m + 1) * Fl], b1[m * Fl:(m + 1) * Fl],
        w2[:, m * Fl:(m + 1) * Fl], b2s[m], seed, rate, m == 0)
        for m in range(T)]
    out = layer_norm_f32(sum(parts) + x.float(), gamma, beta, EPS).to(x.dtype)
    return out, (x, w1, b1, w2, b2, gamma, beta), b2s


@pytest.mark.parametrize("B,L", [(2, 16), (1, 9)])
@pytest.mark.parametrize("T", [2, 4])
def test_ffn_train_partials_match_the_reference(T, B, L):
    *args, g = _ffn_inputs(T + L, B, L)
    ja = tuple(map(jnp.asarray, args))
    want = np.asarray(jax.jit(lambda *a: jax_fft(*a, 0, 0.0, EPS, True))(
        *ja))
    want_grads = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_fft(*a, 0, 0.0, EPS, True) * g),
        argnums=tuple(range(7))))(*ja)
    before = (ffn_train.fused_ffn_block_train_partial_fwd.launches,
              ffn_train.fused_ffn_block_train_partial_bwd.launches)
    out, leaves, b2s = _tp_block(args, T, 0, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    names = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")
    for name, t, w in zip(names, leaves, want_grads):
        w = np.asarray(w)
        if name == "b2":          # every shard holds b2's whole gradient
            assert t.grad is None
            for c in b2s:
                np.testing.assert_allclose(c.grad.numpy(), w, err_msg=name,
                                           **TOL)
            continue
        np.testing.assert_allclose(t.grad.numpy(), w.T if name in ("w1", "w2")
                                   else w, err_msg=name, **TOL)
    assert (ffn_train.fused_ffn_block_train_partial_fwd.launches,
            ffn_train.fused_ffn_block_train_partial_bwd.launches) == before


def test_ffn_train_partials_at_rate_01_are_the_one_process_block(
        monkeypatch):
    """At rate 0.1 the shards of T = 2 draw the one-process block's mask
    (the same Philox key: the model group's seed, the global row and
    column), bit for bit, in the forward and the backward, and the
    summed block and its gradients are the one-process block's."""
    *args, g = _ffn_inputs(3, 2, 16)
    seed, rate, T = 1234, 0.1, 2
    masks = []
    keep0 = ffn_train.ffn_keep_mask
    monkeypatch.setattr(ffn_train, "ffn_keep_mask",
                        lambda *a: masks.append(keep0(*a)) or masks[-1])
    x, w1, b1, w2, b2, gamma, beta = (t.requires_grad_(True) for t in _t(
        args[0], args[1].T, args[2], args[3].T, args[4], args[5], args[6]))
    want = ffn_train.fused_ffn_block_train(x, w1, b1, w2, b2, gamma, beta,
                                           seed, rate, EPS)
    (want * torch.from_numpy(g)).sum().backward()
    one = [t.grad.clone() for t in (x, w1, b1, w2, b2, gamma, beta)]
    assert len(masks) == 2 and masks[0].float().mean() < 0.95
    out, leaves, b2s = _tp_block(args, T, seed, rate)
    (out * torch.from_numpy(g)).sum().backward()
    assert len(masks) == 2 + 2 * T
    assert all(torch.equal(m, masks[0]) for m in masks)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    grads = [t.grad for t in leaves]
    grads[4] = b2s[0].grad
    for name, got, w in zip(("x", "w1", "b1", "w2", "b2", "gamma", "beta"),
                            grads, one):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
    assert torch.equal(b2s[1].grad, b2s[0].grad)


# ------------------------------------------------------- int8 products
@pytest.mark.parametrize("T", [2, 4])
def test_int8_row_parallel_shards_are_the_whole_product(T):
    """A row-parallel product (x's input columns and W's matching columns
    on each shard) quantized from the maxima over the shards: the codes
    are the whole product's, the shards' int32 sums add up to its sums
    exactly, and the output is ``int8_linear``'s, bit for bit."""
    rng = np.random.default_rng(T)
    rows, K, out_f = 40, 256, 48
    x = torch.from_numpy(_f32(rng, rows, K))
    w = torch.from_numpy(_f32(rng, out_f, K, scale=0.05))
    b = torch.from_numpy(_f32(rng, out_f, scale=0.1))
    whole_xq, s_x = int8.quantize_rows(x)
    whole_wq, s_w = int8.quantize_weight(w)
    whole = int8.int8_product_plain(whole_xq, whole_wq)
    xs, ws = x.chunk(T, dim=1), w.chunk(T, dim=1)
    x_max = torch.stack([int8.row_maxima(p) for p in xs]).amax(0)
    w_max = torch.stack([int8.channel_maxima(p) for p in ws]).amax(0)
    acc = torch.zeros(rows, out_f, dtype=torch.int32)
    for m in range(T):
        xq, sx = int8.quantize_rows(xs[m], x_max)
        wq, sw = int8.quantize_weight(ws[m], w_max)
        assert torch.equal(xq, whole_xq.chunk(T, dim=1)[m])
        assert torch.equal(wq, whole_wq.chunk(T, dim=1)[m])
        assert torch.equal(sx, s_x) and torch.equal(sw, s_w)
        acc += int8.int8_product_plain(xq, wq)
    assert torch.equal(acc, whole)
    got = int8.int8_output(acc, s_x, s_w, b, torch.float32)
    assert torch.equal(got, int8.int8_linear(x, w, b, torch.float32))
    # without a process group the row-parallel product is the whole one
    assert torch.equal(int8.int8_linear_row_parallel(x, w, b, torch.float32),
                       got)


def test_ffn_train_partial_at_rate_0_without_b2_is_ffn_block_partial():
    """#9's partial mode at rate 0 on a shard that adds no b2 computes #3's
    partial mode, bit for bit (on the card the same launch)."""
    *args, _ = _ffn_inputs(7, 2, 9)
    x, w1, b1, w2 = _t(args[0], args[1].T, args[2], args[3].T)
    got = ffn_train.fused_ffn_block_train_partial_fwd(x, w1, b1, w2, None,
                                                      5, 0.0)
    assert torch.equal(got, fused_ffn_block_partial(x, w1, b1, w2))


@pytest.mark.parametrize("which", ["v2", "ffn_fwd", "ffn_bwd"])
def test_partial_wrappers_refuse_mismatched_shards(which):
    """A shard whose pieces disagree in shape raises before any compute,
    on the CPU as on the card."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_f32(rng, 2, 5, H))
    if which == "v2":
        w_qkv, b_qkv = (torch.zeros(3 * 32, H), torch.zeros(3 * 32))
        bias = torch.zeros(2, 1, 1, 5)
        with pytest.raises(ValueError, match="wo must be"):
            fused_attn_block_v2_partial(x, w_qkv, b_qkv, bias,
                                        torch.zeros(H, 48), 2)
        return
    w1, b1, w2 = torch.zeros(64, H), torch.zeros(64), torch.zeros(H, 32)
    with pytest.raises(ValueError, match="w2"):
        if which == "ffn_fwd":
            ffn_train.fused_ffn_block_train_partial_fwd(x, w1, b1, w2, None,
                                                        1, 0.1)
        else:
            ffn_train.fused_ffn_block_train_partial_bwd(
                x, w1, b1, w2, 1, 0.1, torch.zeros(2, 5, H))
