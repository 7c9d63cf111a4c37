"""uc2_torch kernel modules on the CPU: each wrapper's plain version against
the reference package's Pallas kernel (interpret mode) at fp32, with the
JAX kernel tests' own bar, and the wrapper's input checks; the training
attention's and the training FFN block's dropout (Philox known answers,
keep statistics, each backward as the gradient of its forward) and
``einsum_f32``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from uc2_tpu.ops.attention import _xla_attention
from uc2_tpu.ops import fused_block as jfb
from uc2_tpu.ops.ffn_train import fused_ffn_block_train as jax_fft
from uc2_tpu.ops.flash_attention import flash_attention_train as jax_fat
from uc2_tpu.ops.mp import einsum_f32 as jax_einsum_f32
from uc2_torch.ops.flash_attention import (
    flash_attention, flash_attention_train, flash_attention_train_bwd_dkdv,
    flash_attention_train_bwd_dq, flash_attention_train_bwd_plain,
    flash_attention_train_fwd, flash_attention_train_plain)
from uc2_torch.ops.fused_block import (fused_attn_block, fused_block_profitable,
                                       fused_ffn_block, fused_ffn_block_plain,
                                       fused_ffn_profitable,
                                       fused_layer_profitable)
from uc2_torch.ops.ffn_train import (
    fused_ffn_block_train, fused_ffn_block_train_bwd,
    fused_ffn_block_train_bwd_plain, fused_ffn_block_train_fwd,
    fused_ffn_block_train_plain)
from uc2_torch.ops.mp import einsum_f32
from uc2_torch.ops.philox import (ffn_dropout_bits, ffn_keep_mask, keep_mask,
                                  philox4x32)

TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bias(rng, B, L):
    """Additive padding mask: each row keeps a random prefix of >= L/2 keys."""
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        mask[b, :int(rng.integers(L // 2, L + 1))] = 1.0
    return ((1.0 - mask) * -10000.0)[:, None, None, :]


def _ln_params(rng, H):
    return (1.0 + _f32(rng, H, scale=0.1)), _f32(rng, H, scale=0.1)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,n", [(2, 98, 4), (2, 162, 4), (1, 98, 12)])
def test_flash_attention_plain_matches_pallas(B, L, n):
    from jax.experimental.pallas import tpu as pltpu
    from uc2_tpu.ops.flash_attention import flash_attention as jax_flash
    rng = np.random.default_rng(L + n)
    q, k, v = (_f32(rng, B, L, n, 64) for _ in range(3))
    bias = _bias(rng, B, L)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, bias))))
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v, bias)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v, bias)))),
        **TOL)
    assert flash_attention.launches == before     # CPU: no kernel launch


# the shapes of the reference's tests, and the edges of the CUDA kernel's
# 64-row query and key tiles
@pytest.mark.parametrize("B,L,n,d", [(4, 48, 2, 16), (2, 130, 4, 16),
                                     (1, 128, 12, 64), (2, 63, 2, 16),
                                     (1, 64, 2, 16), (2, 65, 2, 16),
                                     (1, 129, 2, 16)])
def test_fused_attn_block_plain_matches_pallas(B, L, n, d):
    H = n * d
    rng = np.random.default_rng(B * L + d)
    q, k, v = (_f32(rng, B, L, n, d) for _ in range(3))
    x = _f32(rng, B, L, H)
    wo, bo = _f32(rng, H, H, scale=0.05), _f32(rng, H, scale=0.02)
    gamma, beta = _ln_params(rng, H)
    bias = _bias(rng, B, L)
    want = np.asarray(jfb.fused_attn_block(
        *map(jnp.asarray, (q, k, v, bias, x, wo, bo, gamma, beta)),
        eps=1e-12, interpret=True))
    # the port takes nn.Linear weights ([out, in])
    got = fused_attn_block(*_t(q, k, v, bias, x, np.ascontiguousarray(wo.T),
                               bo, gamma, beta), eps=1e-12).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("B,L,H,F", [(2, 30, 32, 128), (1, 98, 768, 3072)])
def test_fused_ffn_block_plain_matches_pallas(B, L, H, F):
    rng = np.random.default_rng(L + H)
    x = _f32(rng, B, L, H)
    w1, b1 = _f32(rng, H, F, scale=0.05), _f32(rng, F, scale=0.02)
    w2, b2 = _f32(rng, F, H, scale=0.05), _f32(rng, H, scale=0.02)
    gamma, beta = _ln_params(rng, H)
    want = np.asarray(jfb.fused_ffn_block(
        *map(jnp.asarray, (x, w1, b1, w2, b2, gamma, beta)), eps=1e-12,
        interpret=True))
    got = fused_ffn_block(*_t(x, np.ascontiguousarray(w1.T), b1,
                              np.ascontiguousarray(w2.T), b2, gamma, beta),
                          eps=1e-12).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_versions_round_where_the_kernels_round():
    """On bf16 inputs the plain versions compute in fp32 and return bf16."""
    rng = np.random.default_rng(7)
    B, L, n, d = 2, 20, 2, 16
    H = n * d
    q, k, v = (torch.from_numpy(_f32(rng, B, L, n, d)).bfloat16()
               for _ in range(3))
    bias = torch.from_numpy(_bias(rng, B, L))
    ctx = flash_attention(q, k, v, bias)
    assert ctx.dtype == torch.bfloat16
    x = torch.from_numpy(_f32(rng, B, L, H)).bfloat16()
    wo = torch.from_numpy(_f32(rng, H, H, scale=0.05)).bfloat16()
    vec = [torch.from_numpy(a) for a in (_f32(rng, H), *_ln_params(rng, H))]
    out = fused_attn_block(q, k, v, bias, x, wo, *vec)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def _attn_block_args(B=2, L=8, n=2, d=16):
    rng = np.random.default_rng(0)
    H = n * d
    q, k, v = (torch.from_numpy(_f32(rng, B, L, n, d)) for _ in range(3))
    return dict(q=q, k=k, v=v, bias=torch.zeros(B, 1, 1, L),
                x=torch.zeros(B, L, H), wo=torch.zeros(H, H),
                bo=torch.zeros(H), gamma=torch.ones(H), beta=torch.zeros(H))


@pytest.mark.parametrize("bad", ["k_shape", "bias_shape", "wo_shape",
                                 "meta_device"])
def test_attention_wrappers_raise_on_inputs_they_do_not_take(bad):
    a = _attn_block_args()
    if bad == "k_shape":
        a["k"] = a["k"][:, :-1]
    elif bad == "bias_shape":
        a["bias"] = torch.zeros(2, 8)
    elif bad == "wo_shape":
        a["wo"] = torch.zeros(32, 16)
    else:   # neither CPU nor CUDA: no plain fallback for other devices
        a = {key: t.to("meta") for key, t in a.items()}
    with pytest.raises(ValueError):
        fused_attn_block(**a)
    if bad != "wo_shape":
        with pytest.raises(ValueError):
            flash_attention(a["q"], a["k"], a["v"], a["bias"])


def test_ffn_wrapper_raises_on_inputs_it_does_not_take():
    H, F = 32, 64
    args = [torch.zeros(2, 5, H), torch.zeros(F, H), torch.zeros(F),
            torch.zeros(H, F), torch.zeros(H), torch.ones(H), torch.zeros(H)]
    bad_w2 = list(args)
    bad_w2[3] = torch.zeros(F, H)        # reference layout, not [out, in]
    with pytest.raises(ValueError):
        fused_ffn_block(*bad_w2)
    with pytest.raises(ValueError):
        fused_ffn_block(*[t.to("meta") for t in args])


def test_gates_match_reference():
    for L in (17, 98, 127, 128, 162, 512):
        assert fused_block_profitable(L, 12) == jfb.fused_block_profitable(
            L, 12)
        assert fused_ffn_profitable(L) == jfb.fused_ffn_profitable(L)
        assert fused_layer_profitable(L, 12) == jfb.fused_layer_profitable(
            L, 12)


# ------------------------------------------------- training attention (#5, #6)


def _train_inputs(seed, B=2, L=128, n=2, d=32):
    """The inputs of tests/test_flash_train.py: keys kept w.p. 0.8 and the
    first four always."""
    rng = np.random.default_rng(seed)
    q, k, v = (_f32(rng, B, L, n, d) for _ in range(3))
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    mask[:, :4] = 1.0
    return q, k, v, ((1.0 - mask) * -10000.0)[:, None, None, :]


def test_flash_attention_train_plain_matches_pallas():
    """rate 0: forward at 2e-5 and dq, dk, dv, dbias at 2e-4 against the
    Pallas training kernels in interpret mode (the JAX test's bars)."""
    import jax
    q, k, v, bias = _train_inputs(0)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jax_loss(*a):     # rate 0.0, interpret=True (positional: static)
        return jnp.sum(jax_fat(*a, jnp.int32(7), 0.0, True) * w)

    want_out = np.asarray(jax_fat(*map(jnp.asarray, (q, k, v, bias)),
                                  jnp.int32(7), 0.0, True))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    ts = [t.requires_grad_(True) for t in _t(q, k, v, bias)]
    before = (flash_attention_train_fwd.launches,
              flash_attention_train_bwd_dq.launches,
              flash_attention_train_bwd_dkdv.launches)
    out = flash_attention_train(*ts, 7, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for t, want, name in zip(ts, want_grads, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert (flash_attention_train_fwd.launches,       # CPU: no launches
            flash_attention_train_bwd_dq.launches,
            flash_attention_train_bwd_dkdv.launches) == before


def test_flash_attention_train_bwd_plain_is_the_gradient():
    """rate 0.3, float64: the backward formula is the gradient of the
    forward under one seed (so both draw the same mask)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 4)))
               .requires_grad_(True) for _ in range(3))
    mask = np.ones((1, 6))
    mask[0, 4:] = 0.0
    bias = torch.from_numpy(((1.0 - mask) * -10000.0)[:, None, None, :]
                            ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda *a: flash_attention_train(*a, 11, 0.3), (q, k, v, bias))
    g = torch.from_numpy(rng.standard_normal((1, 6, 2, 4)))
    out = flash_attention_train_plain(q, k, v, bias, 11, 0.3)
    auto = torch.autograd.grad(out, (q, k, v, bias), g)
    for a, b in zip(flash_attention_train_bwd_plain(q, k, v, bias, 11, 0.3,
                                                    g), auto):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_dropout_statistics_by_the_identity_trick():
    """q = k = 0, bias 0, v = I (L = d): the output is the dropped and
    rescaled probability matrix (tests/test_flash_train.py:61)."""
    rate, L = 0.5, 128
    q = torch.zeros(1, L, 1, L)
    v = torch.eye(L).reshape(1, L, 1, L)
    bias = torch.zeros(1, 1, 1, L)
    out = flash_attention_train(q, q, v, bias, 3, rate)
    pd = out.reshape(L, L).numpy()
    nz = pd[pd > 1e-9]
    np.testing.assert_allclose(nz, 1.0 / (L * (1.0 - rate)), rtol=1e-6)
    assert abs((pd > 1e-9).mean() - (1.0 - rate)) < 0.03
    assert torch.equal(out, flash_attention_train(q, q, v, bias, 3, rate))
    assert not torch.equal(out, flash_attention_train(q, q, v, bias, 4, rate))
    assert np.array_equal(pd > 1e-9,
                          keep_mask(3, rate, 1, 1, L, L)[0, 0].numpy())


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    words = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                       *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec,sa,sb", [
    ("...h,vh->...v", (3, 5, 16), (40, 16)),
    ("blnd,bmnd->bnlm", (2, 7, 3, 8), (2, 7, 3, 8)),
])
def test_einsum_f32_matches_reference(spec, sa, sb, dtype):
    import jax
    rng = np.random.default_rng(len(spec))
    a, b = _f32(rng, *sa), _f32(rng, *sb)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    out_shape = jax.eval_shape(lambda x, y: jax_einsum_f32(spec, x, y),
                               ja, jb).shape
    w = _f32(rng, *out_shape)
    want = np.asarray(jax_einsum_f32(spec, ja, jb))
    wga, wgb = jax.grad(lambda x, y: jnp.sum(jax_einsum_f32(spec, x, y) * w),
                        argnums=(0, 1))(ja, jb)
    ta = torch.from_numpy(a).to(tdt).requires_grad_(True)
    tb = torch.from_numpy(b).to(tdt).requires_grad_(True)
    out = einsum_f32(spec, ta, tb)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    # bf16 gradients: both round the same fp32 sums to bf16 (one ulp apart
    # at most where the sums' order differs)
    gt = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-2)
    for got, ref in ((ta.grad, wga), (tb.grad, wgb)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)), **gt)


# ------------------------------------------------- training FFN block (#9, #10)
FFN_NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def _ffn_inputs(seed, B, L, H=64, F=128):
    """The inputs of tests/test_ffn_train.py, weights in the reference's
    [in, out] layout."""
    rng = np.random.default_rng(seed)
    return (_f32(rng, B, L, H), _f32(rng, H, F, scale=0.05),
            _f32(rng, F, scale=0.01), _f32(rng, F, H, scale=0.05),
            _f32(rng, H, scale=0.01), 1.0 + _f32(rng, H, scale=0.1),
            _f32(rng, H, scale=0.1))


def _linear_layout(x, w1, b1, w2, b2, g, be):
    return (x, np.ascontiguousarray(w1.T), b1, np.ascontiguousarray(w2.T),
            b2, g, be)


@pytest.mark.parametrize("B,L", [(2, 16), (1, 9)])
def test_fused_ffn_block_train_plain_matches_pallas(B, L):
    """rate 0: the output at 2e-5 and all seven gradients at 5e-4 against
    the Pallas kernels in interpret mode (tests/test_ffn_train.py's bars),
    on a row count that fills the kernel's tile and on a ragged one."""
    import jax
    args = _ffn_inputs(0, B, L)

    def jax_loss(*a):
        return jnp.sum(jnp.sin(jax_fft(*a, 0, 0.0, 1e-12, True)))

    want = np.asarray(jax_fft(*map(jnp.asarray, args), 0, 0.0, 1e-12, True))
    want_grads = jax.grad(jax_loss, argnums=tuple(range(7)))(
        *map(jnp.asarray, args))
    ts = [t.requires_grad_(True) for t in _t(*_linear_layout(*args))]
    before = (fused_ffn_block_train_fwd.launches,
              fused_ffn_block_train_bwd.launches)
    out = fused_ffn_block_train(*ts, 0, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    torch.sin(out).sum().backward()
    for t, w, name in zip(ts, want_grads, FFN_NAMES):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w.T if name in ("w1", "w2")
                                   else w, rtol=5e-4, atol=5e-4, err_msg=name)
    assert (fused_ffn_block_train_fwd.launches,        # CPU: no launches
            fused_ffn_block_train_bwd.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_train_at_rate_0_is_the_ffn_block(dtype):
    """#9 is #3 with a dropout step: at rate 0 the port's plain #9 equals
    its plain #3 bit for bit, and the reference's training FFN kernel
    equals its inference FFN kernel (both in interpret mode)."""
    args = _ffn_inputs(12, 2, 9, H=64, F=128)
    ts = [t.to(getattr(torch, dtype)) if i in (0, 1, 3) else t
          for i, t in enumerate(_t(*_linear_layout(*args)))]
    got = fused_ffn_block_train_plain(*ts, 5, 0.0)
    assert got.dtype == ts[0].dtype
    assert torch.equal(got, fused_ffn_block_plain(*ts))
    jargs = [jnp.asarray(a) for a in args]
    if dtype == "bfloat16":
        for i in (0, 1, 3):
            jargs[i] = jargs[i].astype(jnp.bfloat16)
    train = jax_fft(*jargs, 0, 0.0, 1e-12, True)
    block = jfb.fused_ffn_block(*jargs, eps=1e-12, interpret=True)
    np.testing.assert_array_equal(np.asarray(train.astype(jnp.float32)),
                                  np.asarray(block.astype(jnp.float32)))


def test_fused_ffn_block_train_bwd_plain_is_the_gradient():
    """rate 0.3, float64: the backward formula is the gradient of the
    forward under one seed (so both draw the same mask)."""
    rng = np.random.default_rng(5)
    H, F = 8, 12
    args = [torch.from_numpy(a) for a in (
        rng.standard_normal((1, 6, H)), rng.standard_normal((F, H)) * 0.3,
        rng.standard_normal(F) * 0.1, rng.standard_normal((H, F)) * 0.3,
        rng.standard_normal(H) * 0.1, 1.0 + rng.standard_normal(H) * 0.1,
        rng.standard_normal(H) * 0.1)]
    for a in args:
        a.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda *a: fused_ffn_block_train(*a, 11, 0.3), args)
    dy = torch.from_numpy(rng.standard_normal((1, 6, H)))
    out = fused_ffn_block_train_plain(*args, 11, 0.3)
    auto = torch.autograd.grad(out, args, dy)
    got = fused_ffn_block_train_bwd_plain(*args[:6], 11, 0.3, 1e-12, dy)
    for a, b, name in zip(got, auto, FFN_NAMES):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_ffn_dropout_share_scale_and_stream():
    """The keep share, the 1/(1 - rate) scale on y2 = h.W2^T + b2 before
    the residual, one mask per seed, and the words: Philox4x32-10 of the
    counter (col // 4, row, 0, 1) under the key (seed, 0)."""
    rows, H, F, rate = 40, 64, 128, 0.3
    keep = ffn_keep_mask(5, rate, 512, H)
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 0.01
    assert torch.equal(keep, ffn_keep_mask(5, rate, 512, H))
    assert not torch.equal(keep, ffn_keep_mask(6, rate, 512, H))
    x, w1, b1, w2, b2, g, be = _ffn_inputs(1, 1, rows)
    x64 = x.reshape(rows, H).astype(np.float64)
    a = x64 @ w1 + b1
    from scipy.special import erf
    h = 0.5 * a * (1.0 + erf(a / np.sqrt(2.0)))
    k = ffn_keep_mask(9, rate, rows, H).numpy()
    y = np.where(k, (h @ w2 + b2) / (1.0 - rate), 0.0) + x64
    y = (y - y.mean(-1, keepdims=True)) / np.sqrt(y.var(-1, keepdims=True)
                                                  + 1e-12)
    got = fused_ffn_block_train_plain(*_t(*_linear_layout(x, w1, b1, w2, b2,
                                                          g, be)), 9, rate)
    np.testing.assert_allclose(got.reshape(rows, H).numpy(), y * g + be,
                               rtol=1e-4, atol=1e-4)
    bits = ffn_dropout_bits(5, 3, 10)
    for r in range(3):
        for c in range(10):
            words = philox4x32(*(torch.tensor([v], dtype=torch.int64)
                                 for v in (c // 4, r, 0, 1)), 5, 0)
            assert int(words[c % 4]) == int(bits[r, c])


def test_ffn_train_wrappers_raise_on_inputs_they_do_not_take():
    H, F = 32, 64
    args = [torch.zeros(2, 5, H), torch.zeros(F, H), torch.zeros(F),
            torch.zeros(H, F), torch.zeros(H), torch.ones(H), torch.zeros(H)]
    bad_w2 = list(args)
    bad_w2[3] = torch.zeros(F, H)        # reference layout, not [out, in]
    with pytest.raises(ValueError):
        fused_ffn_block_train_fwd(*bad_w2, 1, 0.1)
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        fused_ffn_block_train_fwd(*[t.to("meta") for t in args], 1, 0.1)
    for seed, rate in ((-1, 0.1), (2 ** 32, 0.1), (1, 1.0), (1, -0.1)):
        with pytest.raises(ValueError):
            fused_ffn_block_train(*args, seed, rate)
    with pytest.raises(ValueError):      # dy of another shape
        fused_ffn_block_train_bwd(*args[:6], 1, 0.1, 1e-12,
                                  torch.zeros(2, 4, H))
