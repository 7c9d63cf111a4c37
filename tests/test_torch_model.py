"""uc2_torch encoder and retrieval scores against the reference package at
fp32 on the CPU: same parameters (through models/convert.py), same inputs,
every position compared, under each attention routing and at joint
lengths below and at 128, where the gates switch kernels."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_torch.config import UC2Config
from uc2_torch.models import encoder as port_encoder
from uc2_torch.models.finetune import UC2ForImageTextRetrieval

TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = [False, "fused-force", True]
LENGTHS = [(10, 7), (62, 66)]          # joint L = 17 and 128


@pytest.fixture(scope="module")
def params():
    """Reference parameters, moved away from init (LayerNorm scales, biases)
    for a stronger test, plus the MRM mask embedding."""
    tree = JaxRetrieval(JaxConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)
    tree["roberta"]["img_embeddings"]["mask_embedding"] = rng.standard_normal(
        (2, TINY["img_dim"])).astype(np.float32) * 0.02
    return tree


def _batch(Lt, Nb, B=3, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1                  # padded text tail
    feat = rng.standard_normal((B, Nb, TINY["img_dim"])).astype(np.float32)
    pos = rng.random((B, Nb, 7)).astype(np.float32)
    mask = np.ones((B, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0           # padded regions
    return {"input_ids": ids, "img_feat": feat, "img_pos_feat": pos,
            "attn_mask": mask}


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in b.items()}


def _port(impl, params):
    return UC2ForImageTextRetrieval(UC2Config(use_pallas_attention=impl,
                                              **TINY),
                                    device="cpu", params=params)


def _encode_both(impl, params, b, img_masks=None):
    jm = JaxRetrieval(JaxConfig(use_pallas_attention=impl, **TINY))
    jb = _jax_batch(b)
    kw = {} if img_masks is None else {"img_masks": jnp.asarray(img_masks)}
    j_seq, j_pool = jm.encoder.apply(
        {"params": params["roberta"]}, input_ids=jb["input_ids"],
        img_feat=jb["img_feat"], img_pos_feat=jb["img_pos_feat"],
        attn_mask=jb["attn_mask"], **kw)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    kw = {} if img_masks is None else {"img_masks": torch.from_numpy(
        img_masks)}
    with torch.no_grad():
        t_seq, t_pool = _port(impl, params).roberta(**tb, **kw)
    return (np.asarray(j_seq), np.asarray(j_pool), t_seq.numpy(),
            t_pool.numpy())


@pytest.mark.parametrize("Lt,Nb", LENGTHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_matches_reference(params, impl, Lt, Nb):
    j_seq, j_pool, t_seq, t_pool = _encode_both(impl, params, _batch(Lt, Nb))
    np.testing.assert_allclose(t_seq, j_seq, **TOL)      # every position
    np.testing.assert_allclose(t_pool, j_pool, **TOL)


@pytest.mark.parametrize("impl", [False, "fused-force"])
def test_mrm_masked_encoder_matches_reference(params, impl):
    b = _batch(10, 7)
    img_masks = np.random.default_rng(2).random((3, 7)) < 0.4
    j_seq, j_pool, t_seq, t_pool = _encode_both(impl, params, b, img_masks)
    np.testing.assert_allclose(t_seq, j_seq, **TOL)
    np.testing.assert_allclose(t_pool, j_pool, **TOL)


@pytest.mark.parametrize("impl,Lt,Nb", [(False, 10, 7),
                                        ("fused-force", 62, 66)])
def test_scores_and_rank_loss_match_reference(params, impl, Lt, Nb):
    b = _batch(Lt, Nb, B=4)
    jm = JaxRetrieval(JaxConfig(use_pallas_attention=impl, **TINY))
    want = np.asarray(jm.scores(params, _jax_batch(b)))
    want_loss = np.asarray(jm.rank_loss(params, _jax_batch(b), 2,
                                        deterministic=True))
    tm = _port(impl, params)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(tm.scores(tb).numpy(), want, **TOL)
    np.testing.assert_allclose(tm.rank_loss(tb, 2).numpy(), want_loss, **TOL)


@pytest.mark.parametrize("impl,L,expect", [
    (True, 17, {"flash": 2, "attn_block": 0, "ffn_block": 2}),
    (True, 128, {"flash": 0, "attn_block": 2, "ffn_block": 2}),
    ("fused-force", 17, {"flash": 0, "attn_block": 2, "ffn_block": 2}),
    (False, 128, {"flash": 0, "attn_block": 0, "ffn_block": 0}),
])
def test_layer_routing_follows_the_gates(params, monkeypatch, impl, L,
                                         expect):
    """Which kernel wrapper each layer calls: the flash kernel below
    L = 128, the fused attention block from 128, the fused FFN block
    always (with the kernel impls); none under "xla"."""
    import uc2_torch.ops.flash_attention as fa
    calls = dict.fromkeys(expect, 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fa, "flash_attention",
                        counted("flash", fa.flash_attention))
    monkeypatch.setattr(port_encoder, "fused_attn_block",
                        counted("attn_block", port_encoder.fused_attn_block))
    monkeypatch.setattr(port_encoder, "fused_ffn_block",
                        counted("ffn_block", port_encoder.fused_ffn_block))
    Lt, Nb = (10, 7) if L == 17 else (62, 66)
    b = {k: torch.from_numpy(v) for k, v in _batch(Lt, Nb).items()}
    _port(impl, params).scores(b)
    assert calls == expect


@pytest.mark.parametrize("impl", ["flash", "bogus"])
def test_unported_attention_values_raise(params, monkeypatch, impl):
    """An unknown value raises. "flash", ported since, routes as the
    reference's wrapper of jax's library kernel: the segment-masked
    attention (kernels #12/#12a/#12b) at L >= 128, the eager chain below,
    and no fused block anywhere."""
    if impl == "bogus":
        b = {k: torch.from_numpy(v) for k, v in _batch(10, 7).items()}
        with pytest.raises(ValueError):
            _port(impl, params).scores(b)
        return
    from uc2_torch.ops import attention, segment_flash
    calls = {"segment": 0, "xla": 0, "block": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(segment_flash, "segment_flash_attention",
                        counted("segment",
                                segment_flash.segment_flash_attention))
    monkeypatch.setattr(attention, "xla_attention",
                        counted("xla", attention.xla_attention))
    for name in ("fused_attn_block", "fused_attn_block_v2",
                 "fused_ffn_block"):
        monkeypatch.setattr(port_encoder, name,
                            counted("block", getattr(port_encoder, name)))
    for (Lt, Nb), want in (((10, 7), {"segment": 0, "xla": 2, "block": 0}),
                           ((62, 66), {"segment": 2, "xla": 0, "block": 0})):
        calls.update(segment=0, xla=0, block=0)
        b = {k: torch.from_numpy(v) for k, v in _batch(Lt, Nb).items()}
        assert torch.isfinite(_port(impl, params).scores(b)).all()
        assert calls == want, (Lt, Nb)


def test_training_and_int8_raise(params):
    """int8 serving and activation recomputation (remat) are ported
    (tests/test_torch_int8.py, tests/test_torch_remat.py): what raises is a
    training call under int8, and a quant or remat value the reference
    does not know. Remat leaves a deterministic call as it is."""
    from uc2_torch.ops.dropout import DropoutRng
    b = {k: torch.from_numpy(v) for k, v in _batch(10, 7).items()}
    want = _port(True, params).scores(b)
    for remat in ("full", "dots"):
        model = UC2ForImageTextRetrieval(UC2Config(remat=remat, **TINY),
                                         device="cpu", params=params)
        assert torch.equal(model.scores(b), want)
    q8 = UC2ForImageTextRetrieval(UC2Config(quant="int8", **TINY),
                                  device="cpu", params=params)
    assert torch.isfinite(q8.scores(b)).all()
    with pytest.raises(NotImplementedError, match="int8"):
        q8.scores(b, deterministic=False, rng=DropoutRng(0, "cpu"))
    for bad in ({"quant": "int4"}, {"remat": "some"}):
        with pytest.raises(ValueError):
            UC2ForImageTextRetrieval(UC2Config(**bad, **TINY), device="cpu")
