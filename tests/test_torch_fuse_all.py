"""The attention-block gate's switch ``UC2_FUSE_ATTN_ALL``: with it set,
the reference's ``fused_block_profitable`` fuses the attention block at
every joint length (its own way to A/B the fused block end to end), and
the port's gate must say the same, so that the encoder routes L < 128
through #2 (``fused_attn_block``), or #7 (``fused_attn_block_v2``) under
``UC2_ATTN_V2=1``, as the reference does.

The reference fuses only where ``_on_tpu()`` holds; these tests patch its
encoder's ``_on_tpu`` to return True and run it under
``pltpu.force_tpu_interpret_mode()``, so that its Pallas blocks run in
interpret mode, each reference call one ``jax.jit`` program (see
tests/test_torch_routes.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models import encoder as jax_encoder
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.ops import fused_block as jfb
from uc2_torch.config import UC2Config
from uc2_torch.models import encoder as port_encoder
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.ops import fused_block as pfb

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)      # a whole model, fp32
TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
GATE_LENGTHS = (17, 98, 127, 128, 162, 512)


@pytest.mark.parametrize("fuse_all", [None, "1"])
@pytest.mark.parametrize("L", GATE_LENGTHS)
def test_attn_block_gate_reads_fuse_attn_all(monkeypatch, fuse_all, L):
    """The port's gate equals the reference's with the switch set and
    unset: L >= 128 without it, every L with it."""
    if fuse_all is None:
        monkeypatch.delenv("UC2_FUSE_ATTN_ALL", raising=False)
    else:
        monkeypatch.setenv("UC2_FUSE_ATTN_ALL", fuse_all)
    got = pfb.fused_block_profitable(L, 12)
    assert got == jfb.fused_block_profitable(L, 12)
    assert got == (fuse_all is not None or L >= 128)


@pytest.fixture(scope="module")
def params():
    """Reference retrieval parameters, moved away from init."""
    tree = JaxRetrieval(JaxConfig(use_pallas_attention=False, **TINY)
                        ).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


def _batch(Lt=32, Nb=66, B=3, seed=1):
    """Joint L = Lt + Nb = 98, a padded text tail and padded regions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1
    mask = np.ones((B, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0
    return {"input_ids": ids,
            "img_feat": rng.standard_normal(
                (B, Nb, TINY["img_dim"])).astype(np.float32),
            "img_pos_feat": rng.random((B, Nb, 7)).astype(np.float32),
            "attn_mask": mask}


@pytest.mark.parametrize("v2", [None, "1"])
def test_fuse_attn_all_routes_l98_through_the_block(params, monkeypatch, v2):
    """"pallas" at joint L = 98 with UC2_FUSE_ATTN_ALL=1: the port's
    encoder calls #2 (or #7 with UC2_ATTN_V2=1) once a layer and no
    unfused attention, and its scores and sequence output match the
    reference's, which runs its Pallas blocks in interpret mode."""
    monkeypatch.setenv("UC2_FUSE_ATTN_ALL", "1")
    if v2 is None:
        monkeypatch.delenv("UC2_ATTN_V2", raising=False)
    else:
        monkeypatch.setenv("UC2_ATTN_V2", v2)
    monkeypatch.setattr(jax_encoder, "_on_tpu", lambda: True)
    calls = {"fused_attn_block": 0, "fused_attn_block_v2": 0}
    for name in calls:
        fn = getattr(port_encoder, name)
        monkeypatch.setattr(port_encoder, name,
                            lambda *a, _n=name, _f=fn, **kw: calls.__setitem__(
                                _n, calls[_n] + 1) or _f(*a, **kw))
    b = _batch()
    jm = JaxRetrieval(JaxConfig(use_pallas_attention=True, **TINY))
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
          for k, v in b.items()}
    with pltpu.force_tpu_interpret_mode():
        want_s = np.asarray(jax.jit(jm.scores)(params, jb))
        want_seq, _ = jax.jit(lambda p, bb: jm.encoder.apply(
            {"params": p}, input_ids=bb["input_ids"], img_feat=bb["img_feat"],
            img_pos_feat=bb["img_pos_feat"], attn_mask=bb["attn_mask"]))(
            params["roberta"], jb)
    port = UC2ForImageTextRetrieval(
        UC2Config(use_pallas_attention=True, **TINY), device="cpu",
        params=params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    with torch.no_grad():
        got_s = port.scores(tb)
        calls_scores = dict(calls)
        got_seq, _ = port.roberta(**tb)
    layers = TINY["num_hidden_layers"]
    used = "fused_attn_block" if v2 is None else "fused_attn_block_v2"
    assert calls_scores == {**{k: 0 for k in calls}, used: layers}
    np.testing.assert_allclose(got_s.numpy(), want_s, **MODEL_TOL)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq),
                               **MODEL_TOL)
