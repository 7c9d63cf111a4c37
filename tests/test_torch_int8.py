"""int8 serving (``quant="int8"``) in uc2_torch against the reference's
``int8_matmul`` path at fp32 on the CPU:

* ``int8_linear`` against ``int8_matmul`` at fp32 and bf16 inputs: the
  same int8 codes (activations and weights) and int32 sums, outputs within
  1e-6;
* the weight codes' cache follows in-place updates of the parameter;
* retrieval scores of the quantized model against the reference's
  ``quant="int8"`` scores at rtol = atol = 1e-4, under "pallas", "xla" and
  "fused-force", at joint L = 17 and 128; no fused block runs under int8,
  "fused-force" and ``UC2_ATTN_V2`` included, and #1's plain version does;
* a training call under int8 raises, and ``serving`` shares the training
  model's parameters;
* ``full_retrieval_eval`` under int8: the same R@K, and the score matrix
  within 1e-4 of the reference's, but where the reference's jitted
  program rounded an activation at a code's tie the other way: there the
  pair alone through the reference's eager forward gives the port's
  score, the codes at most one step apart;
* ``python -m uc2_torch.itm --quant int8`` against ``itm.py --quant
  int8`` on the same stores and checkpoint at dropout 0: per-step losses,
  validation and test R@K within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import itm as jax_itm
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.evalu import retrieval as jax_retrieval
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.encoder import int8_matmul
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.utils import logger as jax_logger
from uc2_torch import itm
from uc2_torch.config import UC2Config
from uc2_torch.data.memdb import synth_gallery
from uc2_torch.data.synth import synth_corpus
from uc2_torch.evalu import retrieval
from uc2_torch.models import encoder
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.ops import flash_attention as fa
from uc2_torch.ops import int8
from uc2_torch.ops.dropout import DropoutRng

TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
LENGTHS = [(10, 7), (62, 66)]          # joint L = 17 and 128


def _reference_codes(x, kernel):
    """The codes and sums of ``int8_matmul``, line for line."""
    x32 = x.astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0,
                      1e-8)
    x_q = jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8)
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=0, keepdims=True)
                      / 127.0, 1e-12)
    w_q = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
    y = jax.lax.dot_general(x_q, w_q, (((x.ndim - 1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    return x_q, w_q, y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_int8_matmul(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 128)).astype(np.float32)
    x[0, 0] = 0.0                                   # a zero row: s_x floor
    x[1, 2, :5] = [3.0, -3.0, 1.5, 0.5 * 127, -127.0]  # ties at the codes
    w = (rng.standard_normal((192, 128)) * 0.02).astype(np.float32)
    w[7] = 0.0                                      # a zero channel
    b = (rng.standard_normal(192) * 0.01).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    x_q, w_q, y = map(np.asarray, _reference_codes(jx, jnp.asarray(w.T)))
    want = np.asarray(int8_matmul(jx, jnp.asarray(w.T), jnp.dtype(dtype))
                      + jnp.asarray(b).astype(dtype)).astype(np.float32)

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    got_xq, _ = int8.quantize_rows(tx.reshape(-1, 128))
    got_wq, _ = int8.quantize_weight(torch.from_numpy(w))
    assert np.array_equal(got_xq.numpy(), x_q.reshape(-1, 128))
    assert np.array_equal(got_wq.numpy(), w_q.T)
    sums = int8.int8_product(got_xq, got_wq)
    assert sums.dtype == torch.int32
    assert np.array_equal(sums.numpy(), y.reshape(-1, 192))
    assert np.array_equal(int8.int8_product_plain(got_xq, got_wq).numpy(),
                          (got_xq.long() @ got_wq.long().t()).numpy())
    got = int8.int8_linear(tx, torch.from_numpy(w), torch.from_numpy(b), tdt)
    assert got.dtype == tdt and got.shape == (3, 40, 192)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_weight_codes_follow_updates():
    """Cached once per weight version: a second call reuses the codes; an
    in-place update (an optimizer step, a loaded state) quantizes again."""
    w = torch.nn.Parameter(torch.randn(64, 32) * 0.02)
    first = int8.weight_codes(w)
    assert int8.weight_codes(w) is first
    opt = torch.optim.SGD([w], lr=1.0)
    w.grad = torch.randn_like(w) * 0.01
    opt.step()
    after = int8.weight_codes(w)
    fresh = int8.quantize_weight(w)
    assert after is not first and not torch.equal(after[0], first[0])
    assert torch.equal(after[0], fresh[0]) and torch.equal(after[1],
                                                           fresh[1])
    with torch.no_grad():
        w.copy_(torch.randn(64, 32))
    assert torch.equal(int8.weight_codes(w)[0], int8.quantize_weight(w)[0])


@pytest.fixture(scope="module")
def params():
    tree = JaxRetrieval(JaxConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, tree)


def _batch(Lt, Nb, B=3, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1
    mask = np.ones((B, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0
    return {"input_ids": ids,
            "img_feat": rng.standard_normal((B, Nb, TINY["img_dim"])).astype(
                np.float32),
            "img_pos_feat": rng.random((B, Nb, 7)).astype(np.float32),
            "attn_mask": mask}


@pytest.mark.parametrize("Lt,Nb", LENGTHS)
@pytest.mark.parametrize("impl", [True, False, "fused-force"])
def test_int8_scores_match_reference(params, impl, Lt, Nb):
    b = _batch(Lt, Nb)
    jm = JaxRetrieval(JaxConfig(use_pallas_attention=impl, quant="int8",
                                **TINY))
    want = np.asarray(jm.scores(
        params, {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64
                                else None) for k, v in b.items()},
        deterministic=True)).ravel()
    port = UC2ForImageTextRetrieval(UC2Config(use_pallas_attention=impl,
                                              **TINY), device="cpu",
                                    params=params).serving("int8")
    got = port.scores({k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl,v2", [("fused-force", False),
                                     ("fused-force", True), (True, False)])
def test_int8_takes_no_fused_block(params, impl, v2, monkeypatch):
    calls = {"fused": 0, "flash": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name in ("fused_attn_block", "fused_attn_block_v2",
                 "fused_ffn_block"):
        monkeypatch.setattr(encoder, name,
                            counted("fused", getattr(encoder, name)))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        counted("flash", fa.flash_attention_plain))
    if v2:
        monkeypatch.setenv("UC2_ATTN_V2", "1")
    model = UC2ForImageTextRetrieval(UC2Config(
        use_pallas_attention=impl, **TINY), device="cpu", params=params)
    b = {k: torch.from_numpy(v) for k, v in _batch(62, 66).items()}
    model.scores(b)
    assert calls == {"fused": 4, "flash": 0}
    calls.update(fused=0)
    assert torch.isfinite(model.serving("int8").scores(b)).all()
    assert calls == {"fused": 0, "flash": 2}


def test_int8_training_raises_and_serving_shares_parameters(params):
    model = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu",
                                     params=params)
    q8 = model.serving("int8")
    assert model.serving("none") is model and q8.serving("int8") is q8
    assert q8.config.quant == "int8" == q8.roberta.layer[1].config.quant
    assert model.config.quant == "none"
    assert all(a is b for a, b in zip(model.parameters(), q8.parameters()))
    assert [n for n, _ in model.named_parameters()] == [
        n for n, _ in q8.named_parameters()]
    b = {k: torch.from_numpy(v) for k, v in _batch(10, 7).items()}
    with pytest.raises(NotImplementedError, match="int8"):
        q8.scores(b, deterministic=False, rng=DropoutRng(0, "cpu"))
    before = q8.scores(b)
    with torch.no_grad():                     # an update of the shared tree
        model.roberta.layer[0].intermediate_dense.weight.mul_(1.5)
    after = q8.scores(b)
    assert not torch.equal(before, after)
    fresh = UC2ForImageTextRetrieval(UC2Config(quant="int8", **TINY),
                                     device="cpu")
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(fresh.scores(b), after)


def test_int8_full_retrieval_eval_matches_reference():
    cfg = dict(TINY, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64, img_dim=16,
               max_position_embeddings=64, use_pallas_attention=True)
    txt_db, img_db = synth_gallery(seed=3, n_imgs=14, txt_per_img=1,
                                   vocab=1000, img_dim=16, min_bb=4,
                                   max_bb=120)
    jm = JaxRetrieval(JaxConfig(quant="int8", **cfg))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.2,
        params)
    want, (wm, wt, wi) = jax_retrieval.full_retrieval_eval(
        jm, params, txt_db, img_db, 22, 120, batch_size=8,
        return_matrix=True)
    port = UC2ForImageTextRetrieval(UC2Config(**cfg), device="cpu",
                                    params=params).serving("int8")
    got, (m, t, i) = retrieval.full_retrieval_eval(
        port, txt_db, img_db, 22, 120, batch_size=8, return_matrix=True,
        device="cpu")
    assert (t, i) == (wt, wi)
    assert m.std() > 1e-3                     # scores that rank
    assert got == want
    # The reference scores the gallery in one jitted program, whose fused
    # fp32 sums can round an activation that sits at a code's tie the
    # other way than its own eager forward does; one code step moves a
    # score by ~5e-3 here. Each entry beyond 1e-4 must be such a tie:
    # the pair scored alone through the reference's eager forward and the
    # port, each product's int8 codes recorded, gives the port's entry
    # within 1e-4 with codes at most one step apart.
    off = np.argwhere(~np.isclose(m, wm, **TOL))
    assert len(off) <= 0.05 * m.size, off
    for r, c in off:
        ref_codes, port_codes, ref_score = _pair_codes(
            jm, params, port, txt_db, img_db, t[r], i, c)
        assert abs(ref_score - wm[r, c]) > 1e-4       # the reference's tie
        np.testing.assert_allclose(m[r, c], ref_score, **TOL)
        assert len(ref_codes) == len(port_codes) == 4
        for a, b in zip(ref_codes, port_codes):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _pair_codes(jm, params, port, txt_db, img_db, txt_id, img_ids, c):
    """(the reference's eager codes, the port's codes, the reference's
    eager score) of one (text, image) pair, padded to its bucket as
    ``full_retrieval_eval`` pads it."""
    import uc2_tpu.models.encoder as jax_encoder
    edges = retrieval.bucket_edges(22, 120)
    feats, bb7, nbbs = retrieval.load_image_gallery(img_db, img_ids, 120)
    nb = edges[int(np.searchsorted(np.asarray(edges), nbbs[c]))]
    ids, tm = retrieval._text_rows(txt_db, [txt_id], 22)
    b = {"input_ids": ids, "img_feat": feats[c:c + 1, :nb],
         "img_pos_feat": bb7[c:c + 1, :nb],
         "attn_mask": np.concatenate(
             [tm, (np.arange(nb)[None] < nbbs[c]).astype(np.int64)], 1)}
    ref_codes, port_codes = [], []
    ref_matmul, port_rows = jax_encoder.int8_matmul, int8.quantize_rows

    def ref_recorded(x, kernel, out_dtype):
        ref_codes.append(np.asarray(_reference_codes(x, kernel)[0]).reshape(
            -1, x.shape[-1]))
        return ref_matmul(x, kernel, out_dtype)

    def port_recorded(x2):
        out = port_rows(x2)
        port_codes.append(out[0].numpy())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_encoder, "int8_matmul", ref_recorded)
        mp.setattr(int8, "quantize_rows", port_recorded)
        score = float(np.asarray(jm.scores(params, {
            k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in b.items()}))[0])
        port.scores({k: torch.from_numpy(v) for k, v in b.items()})
    return ref_codes, port_codes, score


DRIVER = {"vocab_size": 512, "hidden_size": 32, "num_hidden_layers": 1,
          "num_attention_heads": 2, "intermediate_size": 64,
          "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
          "use_pallas_attention": True}


def _driver_argv(root, store, out):
    return [
        "--model_config", str(root / "tiny.json"), "--output_dir", str(out),
        "--train_txt_db", store["txt_db"], "--train_img_db", store["img_db"],
        "--val_txt_db", store["txt_db"], "--val_img_db", store["img_db"],
        "--test_datasets", json.dumps([{"name": "synth",
                                        "db": store["txt_db"],
                                        "img": store["img_db"]}]),
        "--max_txt_len", "16", "--max_bb", "8", "--min_bb", "4",
        "--train_batch_size", "24", "--eval_batch_size", "8",
        "--num_train_steps", "2", "--warmup_steps", "1",
        "--learning_rate", "3e-3", "--valid_steps", "1",
        "--save_steps", "100", "--log_steps", "1", "--dtype", "float32",
        "--seed", "0", "--dropout", "0", "--checkpoint",
        str(root / "uc2.pt"), "--quant", "int8"]


def _scalars(out):
    got = {}
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step")
            for k, v in rec.items():
                got.setdefault(k, []).append((step, v))
    return got


def test_itm_driver_int8_matches_reference(tmp_path):
    """Validation after each of two steps and the test evaluation, both
    scored under int8, over one store; training in fp32."""
    store = synth_corpus(str(tmp_path / "c"), n_imgs=10, seed=9,
                         txt_per_img=2, min_bb=4, max_bb=8, img_dim=16,
                         n_classes=11, max_words=6, vocab=512)
    with open(tmp_path / "tiny.json", "w") as f:
        json.dump(DRIVER, f)
    params = JaxRetrieval(JaxConfig(**DRIVER)).init_params(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2, params)
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(params).items()},
               tmp_path / "uc2.pt")
    ref_losses = []
    meter_call = jax_logger.RunningMeter.__call__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_logger.RunningMeter, "__call__",
                   lambda self, v: ref_losses.append(v)
                   or meter_call(self, v))
        argv = _driver_argv(tmp_path, store, tmp_path / "ref")
        parser = jax_itm.build_parser()
        opts = jax_itm.parse_with_config(parser, argv)
        jax_itm.apply_reference_config_compat(opts, parser, argv)
        jax_itm.main(opts)
    argv = _driver_argv(tmp_path, store, tmp_path / "port") + [
        "--device", "cpu"]
    parser = itm.build_parser()
    opts = itm.parse_with_config(parser, argv)
    itm.apply_reference_config_compat(opts, parser, argv)
    run = itm.main(opts)
    assert run.step == 2 and len(ref_losses) == 2
    np.testing.assert_allclose([v for _, v in run.losses], ref_losses,
                               rtol=1e-4)
    ref, port = _scalars(tmp_path / "ref"), _scalars(tmp_path / "port")
    names = sorted(k for k in ref if k.startswith("val_"))
    assert names and names == sorted(k for k in port
                                     if k.startswith("val_"))
    for k in names:
        assert len(ref[k]) == 2
        assert [s for s, _ in port[k]] == [s for s, _ in ref[k]]
        np.testing.assert_allclose([v for _, v in port[k]],
                                   [v for _, v in ref[k]], rtol=1e-4,
                                   err_msg=k)
    with open(tmp_path / "ref" / "test_results.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "test_results.json") as f:
        got = json.load(f)
    assert got.keys() == want.keys() == {"synth"}
    assert got["synth"].keys() == want["synth"].keys()
    for k in want["synth"]:
        np.testing.assert_allclose(got["synth"][k], want["synth"][k],
                                   rtol=1e-4, err_msg=k)
