"""The port's pretraining driver (``python -m uc2_torch.pretrain``) on each
pretraining objective and optimizer it took over from the reference's
pretrain.py: every task beyond the mix of config/uc2_pretrain.json
(mrfr, mrc, mrc-kl, mrm-nce, vmlm-soft with a soft-label store,
mmxlm-soft, mmxlm, itm-ot at lambda 0.1, tlm-ni with co-masking),
``--itm_hard_neg``, ``--optim adam`` and ``--optim adamax``, and the task
mix of config/demo_pretrain.json. Each runs both drivers from one UC2
``.pt`` checkpoint on stores the reference package writes, at a tiny
config (hidden 32, one layer, vocab 250002), dropout 0 and fp32: the
per-step logged losses and the validation logs (every key the reference
logs: loss, acc, mrm-nce's l2 and cos, itm-ot's ot_pos and ot_neg) agree
within 1e-4 relative. UC2 checkpoints hold no mrm-nce projection (the
UC2 model has none), so each driver keeps its own initialisation of that
head; the mrm-nce case loads the reference's into the port."""

import json

import numpy as np
import pytest
import torch

import jax

import pretrain as jax_pretrain
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data.labels import LabelVocab as JaxLabelVocab
from uc2_tpu.data.synth import synth_corpus
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_torch import pretrain
from uc2_torch.config import UC2Config
from uc2_torch.models import convert
from uc2_torch.models.convert import params_to_jax
from uc2_torch.models.pretraining import UC2ForPretraining

TINY = {"vocab_size": 250002, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": False}
CORPUS = dict(n_imgs=12, txt_per_img=2, min_bb=4, max_bb=10, img_dim=16,
              n_classes=11, vocab=250002, max_words=5)
RTOL = 1e-4
STEPS = 2
# case -> (store, tasks, more flags): "en" unpaired, "de" paired (the
# translation-pair records tlm-ni and the hard negatives read), "sl"
# unpaired with a precomputed soft-label store
CASES = {
    "mrfr": ("en", ["mrfr"], []),
    "mrc": ("en", ["mrc"], []),
    "mrc-kl": ("en", ["mrc-kl"], []),
    "mrm-nce": ("en", ["mrm-nce"], ["--nce_neg_size", "24"]),
    "vmlm-soft": ("sl", ["vmlm-soft"], []),
    "mmxlm-soft": ("en", ["mmxlm-soft"], []),
    "mmxlm": ("en", ["mmxlm"], []),
    "itm-ot": ("en", ["itm-ot"], ["--itm_ot_lambda", "0.1"]),
    "tlm-ni": ("de", ["tlm-ni"], []),
    "itm_hard_neg": ("de", ["itm"], ["--itm_hard_neg"]),
    "adam": ("en", ["mlm"], ["--optim", "adam"]),
    "adamax": ("en", ["mlm"], ["--optim", "adamax"]),
    "demo_pretrain": (None, None, []),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The stores, the tiny model config and a UC2 ``.pt`` checkpoint of
    every parameter (the port's initialisation under the reference's key
    names)."""
    root = tmp_path_factory.mktemp("objectives")
    n_valid = len(JaxLabelVocab(words={"en": [f"class{i}" for i in
                                              range(10)]}).valid_ids)
    stores = {"en": synth_corpus(str(root / "en"), seed=7, **CORPUS),
              "de": synth_corpus(str(root / "de"), seed=8, paired=True,
                                 **CORPUS),
              "sl": synth_corpus(str(root / "sl"), seed=9,
                                 soft_label_dim=n_valid, **CORPUS)}
    cfg = str(root / "tiny.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    tree = params_to_jax(UC2ForPretraining(UC2Config(**TINY), device="cpu",
                                           seed=3).state_dict())
    ckpt = str(root / "uc2.pt")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in
                jax_convert.params_to_torch_state_dict(tree).items()}, ckpt)
    return {"root": root, "stores": stores, "cfg": cfg, "ckpt": ckpt}


def _specs(setup, case):
    """(train, val) dataset specs of a case."""
    store, tasks, _ = CASES[case]
    stores = setup["stores"]
    if store is None:
        # config/demo_pretrain.json's specs, its stores replaced
        with open("config/demo_pretrain.json") as f:
            demo = json.load(f)
        paths = {"demo_en": stores["en"], "demo_pair": stores["de"],
                 "demo_val": stores["en"]}
        return [[dict(s, db=[paths[s["name"]]["txt_db"]],
                      img=[paths[s["name"]]["img_db"]]) for s in demo[k]]
                for k in ("train_datasets", "val_datasets")]
    paths = stores[store]
    spec = {"name": f"s_{store}", "language": "en" if store != "de" else
            "de", "db": [paths["txt_db"]], "img": [paths["img_db"]],
            "tasks": tasks, "mix_ratio": [1] * len(tasks)}
    if "soft_label_db" in paths:
        spec["img_token_soft_label"] = [paths["soft_label_db"]]
    return [spec], [dict(spec, name=f"v_{store}")]


def _argv(setup, case, out):
    train, val = _specs(setup, case)
    demo = CASES[case][0] is None
    steps = 2 * STEPS if demo else STEPS
    return (["--config", "config/demo_pretrain.json"] if demo else []) + [
        "--model_config", setup["cfg"], "--output_dir", str(out),
        "--checkpoint", setup["ckpt"],
        "--train_datasets", json.dumps(train),
        "--val_datasets", json.dumps(val),
        # max_txt_len 66: every text fits the first bucket (24, 10), B = 8
        "--max_txt_len", "66", "--max_bb", "10", "--min_bb", "4",
        "--label_classes", "11", "--train_batch_size", "256",
        "--num_train_steps", str(steps), "--warmup_steps", "1",
        "--valid_steps", str(steps),
        "--val_batches", "1", "--save_steps", "100", "--log_steps", "1",
        "--dropout", "0", "--dtype", "float32", "--seed", "0",
        *CASES[case][2]]


def _scalars(out):
    """{name: [(step, value)]} of a run's scalars.jsonl."""
    got = {}
    with open(out / "log" / "scalars.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step")
            for k, v in rec.items():
                got.setdefault(k, []).append((step, v))
    return got


def _reference_nce_head(monkeypatch):
    """Load the reference driver's initial mrm-nce projection (its
    ``init_params`` at the seed, 0) with the port's checkpoint."""
    nce = jax.jit(lambda key: JaxPretraining(JaxConfig(**TINY)).init_params(
        key)["nce_output"])(jax.random.PRNGKey(0))
    nce = jax.tree_util.tree_map(np.asarray, nce)
    orig = convert.load_partial_tree
    monkeypatch.setattr(convert, "load_partial_tree", lambda module, tree:
                        orig(module, dict(tree, nce_output=nce)))


@pytest.mark.parametrize("case", list(CASES))
def test_driver_matches_reference(setup, monkeypatch, case):
    if case == "mrm-nce":
        _reference_nce_head(monkeypatch)
    ref_out = setup["root"] / f"ref_{case}"
    port_out = setup["root"] / f"port_{case}"
    jax_pretrain.main(jax_pretrain.parse_with_config(
        jax_pretrain.build_parser(), _argv(setup, case, ref_out)))
    argv = _argv(setup, case, port_out) + ["--device", "cpu"]
    opts = pretrain.parse_with_config(pretrain.build_parser(), argv)
    pretrain.apply_reference_config_compat(opts, argv)
    run = pretrain.main(opts)
    assert run.step == (2 * STEPS if CASES[case][0] is None else STEPS)
    assert all(np.isfinite(v) for _, _, v in run.losses)
    ref, port = _scalars(ref_out), _scalars(port_out)
    names = sorted(k for k in ref if k.startswith(("loss/", "valid_")))
    assert names == sorted(k for k in port
                           if k.startswith(("loss/", "valid_")))
    assert any(k.startswith("valid_") for k in names)
    for k in names:
        assert [s for s, _ in port[k]] == [s for s, _ in ref[k]], k
        np.testing.assert_allclose([v for _, v in port[k]],
                                   [v for _, v in ref[k]], rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    want = {"mrm-nce": ("l2", "cos"), "itm-ot": ("ot_pos", "ot_neg")}
    for key in want.get(case, ()):
        assert any(k.startswith("valid_") and k.endswith(f"_{key}")
                   for k in names), key
