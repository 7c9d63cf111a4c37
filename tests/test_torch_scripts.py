"""The port's counterparts of four of the repository's scripts against the
scripts themselves (each loaded by path), on the CPU:

* ``python -m uc2_torch.make_demo_data``: the same files under the two
  roots, byte for byte, sidecar JSONs included;
* ``python -m uc2_torch.collate_bench``: the same examples from the same
  seed, ``collate_batch`` equal to the reference's bit for bit in the four
  cases, and the reference's RESULT lines;
* ``python -m uc2_torch.build_label_assets``: with one stub tokenizer the
  same six JSON files byte for byte; without one, the same exit message;
* ``python -m uc2_torch.verify_real_ckpt``, the real-checkpoint runbook,
  on the artifacts tests/test_verify_real_ckpt.py builds (the release's
  LMDB format, a perturbed oracle ``.pt``, an h = 64 two-layer config):
  the reference's R@K, int8 R@K keys and ``n_loaded_params``, logit
  parity within 1e-4 of the fp32 oracle, the parity batch's scores within
  1e-4 of the reference's JAX scores; u2s directories taken as they are,
  the rank head from the ITM head, a milestone of the port's drivers
  loaded whole, a flax ``.msgpack`` refused.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import uc2_tpu.models.finetune as jax_finetune
from tests.test_lmdb_import import u2s_to_reference_lmdb
from tests.torch_oracle import OracleUC2
from uc2_tpu.data.synth import synth_corpus
from uc2_torch import (build_label_assets, collate_bench, make_demo_data,
                       verify_real_ckpt)
from uc2_torch.config import UC2Config
from uc2_torch.data.collate import collate_batch
from uc2_torch.models import convert, finetune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# ------------------------------------------------------------ demo data
def test_make_demo_data_writes_the_reference_stores(tmp_path, capsys):
    _script("make_demo_data").main(str(tmp_path / "ref"), n_imgs=8)
    ref_out = capsys.readouterr().out
    make_demo_data.main(str(tmp_path / "port"), n_imgs=8)
    port_out = capsys.readouterr().out
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    assert {"en/txt_db/txt.u2s", "en/img_db/feat.u2s", "en/txt_db/meta.json",
            "pair/txt_db/txt2img.json"} <= set(ref)
    assert [k for k in ref if ref[k] != port[k]] == []
    assert port_out == ref_out.replace(str(tmp_path / "ref"),
                                       str(tmp_path / "port"))


# ---------------------------------------------------------- collate bench
def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def test_collate_bench_examples_and_batches_match_the_reference():
    ref = _script("collate_bench")
    rng_p, rng_r = np.random.default_rng(0), np.random.default_rng(0)
    spec = collate_bench.BucketSpec(64, 100, 16, 64)
    for fp16, with_ft in collate_bench.CASES:
        ex_p = collate_bench.make_examples(rng_p, 16, fp16, with_ft)
        ex_r = ref.make_examples(rng_r, 16, fp16, with_ft)
        for a, b in zip(ex_p, ex_r, strict=True):
            _same(a, b)
        keys = ("feat_targets",) if with_ft else ()
        out_p = collate_batch(ex_p, spec, slot_target_keys=keys)
        out_r = ref.collate_batch(ex_r, ref.BucketSpec(64, 100, 16, 64),
                                  slot_target_keys=keys)
        _same(out_p, out_r)
        assert out_p["img_feat"].dtype == (np.float16 if fp16
                                           else np.float32)


def test_collate_bench_prints_the_reference_lines(monkeypatch, capsys):
    argv = ["--seconds", "0.05", "--batch", "8"]
    rates = collate_bench.main(argv)
    port = capsys.readouterr().out.splitlines()
    monkeypatch.setattr("sys.argv", ["collate_bench.py"] + argv)
    _script("collate_bench").main()
    ref = capsys.readouterr().out.splitlines()
    line = re.compile(r"^RESULT collate fp16=[01] mrfr_targets=[01]: "
                      r"\d+ ex/s$")
    assert len(port) == len(ref) == 4
    assert all(line.match(x) for x in port + ref), port + ref
    assert ([x.split(":")[0] for x in port]
            == [x.split(":")[0] for x in ref])
    assert all(r > 0 for r in rates.values())


# ----------------------------------------------------------- label assets
def _stub_tokenizer(word):
    b = word.encode("utf-8")
    return [4 + sum(b) % 9973, 4 + len(b) * 31 % 9973][:1 + len(b) % 2]


def test_build_label_assets_writes_the_reference_files(tmp_path,
                                                       monkeypatch, capsys):
    ref = _script("build_label_assets")
    for mod, sub in ((ref, "ref"), (build_label_assets, "port")):
        (tmp_path / sub).mkdir()
        monkeypatch.setattr(mod, "ASSETS", str(tmp_path / sub))
        monkeypatch.setattr(mod, "try_xlmr_tokenizer",
                            lambda: _stub_tokenizer)
        mod.main()
    out = capsys.readouterr().out
    ref_files, port_files = (_files(tmp_path / "ref"),
                             _files(tmp_path / "port"))
    assert sorted(port_files) == sorted(
        f"label_token_ids_{lang}.json" for lang in build_label_assets.LANGS)
    assert sorted(ref_files) == sorted(port_files)
    assert all(ref_files[k] == port_files[k] for k in ref_files)
    assert out.count("wrote ") == 12


def test_build_label_assets_without_a_tokenizer_exits(monkeypatch):
    codes = []
    for mod in (_script("build_label_assets"), build_label_assets):
        monkeypatch.setattr(mod, "try_xlmr_tokenizer", lambda: None)
        with pytest.raises(SystemExit) as e:
            mod.main()
        codes.append(e.value.code)
    assert isinstance(codes[0], str) and codes[0] == codes[1]


# --------------------------------------------------------------- runbook
TINY = {"vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 66, "img_dim": 32, "img_label_dim": 11,
        "use_pallas_attention": False, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}
FLAGS = ["--max_txt_len", "16", "--max_bb", "10", "--min_bb", "4",
         "--num_bb", "10", "--batch_size", "8", "--parity_batch", "6"]
PORT = ["--device", "cpu", "--dtype", "float32"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The runbook test's artifacts: a corpus in the release's LMDB
    format, the perturbed oracle's ``.pt`` and the same without its rank
    head, the tiny config."""
    tmp = tmp_path_factory.mktemp("runbook")
    corpus = synth_corpus(str(tmp / "u2s"), n_imgs=10, txt_per_img=2,
                          min_bb=4, max_bb=10, img_dim=32, n_classes=11,
                          seed=7, max_words=6, vocab=1000)
    lmdb_txt, lmdb_img = u2s_to_reference_lmdb(
        corpus["txt_db"], corpus["img_db"], str(tmp / "lmdb"))
    torch.manual_seed(0)
    oracle = OracleUC2(vocab=1000, h=64, n_layers=2, n_heads=4, ffn=128,
                       max_pos=66, img_dim=32, img_label_dim=11)
    with torch.no_grad():
        for p in oracle.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    sd = oracle.state_dict()
    torch.save(sd, str(tmp / "oracle.pt"))
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("rank_output")}, str(tmp / "norank.pt"))
    (tmp / "tiny.json").write_text(json.dumps(TINY))
    return {"tmp": tmp, "corpus": corpus, "lmdb_txt": lmdb_txt,
            "lmdb_img": lmdb_img, "ckpt": str(tmp / "oracle.pt"),
            "norank": str(tmp / "norank.pt"),
            "config": str(tmp / "tiny.json")}


def _first_scores(monkeypatch, cls, calls):
    orig = cls.scores

    def scores(self, *a, **k):
        out = orig(self, *a, **k)
        calls.append(out)
        return out
    monkeypatch.setattr(cls, "scores", scores)


def test_runbook_matches_the_reference(artifacts, monkeypatch, capsys):
    a = artifacts
    common = ["--checkpoint", a["ckpt"], "--txt_db", a["lmdb_txt"],
              "--img_db", a["lmdb_img"], "--model_config", a["config"],
              "--quant", "int8"] + FLAGS
    ref_calls, port_calls = [], []
    _first_scores(monkeypatch, jax_finetune.UC2ForImageTextRetrieval,
                  ref_calls)
    ref = _script("verify_real_ckpt").main(
        common + ["--workdir", str(a["tmp"] / "work_ref")])
    _first_scores(monkeypatch, finetune.UC2ForImageTextRetrieval, port_calls)
    port = verify_real_ckpt.main(
        common + PORT + ["--workdir", str(a["tmp"] / "work_port")])
    out = capsys.readouterr().out
    assert "[verify] imported LMDB" in out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(port, default=str))
    assert set(port) == set(ref)
    assert port["n_loaded_params"] == ref["n_loaded_params"] > 0
    assert port["retrieval"] == ref["retrieval"]
    assert port["logit_max_abs_diff"] <= 1e-4, port
    assert port["logit_pearson"] > 0.999
    assert port["oracle_missing_keys"] == ref["oracle_missing_keys"]
    assert port["oracle_unexpected_keys"] == ref["oracle_unexpected_keys"]
    # the parity batch is each runbook's first scored batch
    s_ref = np.asarray(ref_calls[0], np.float32)
    s_port = port_calls[0].detach().float().numpy()
    assert s_port.shape == s_ref.shape == (6,)
    assert np.abs(s_port - s_ref).max() <= 1e-4
    for k in ("retrieval_int8", "retrieval_int8_delta"):
        assert set(port[k]) == set(ref[k]) == set(ref["retrieval"]), k
        assert all(np.isfinite(v) for v in port[k].values())
    assert all(0 <= v <= 100 for v in port["retrieval_int8"].values())


def test_runbook_takes_u2s_dirs_and_inits_the_rank_head(artifacts, capsys):
    a = artifacts
    work = a["tmp"] / "work_u2s"
    args = ["--checkpoint", a["norank"], "--txt_db", a["corpus"]["txt_db"],
            "--img_db", a["corpus"]["img_db"], "--model_config", a["config"],
            "--workdir", str(work), "--txt_limit", "4"] + FLAGS + PORT
    full = verify_real_ckpt.main(
        ["--checkpoint", a["ckpt"]] + args[2:] + ["--skip_torch"])
    report = verify_real_ckpt.main(args)
    out = capsys.readouterr().out
    assert "[verify] imported LMDB" not in out
    assert os.listdir(work) == []
    assert "[verify] rank head initialized from pretrained ITM head" in out
    assert report["n_loaded_params"] == full["n_loaded_params"] - 2
    assert report["logit_max_abs_diff"] <= 1e-4, report
    assert any(k.startswith("rank_output")
               for k in report["oracle_missing_keys"])
    assert "logit_max_abs_diff" not in full
    assert {"img_r1", "img_r5", "img_r10", "txt_r1", "txt_r5",
            "txt_r10"} <= set(report["retrieval"])


def test_runbook_loads_a_milestone_of_the_port(artifacts, monkeypatch,
                                               tmp_path, capsys):
    """A milestone of the port's drivers (fused ``qkv`` keys) loads whole:
    every scored batch and R@K as from the same weights under the UC2 key
    names, and no parity stage."""
    a = artifacts
    cfg = UC2Config.from_json_file(a["config"]).replace(dtype="float32")
    model = finetune.UC2ForImageTextRetrieval(cfg, device="cpu", seed=5)
    torch.manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    sd = model.state_dict()
    milestone, uc2 = tmp_path / "model_step_5.pt", tmp_path / "uc2.pt"
    torch.save(sd, milestone)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in convert.params_to_uc2_state_dict(sd).items()},
               uc2)
    args = ["--txt_db", a["corpus"]["txt_db"], "--img_db",
            a["corpus"]["img_db"], "--model_config", a["config"],
            "--workdir", str(tmp_path / "work")] + FLAGS + PORT
    calls = {}
    for name, ckpt, extra in (("milestone", milestone, []),
                              ("uc2", uc2, ["--skip_torch"])):
        calls[name] = []
        with monkeypatch.context() as m:
            _first_scores(m, finetune.UC2ForImageTextRetrieval, calls[name])
            calls[name + "_report"] = verify_real_ckpt.main(
                ["--checkpoint", str(ckpt)] + args + extra)
    port, ref = calls["milestone_report"], calls["uc2_report"]
    assert "rank head initialized" not in capsys.readouterr().out
    assert "logit_max_abs_diff" not in port
    assert port["n_loaded_params"] == verify_real_ckpt.count_leaves(
        convert.params_to_jax(sd))
    assert port["retrieval"] == ref["retrieval"]
    assert len(calls["milestone"]) == len(calls["uc2"]) > 0
    for x, y in zip(calls["milestone"], calls["uc2"]):
        assert torch.equal(x, y)


def test_runbook_refuses_a_msgpack_checkpoint(artifacts, tmp_path):
    a = artifacts
    ckpt = tmp_path / "model_step_10.msgpack"
    ckpt.write_bytes(b"\x80")
    with pytest.raises(ValueError, match=re.escape(str(ckpt))):
        verify_real_ckpt.main(
            ["--checkpoint", str(ckpt), "--txt_db", a["corpus"]["txt_db"],
             "--img_db", a["corpus"]["img_db"], "--model_config",
             a["config"], "--workdir", str(tmp_path / "work")]
            + FLAGS + PORT)
