"""The port's pretraining driver (``python -m uc2_torch.pretrain``) on the
CPU over stores the reference package writes, at a tiny config (hidden 32,
one layer) and the tasks itm, mlm, vmlm (en) and tlm (a paired de store):

* against the repository's pretrain.py from one UC2 ``.pt`` checkpoint at
  dropout 0 and fp32 with two stacked micro-batches a step: the same task
  and batch sequence, the per-step logged losses and the validation logs
  within 1e-4 relative, and the same artifacts;
* exact resume: a run stopped at step 3 and resumed to 6 equals an
  uninterrupted 6-step run bit for bit at dropout 0.1 (parameters, AdamW's
  moments, per-step losses), from the saved stream state or by replaying
  the stream;
* the loop's variants (no prefetch thread, host accumulation), the hps
  check, the refusal of --n_model 2 in a world of one, the distribution
  flags at a world of one (equal to the undistributed run), checkpoint
  resolution.

The vocabulary is XLM-R's (250002): the label vocabulary's stand-in token
ids span it."""

import json
import os

import numpy as np
import pytest
import torch
import jax

import pretrain as jax_pretrain
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.data.synth import synth_corpus
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_torch import pretrain
from uc2_torch.data import loader
from uc2_torch.models import convert
from uc2_torch.parallel import multihost as MH
from tests.torch_dist_util import free_port

TINY = {"vocab_size": 250002, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": False}
CORPUS = dict(n_imgs=12, txt_per_img=2, min_bb=4, max_bb=10, img_dim=16,
              n_classes=11, vocab=250002, max_words=5)
RTOL = 1e-4
STEPS = 6
# seed 0 draws vmlm, tlm, itm, tlm, tlm, mlm for steps 1-6
TASKS = ["itm_s_en", "mlm_s_en", "vmlm_s_en", "tlm_s_de"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpora, the tiny model config and a UC2 ``.pt`` checkpoint of
    every parameter, all written by the reference package."""
    root = tmp_path_factory.mktemp("driver")
    en = synth_corpus(str(root / "en"), seed=7, **CORPUS)
    de = synth_corpus(str(root / "de"), seed=8, paired=True, **CORPUS)
    cfg = str(root / "tiny.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    params = JaxPretraining(JaxConfig(**TINY)).init_params(
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    ckpt = str(root / "uc2.pt")
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(params).items()},
               ckpt)
    return {"root": root, "en": en, "de": de, "cfg": cfg, "ckpt": ckpt}


def _argv(setup, out, extra=()):
    en, de = setup["en"], setup["de"]
    return [
        "--model_config", setup["cfg"], "--output_dir", str(out),
        "--train_datasets", json.dumps([
            {"name": "s_en", "language": "en", "db": [en["txt_db"]],
             "img": [en["img_db"]], "tasks": ["itm", "mlm", "vmlm"],
             "mix_ratio": [1, 1, 1]},
            {"name": "s_de", "language": "de", "db": [de["txt_db"]],
             "img": [en["img_db"]], "tasks": ["tlm"], "mix_ratio": [1]}]),
        "--val_datasets", json.dumps([
            {"name": "v", "language": "en", "db": [en["txt_db"]],
             "img": [en["img_db"]], "tasks": ["mlm", "itm", "vmlm"],
             "mix_ratio": [1, 1, 1]}]),
        # max_txt_len 66: every text fits the first bucket (24, 10), B = 8
        "--max_txt_len", "66", "--max_bb", "10", "--min_bb", "4",
        "--label_classes", "11", "--train_batch_size", "256",
        "--gradient_accumulation_steps", "2", "--num_train_steps",
        str(STEPS), "--warmup_steps", "2", "--valid_steps", str(STEPS),
        "--val_batches", "2", "--save_steps", "3", "--log_steps", "1",
        "--dtype", "float32", "--seed", "0"] + list(extra)


def _port(setup, out, extra=()):
    a = _argv(setup, out, ["--device", "cpu"] + list(extra))
    return pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                    a))


def _recording(monkeypatch, cls):
    """Record every (task, batch) ``cls.__next__`` gives."""
    seen = []
    orig = cls.__next__

    def nxt(self):
        name, batch = orig(self)
        seen.append((name, {k: np.array(v) for k, v in batch.items()
                            if not k.startswith("_") and k != "sample_size"}))
        return name, batch
    monkeypatch.setattr(cls, "__next__", nxt)
    return seen


def _scalars(out):
    """{name: [(step, value)]} of a run's scalars.jsonl."""
    got = {}
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step")
            for k, v in rec.items():
                got.setdefault(k, []).append((step, v))
    return got


@pytest.fixture(scope="module")
def both(setup):
    """The reference driver and the port's on the same argv, from the
    same checkpoint, at dropout 0, with their batch sequences."""
    mp = pytest.MonkeyPatch()
    extra = ["--dropout", "0", "--checkpoint", setup["ckpt"]]
    try:
        ref_seen = _recording(mp, jax_loader.MetaLoader)
        ref_out = setup["root"] / "ref"
        jax_pretrain.main(jax_pretrain.parse_with_config(
            jax_pretrain.build_parser(), _argv(setup, ref_out, extra)))
        port_seen = _recording(mp, loader.MetaLoader)
        port_out = setup["root"] / "port"
        run = _port(setup, port_out, extra)
    finally:
        mp.undo()
    return {"ref": (str(ref_out), ref_seen), "port": (str(port_out),
                                                      port_seen, run)}


def test_driver_draws_the_reference_batches(both):
    ref_seen, port_seen = both["ref"][1], both["port"][1]
    assert len(port_seen) >= STEPS and len(ref_seen) >= STEPS
    assert [n for n, _ in port_seen[:STEPS]] == \
        [n for n, _ in ref_seen[:STEPS]]
    assert {n for n, _ in port_seen[:STEPS]} == set(TASKS)
    for (_, got), (_, want) in zip(port_seen[:STEPS], ref_seen[:STEPS]):
        assert got["input_ids"].shape[0] == 2          # stacked micro-batches
        assert set(got) <= set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_driver_losses_and_validation_match_reference(both):
    ref = _scalars(both["ref"][0])
    port = _scalars(both["port"][0])
    names = [k for k in ref if k.startswith(("loss/", "valid_"))]
    assert sorted(names) == sorted(k for k in port
                                   if k.startswith(("loss/", "valid_")))
    assert len([k for k in names if k.startswith("valid_")]) == 6
    for k in names:
        assert [s for s, _ in port[k]] == [s for s, _ in ref[k]], k
        np.testing.assert_allclose([v for _, v in port[k]],
                                   [v for _, v in ref[k]], rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose([v for _, v in port["lr"]],
                               [v for _, v in ref["lr"]], rtol=1e-7)
    run = both["port"][2]
    assert run.step == STEPS and [s for s, _, _ in run.losses] == \
        list(range(1, STEPS + 1))
    assert all(np.isfinite(v) for _, _, v in run.losses)


def test_driver_writes_the_reference_artifacts(both):
    ref, port = both["ref"][0], both["port"][0]

    def load(out, name):
        with open(os.path.join(out, name)) as f:
            return json.load(f)
    want = load(ref, "log/hps.json")
    got = load(port, "log/hps.json")
    assert got.pop("device") == "cpu" and got.pop("dist_backend") is None
    assert got.pop("output_dir") == port and want.pop("output_dir") == ref
    assert got == want
    assert load(port, "restore_hps.json") == load(ref, "restore_hps.json")
    for name in ("restore_stream_p0.json", "restore_stream_backup_p0.json"):
        g, w = load(port, name), load(ref, name)
        assert g["global_step"] == w["global_step"]
        assert g["meta"]["step"] == w["meta"]["step"]
        assert g["meta"]["loaders"] == w["meta"]["loaders"]
    for name in ("restore.ckpt", "restore_backup.ckpt", "log/log.txt"):
        assert os.path.exists(os.path.join(port, name))
    assert os.listdir(os.path.join(ref, "ckpt")) == [
        f"model_step_{STEPS}.msgpack"]
    assert os.listdir(os.path.join(port, "ckpt")) == [
        f"model_step_{STEPS}.pt"]
    # the milestone holds the trained model, and --checkpoint reads it back
    run = both["port"][2]
    sd = torch.load(os.path.join(port, "ckpt", f"model_step_{STEPS}.pt"),
                    weights_only=True)
    assert all(torch.equal(sd[k], v) for k, v in
               run.model.state_dict().items())
    assert pretrain.resolve_checkpoint_path(port).endswith(
        f"model_step_{STEPS}.pt")


def _state(run):
    """Parameters and AdamW's moments as CPU tensors."""
    out = {f"p.{k}": v.clone() for k, v in run.model.state_dict().items()}
    for i, st in run.optimizer.state_dict()["state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            out[f"o.{i}.{k}"] = torch.as_tensor(st[k]).clone()
    out["count"] = torch.tensor(run.optimizer.count)
    return out


@pytest.fixture(scope="module")
def uninterrupted(setup):
    out = setup["root"] / "whole"
    return out, _state(_port(setup, out, ["--dropout", "0.1"]))


@pytest.mark.parametrize("stream_file", [True, False])
def test_resumed_run_equals_the_uninterrupted_one(setup, uninterrupted,
                                                  stream_file):
    """Stopped after step 3 and resumed to 6, with the saved stream state
    or (the files removed) by replaying the stream: bit for bit."""
    whole_out, want = uninterrupted
    out = setup["root"] / f"resumed{int(stream_file)}"
    first = _port(setup, out, ["--dropout", "0.1", "--stop_after_steps",
                               "3"])
    assert first.step == 3
    if not stream_file:
        os.remove(os.path.join(out, "restore_stream_p0.json"))
    second = _port(setup, out, ["--dropout", "0.1"])
    assert second.step == STEPS
    got = _state(second)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    whole = _scalars(str(whole_out))
    parts = _scalars(str(out))
    steps = [k for k in whole if k.startswith("step_loss/")]
    assert steps and sorted(steps) == sorted(
        k for k in parts if k.startswith("step_loss/"))
    for k in steps:
        assert parts[k] == whole[k], k              # exact floats
    assert [s for s, _, _ in first.losses + second.losses] == \
        list(range(1, STEPS + 1))


def test_hps_check_raises_on_a_changed_learning_rate(setup):
    out = setup["root"] / "hps"
    _port(setup, out, ["--stop_after_steps", "3", "--valid_steps", "0"])
    with pytest.raises(ValueError, match="learning_rate"):
        _port(setup, out, ["--learning_rate", "1e-3"])


def test_loop_variants_match_the_default_loop(setup, both):
    """--no_prefetch (with losses read two steps late and logged every
    third step) gives the default run bit for bit, --lm_ce_chunks its
    losses within 1e-4. --host_accum (the
    micro-batches one by one) draws the same tasks and batches; its steps
    equal the stacked run's until a window crosses a loader's epoch (steps
    1-3 here), where a stacked window assembles both micro-batches after
    drawing them, keying the masks of the first on the new epoch, as the
    reference's loader does."""
    base = both["port"][2]
    extra = ["--dropout", "0", "--checkpoint", setup["ckpt"],
             "--valid_steps", "0", "--save_steps", "100"]
    plain = _port(setup, setup["root"] / "noprefetch",
                  extra + ["--no_prefetch", "--log_steps", "3",
                           "--runahead", "2"])
    assert plain.losses == base.losses
    chunked = _port(setup, setup["root"] / "chunked",
                    extra + ["--lm_ce_chunks", "3"])
    np.testing.assert_allclose([v for _, _, v in chunked.losses],
                               [v for _, _, v in base.losses], rtol=RTOL)
    host = _port(setup, setup["root"] / "host", extra + ["--host_accum"])
    assert [(s, n) for s, n, _ in host.losses] == \
        [(s, n) for s, n, _ in base.losses]
    assert host.losses[:3] == base.losses[:3]
    assert all(np.isfinite(v) for _, _, v in host.losses)


def test_async_milestones_equal_the_written_ones(setup, both):
    """--async_ckpt writes the milestone from a background thread: the
    same file content as the default run's."""
    out = setup["root"] / "async"
    run = _port(setup, out, ["--dropout", "0", "--checkpoint",
                             setup["ckpt"], "--async_ckpt",
                             "--save_steps", "100"])
    assert run.losses == both["port"][2].losses
    name = f"ckpt/model_step_{STEPS}.pt"
    got = torch.load(os.path.join(out, name), weights_only=True)
    want = torch.load(os.path.join(both["port"][0], name), weights_only=True)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


UNPORTED = [
    (["--n_model", "2"], "--n_model"), (["--zero1"], "--zero1"),
    (["--coordinator_address", "localhost:1"], "--coordinator_address"),
    (["--num_processes", "2"], "--num_processes"),
    (["--process_id", "0"], "--process_id")]
# the distribution flags at a world of one: the coordinator's flags start
# a process group of one over gloo
WORLD_OF_ONE = {
    "--zero1": ["--zero1"],
    "--coordinator_address": ["--coordinator_address", "127.0.0.1:{port}",
                              "--num_processes", "1", "--process_id", "0"],
    "--num_processes": ["--num_processes", "1"],
    "--process_id": ["--process_id", "0"]}
SHORT = ["--num_train_steps", "2", "--valid_steps", "0", "--save_steps",
         "100"]


@pytest.fixture(scope="module")
def undistributed(setup):
    """Two steps of the default run without any distribution flag."""
    return _port(setup, setup["root"] / "undistributed", SHORT)


@pytest.mark.parametrize("extra,name", UNPORTED,
                         ids=[n for _, n in UNPORTED])
def test_unported_flags_and_tasks_raise_by_name(setup, tmp_path, extra,
                                                name, request):
    """--n_model 2 in a world of one raises by name (tensor parallelism
    needs as many processes, tests/test_torch_tp.py). The distribution
    flags are ported: at a world of one each run equals the undistributed
    one, losses and parameters bit for bit."""
    if name not in WORLD_OF_ONE:
        argv = _argv(setup, tmp_path / "out", ["--device", "cpu"] + extra)
        opts = pretrain.parse_with_config(pretrain.build_parser(), argv)
        with pytest.raises(ValueError if name == "--n_model"
                           else NotImplementedError,
                           match=name.replace("-", "\\-")):
            pretrain.main(opts)
        return
    want = request.getfixturevalue("undistributed")
    flags = [f.format(port=free_port()) for f in WORLD_OF_ONE[name]]
    try:
        got = _port(setup, tmp_path / "out", SHORT + flags)
        assert MH.process_count() == 1
    finally:
        MH.shutdown()
    assert got.step == 2 and got.losses == want.losses
    g, w = _state(got), _state(want)
    assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)


def test_no_op_flags_and_the_cli_config(setup, tmp_path):
    """--rng_impl and --split_step are accepted and change nothing; a JSON
    --config fills what the command line leaves out, and the original
    UC2 key names map onto this driver's."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"co_masking_mode": "mix", "neg_size": 7,
                               "learning_rate": 1.0, "_comment": "x"}))
    argv = ["--config", str(cfg), "--learning_rate", "2e-5"]
    opts = pretrain.apply_reference_config_compat(
        pretrain.parse_with_config(pretrain.build_parser(), argv), argv)
    assert (opts.learning_rate, opts.comasking_mode, opts.nce_neg_size) == \
        (2e-5, "mix", 7)
    assert not hasattr(opts, "_comment") and opts.device == "cuda"
    run = _port(setup, tmp_path / "knobs",
                ["--rng_impl", "threefry2x32", "--split_step",
                 "--num_train_steps", "2", "--valid_steps", "0"])
    assert run.step == 2


def test_checkpoint_directory_resolves_to_the_newest_milestone(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for n in (3, 12, 6):
        torch.save({"x": torch.zeros(1)}, ckpt / f"model_step_{n}.pt")
    (ckpt / "model_step_20.msgpack").write_bytes(b"")
    assert pretrain.resolve_checkpoint_path(str(tmp_path)) == \
        str(ckpt / "model_step_12.pt")
    assert pretrain.resolve_checkpoint_path(str(ckpt)) == \
        str(ckpt / "model_step_12.pt")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="model_step_"):
        pretrain.resolve_checkpoint_path(str(empty))
    with pytest.raises(ValueError, match="PyTorch"):
        pretrain.load_raw_checkpoint(str(ckpt / "model_step_20.msgpack"))


def test_partial_and_early_adaptation_loading(setup, tmp_path):
    """--load_embedding_only takes the checkpoint's text embeddings and
    nothing else; --early_adaptation_checkpoint splices a vision-to-word
    linear into img_linear."""
    sd = torch.load(setup["ckpt"], weights_only=True)
    init = _port(setup, tmp_path / "init", ["--num_train_steps", "0"])
    part = _port(setup, tmp_path / "part", [
        "--num_train_steps", "0", "--checkpoint", setup["ckpt"],
        "--load_embedding_only"])
    got = part.model.state_dict()
    assert torch.equal(got["roberta.embeddings.word_embeddings.weight"],
                       sd["roberta.embeddings.word_embeddings.weight"])
    for k in ("roberta.layer.0.output_dense.weight", "cls.bias"):
        assert torch.equal(got[k], init.model.state_dict()[k])
    w = torch.randn(32, 16)
    torch.save({"img_linear.weight": w, "img_linear.bias": torch.ones(32)},
               tmp_path / "ea.pt")
    ea = _port(setup, tmp_path / "ea", [
        "--num_train_steps", "0", "--early_adaptation_checkpoint",
        str(tmp_path / "ea.pt")])
    lin = ea.model.roberta.img_embeddings.img_linear
    assert torch.equal(lin.weight, w) and torch.equal(lin.bias,
                                                      torch.ones(32))


def test_uc2_checkpoint_loads_by_its_torch_key_names(setup):
    """The reference's converter and the port's give the same tree from
    the UC2 .pt, with and without the partial-loading flags."""
    sd = torch.load(setup["ckpt"], weights_only=True)
    for kw in ({}, {"load_embedding_only": True}):
        got = convert.torch_to_params(sd, **kw)
        want = jax_convert.torch_to_params(sd, **kw)
        flat_g = dict(convert._walk(got))
        flat_w = dict(convert._walk(want))
        assert set(flat_g) == set(flat_w) and flat_g
        assert all(np.array_equal(flat_g[k], flat_w[k]) for k in flat_w)


def test_label_vocab_uses_the_tokenizers_public_api(monkeypatch):
    """Where transformers and the XLM-R files are present, the label
    vocabulary tokenizes through ``convert_tokens_to_ids``: newer
    tokenizer classes have no ``_convert_token_to_id``."""
    import sys
    import types
    from uc2_torch.data import labels

    class Tok:
        unk_token_id = 3

        @classmethod
        def from_pretrained(cls, name, local_files_only):
            assert local_files_only
            return cls()

        def tokenize(self, word):
            return list(word)

        def convert_tokens_to_ids(self, tokens):
            return [ord(t) for t in tokens]

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(XLMRobertaTokenizer=Tok))
    assert labels.try_xlmr_tokenizer()("ab") == [97, 98]
    vocab = labels.LabelVocab(words={"en": ["ab", "c"]})
    assert vocab.source == "tokenizer"
