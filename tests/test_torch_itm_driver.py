"""The port's retrieval finetuning driver (``python -m uc2_torch.itm``) on the
CPU over stores the port writes (byte for byte the reference's), at a
tiny config (hidden 32, one layer, fp32):

* against the repository's itm.py from one UC2 ``.pt`` checkpoint at
  dropout 0 with two stacked micro-batches a step, two training databases
  and ``--hard_neg_size 1`` (sample size 5, 8 groups = 40 rows, which the
  reference's 8 virtual devices divide, so both take the same groups):
  the same batches bit for bit (hard negatives from the mined pools
  included), the same mined pools, the per-step rank losses, the
  validation logs and ``test_results.json`` within 1e-4, and the same
  artifact names;
* ``apply_reference_config_compat`` against itm.py's on the shipped config
  and on the original UC2 key names;
* the refusal of --n_model 2 in a world of one, by name, the
  distribution flags at a world of one and ``--quant int8`` (equal to the
  undistributed run in training: int8 scores only the evaluations);
* resume: a run stopped at step 2 (dropout 0.1, ``--full_val``,
  ``--async_ckpt``) and resumed to 4 loads the parameters and AdamW's
  moments of step 2 bit for bit."""

import json
import os

import numpy as np
import pytest
import torch
import jax

import itm as jax_itm
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.utils import logger as jax_logger
from uc2_torch import itm
from uc2_torch.data import loader
from uc2_torch.parallel import multihost as MH
from uc2_torch.data.synth import synth_corpus
from uc2_torch.training import checkpoint

TINY = {"vocab_size": 512, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": True}
CORPUS = dict(txt_per_img=2, min_bb=4, max_bb=8, img_dim=16, n_classes=11,
              max_words=6, vocab=512)
RTOL = 1e-4
STEPS = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two corpora, the tiny model config and a UC2 ``.pt`` checkpoint of
    a retrieval model (the reference's init, moved away from it so that
    the scores spread over the sigmoid's slope: std 0.12 about 0.77),
    written by the reference's converter."""
    root = tmp_path_factory.mktemp("itm_driver")
    stores = [synth_corpus(str(root / f"c{k}"), n_imgs=n, seed=9 + k,
                           **CORPUS) for k, n in enumerate((10, 8))]
    cfg = str(root / "tiny.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    params = JaxRetrieval(JaxConfig(**TINY)).init_params(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2, params)
    ckpt = str(root / "uc2.pt")
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(params).items()},
               ckpt)
    return {"root": root, "stores": stores, "cfg": cfg, "ckpt": ckpt}


def _argv(setup, out, extra=()):
    c0, c1 = setup["stores"]
    return [
        "--model_config", setup["cfg"], "--output_dir", str(out),
        "--train_txt_db", json.dumps([c0["txt_db"], c1["txt_db"]]),
        "--train_img_db", json.dumps([c0["img_db"], c1["img_db"]]),
        "--val_txt_db", c0["txt_db"], "--val_img_db", c0["img_db"],
        "--test_datasets", json.dumps([
            {"name": f"synth{k}", "db": c["txt_db"], "img": c["img_db"]}
            for k, c in enumerate(setup["stores"])]),
        "--max_txt_len", "16", "--max_bb", "8", "--min_bb", "4",
        "--train_batch_size", "40", "--eval_batch_size", "8",
        "--gradient_accumulation_steps", "2",
        "--hard_neg_size", "1", "--hard_neg_steps", "2",
        "--hard_neg_pool_size", "3",
        "--num_train_steps", str(STEPS), "--warmup_steps", "1",
        "--learning_rate", "3e-3",
        "--valid_steps", "2", "--eval_txt_limit", "12",
        "--save_steps", "2", "--log_steps", "1",
        "--dtype", "float32", "--seed", "0"] + list(extra)


def _port(setup, out, extra=()):
    argv = _argv(setup, out, ["--device", "cpu"] + list(extra))
    parser = itm.build_parser()
    opts = itm.parse_with_config(parser, argv)
    itm.apply_reference_config_compat(opts, parser, argv)
    return itm.main(opts)


def _recording(mp, cls, seen):
    """Record every batch ``cls.next_stacked`` gives."""
    orig = cls.next_stacked

    def nxt(self, n):
        batch = orig(self, n)
        seen.append({k: np.array(v) for k, v in batch.items()
                     if not k.startswith("_") and k != "sample_size"})
        return batch
    mp.setattr(cls, "next_stacked", nxt)


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
    """itm.py and the port's driver on the same argv, from the same
    checkpoint, at dropout 0: their batches, the reference's per-step
    losses (each reading of its loss meter) and the port's run."""
    mp = pytest.MonkeyPatch()
    extra = ["--dropout", "0", "--checkpoint", setup["ckpt"]]
    ref_seen, port_seen, ref_losses = [], [], []
    meter_call = jax_logger.RunningMeter.__call__
    try:
        _recording(mp, jax_loader.TaskLoader, ref_seen)
        mp.setattr(jax_logger.RunningMeter, "__call__",
                   lambda self, v: ref_losses.append(v) or meter_call(self,
                                                                      v))
        ref_out = setup["root"] / "ref"
        argv = _argv(setup, ref_out, extra)
        parser = jax_itm.build_parser()
        opts = jax_itm.parse_with_config(parser, argv)
        jax_itm.apply_reference_config_compat(opts, parser, argv)
        jax_itm.main(opts)
        _recording(mp, loader.TaskLoader, port_seen)
        port_out = setup["root"] / "port"
        run = _port(setup, port_out, extra)
    finally:
        mp.undo()
    return {"ref": (str(ref_out), ref_seen, ref_losses),
            "port": (str(port_out), port_seen, run)}


def test_driver_draws_the_reference_batches(both):
    ref_seen, port_seen = both["ref"][1], both["port"][1]
    assert len(port_seen) == len(ref_seen) == STEPS
    for got, want in zip(port_seen, ref_seen):
        assert got["input_ids"].shape[:2] == (2, 40)  # 8 groups of 5, twice
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_driver_mines_the_reference_pools(both):
    ref, port = both["ref"][0], both["port"][0]
    names = sorted(f for f in os.listdir(ref) if f.startswith("hard_negs"))
    assert names == [f"hard_negs_{s}.db{k}.json" for s in (0, 2, 4)
                     for k in (0, 1)]
    assert sorted(f for f in os.listdir(port)
                  if f.startswith("hard_negs")) == names
    for name in names:
        with open(os.path.join(ref, name)) as f:
            want = json.load(f)
        with open(os.path.join(port, name)) as f:
            assert json.load(f) == want, name
    run = both["port"][2]
    assert [(s, len(files)) for s, _, files in run.mined] == [(0, 2), (2, 2),
                                                             (4, 2)]


def test_driver_losses_validation_and_tests_match_reference(both):
    ref_out, _, ref_losses = both["ref"]
    port_out, _, run = both["port"]
    assert run.step == STEPS and run.sample_size == 5
    assert [s for s, _ in run.losses] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([v for _, v in run.losses], ref_losses,
                               rtol=RTOL)
    ref, port = _scalars(ref_out), _scalars(port_out)
    names = sorted(k for k in ref if k.startswith(("val_", "loss/")))
    assert names == sorted(k for k in port if k.startswith(("val_",
                                                             "loss/")))
    assert {k for k in names if k.startswith("val_")} == {
        "val_img_r1", "val_img_r5", "val_img_r10", "val_med_rank"}
    for k in names + ["lr"]:
        assert [s for s, _ in port[k]] == [s for s, _ in ref[k]], k
        np.testing.assert_allclose([v for _, v in port[k]],
                                   [v for _, v in ref[k]], rtol=RTOL,
                                   err_msg=k)
    with open(os.path.join(ref_out, "test_results.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_out, "test_results.json")) as f:
        got = json.load(f)
    assert got.keys() == want.keys() == {"synth0", "synth1"}
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=RTOL, err_msg=f"{name} {k}")
    assert run.results == got


def test_driver_writes_the_reference_artifacts(both):
    ref, port = both["ref"][0], both["port"][0]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in ("restore_hps.json",):
        with open(os.path.join(port, name)) as f, \
                open(os.path.join(ref, name)) as g:
            assert json.load(f) == json.load(g)
    with open(os.path.join(port, "log", "hps.json")) as f:
        got = json.load(f)
    with open(os.path.join(ref, "log", "hps.json")) as f:
        want = json.load(f)
    assert (got.pop("device"), got.pop("stop_after_steps"),
            got.pop("dist_backend")) == ("cpu", 0, None)
    assert got.pop("output_dir") == port and want.pop("output_dir") == ref
    assert got == want
    assert sorted(os.listdir(os.path.join(ref, "ckpt"))) == [
        f"model_step_{s}.msgpack" for s in (2, 4)]
    assert sorted(os.listdir(os.path.join(port, "ckpt"))) == [
        f"model_step_{s}.pt" for s in (2, 4)]
    sd = torch.load(os.path.join(port, "ckpt", f"model_step_{STEPS}.pt"),
                    weights_only=True)
    run = both["port"][2]
    assert all(torch.equal(sd[k], v) for k, v in
               run.model.state_dict().items())


def _reference_opts(argv):
    parser = jax_itm.build_parser()
    opts = jax_itm.parse_with_config(parser, argv)
    return vars(jax_itm.apply_reference_config_compat(opts, parser, argv))


def _port_opts(argv):
    parser = itm.build_parser()
    opts = vars(itm.apply_reference_config_compat(
        itm.parse_with_config(parser, argv), parser, argv))
    assert (opts.pop("device"), opts.pop("stop_after_steps"),
            opts.pop("dist_backend")) == ("cuda", 0, None)
    return opts


def test_config_compat_matches_reference(tmp_path):
    """The shipped config and the original UC2 key names (plural db lists,
    one-element val lists, test_txt_db/test_img_db, steps_per_hard_neg,
    inf_minibatch_size) give the options itm.py gives; the command line
    wins."""
    argv = ["--config", "config/uc2_mscoco_itm.json"]
    got = _port_opts(argv)
    assert got == _reference_opts(argv)
    assert len(got["train_txt_db"]) == 4 and got["eval_batch_size"] == 300
    assert isinstance(got["train_img_db"][3], list)
    ref_cfg = {
        "train_txt_dbs": ["/db/a.db/", "/db/b.db/"],
        "train_img_dbs": ["/img/x/", ["/img/x/", "/img/y/"]],
        "val_txt_db": ["/db/val.db/"], "val_img_db": ["/img/y/"],
        "test_txt_db": ["/db/t0.db/", "/db/t1.db/"],
        "test_img_db": ["/img/y/", "/img/y/"],
        "steps_per_hard_neg": 500, "inf_minibatch_size": 300,
        "margin": 0.3, "train_loss": "rank"}
    p = tmp_path / "ref_itm.json"
    p.write_text(json.dumps(ref_cfg))
    for argv in (["--config", str(p)],
                 ["--config", str(p), "--eval_batch_size", "64",
                  "--hard_neg_steps", "7", "--train_txt_db", "/db/cli.db/"]):
        got = _port_opts(argv)
        assert got == _reference_opts(argv)
    assert (got["eval_batch_size"], got["hard_neg_steps"],
            got["train_txt_db"]) == (64, 7, "/db/cli.db/")
    p.write_text(json.dumps(dict(ref_cfg, train_loss="vse")))
    with pytest.raises(SystemExit, match="rank"):
        _port_opts(["--config", str(p)])


UNPORTED = [
    (["--n_model", "2"], "--n_model"), (["--zero1"], "--zero1"),
    (["--coordinator_address", "localhost:1"], "--coordinator_address"),
    (["--num_processes", "2"], "--num_processes"),
    (["--process_id", "0"], "--process_id"),
    (["--quant", "int8"], "--quant int8")]


# the distribution flags at a world of one: the coordinator's flags start
# a process group of one over gloo
WORLD_OF_ONE = {
    "--zero1": ["--zero1"],
    "--coordinator_address": ["--coordinator_address", "127.0.0.1:0",
                              "--num_processes", "1", "--process_id", "0"],
    "--num_processes": ["--num_processes", "1"],
    "--process_id": ["--process_id", "0"]}
SHORT = ["--num_train_steps", "2", "--valid_steps", "0", "--save_steps",
         "100", "--hard_neg_steps", "0"]


@pytest.fixture(scope="module")
def undistributed(setup):
    """Two steps of the default run without any distribution flag."""
    return _port(setup, setup["root"] / "undistributed", SHORT)


@pytest.mark.parametrize("extra,name", UNPORTED,
                         ids=[n for _, n in UNPORTED])
def test_unported_flags_raise_by_name(setup, tmp_path, extra, name,
                                      request):
    """--n_model 2 in a world of one raises by name (tensor parallelism
    needs as many processes, tests/test_torch_tp.py). The distribution
    flags and --quant int8 are ported: at a world of one each run equals
    the undistributed one, losses and parameters bit for bit (int8 scores
    only the validation and the tests, tests/test_torch_int8.py)."""
    if name == "--quant int8":
        got = _port(setup, tmp_path / "out", SHORT + extra)
        want = request.getfixturevalue("undistributed")
        assert got.step == 2 and got.losses == want.losses
        assert set(got.results) == set(want.results) == {"synth0", "synth1"}
        g, w = (_state(r.model, r.optimizer) for r in (got, want))
        assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
        return
    if name not in WORLD_OF_ONE:
        with pytest.raises(ValueError if name == "--n_model"
                           else NotImplementedError,
                           match=name.replace("-", "\\-")):
            _port(setup, tmp_path / "out", extra)
        return
    want = request.getfixturevalue("undistributed")
    flags = WORLD_OF_ONE[name]
    try:
        got = _port(setup, tmp_path / "out", SHORT + flags)
        assert MH.process_count() == 1
    finally:
        MH.shutdown()
    assert got.step == 2 and got.losses == want.losses
    g, w = (_state(r.model, r.optimizer) for r in (got, want))
    assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)


def _state(model, opt):
    """Parameters and AdamW's moments as CPU tensors."""
    out = {f"p.{k}": v.detach().clone() for k, v in
           model.state_dict().items()}
    for i, st in opt.state_dict()["state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            out[f"o.{i}.{k}"] = torch.as_tensor(st[k]).clone()
    out["count"] = torch.tensor(opt.count)
    return out


def test_resumed_run_loads_the_saved_state(setup, tmp_path, monkeypatch):
    """Stopped after step 2 (dropout 0.1, full-matrix validation,
    milestones written from a thread) and resumed: the restore gives the
    model and the optimizer of step 2 bit for bit, and the run goes on to
    step 4 and its test evaluation."""
    out = tmp_path / "resumed"
    extra = ["--dropout", "0.1", "--full_val", "--async_ckpt"]
    first = _port(setup, out, extra + ["--stop_after_steps", "2"])
    assert first.step == 2 and not first.results
    assert not os.path.exists(out / "test_results.json")
    want = _state(first.model, first.optimizer)
    restored = []
    real = checkpoint.TrainingRestorer.restore

    def restore(self, model, opt):
        step = real(self, model, opt)
        restored.append((step, _state(model, opt)))
        return step
    monkeypatch.setattr(checkpoint.TrainingRestorer, "restore", restore)
    second = _port(setup, out, extra)
    (step, got), = restored
    assert step == 2 and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert second.step == STEPS
    assert [s for s, _ in first.losses + second.losses] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for _, v in first.losses + second.losses)
    assert [s for s, _ in second.val] == [4]
    assert set(second.val[0][1]) >= {"txt_r1", "img_r1", "r_mean"}
    assert set(second.results) == {"synth0", "synth1"}
    assert sorted(os.listdir(out / "ckpt")) == ["model_step_2.pt",
                                                "model_step_4.pt"]
