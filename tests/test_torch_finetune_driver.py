"""The port's VQA, VE and NLVR2 finetuning drivers (``python -m
uc2_torch.vqa``, ``uc2_torch.ve``, ``uc2_torch.nlvr2``) and the NLVR2
scorer (``python -m uc2_torch.eval_nlvr2``) on the CPU over stores the
port writes, at a tiny config (hidden 32, one layer, fp32, dropout 0),
against the repository's vqa.py, ve.py, nlvr2.py and
scripts/eval_nlvr2.py:

* from one UC2 ``.pt`` checkpoint (the VQA head in it for VQA; the
  encoder alone for VE and NLVR2, whose heads both packages then take from
  the reference's initialisation): the same batches bit for bit (the
  validation's too), the per-step losses within 1e-4, the VQA validation
  score, NLVR2's ``--pred_csv`` identical in all three formats and the
  scorer's output identical, the same artifact names;
  ``--train_batch_size 8``, which the reference's 8 virtual devices
  divide in every format, so that both take the same examples;
* the parsers' flags and defaults (plus ``--device`` and
  ``--dist_backend``);
* the refusal of --n_model 2 in a world of one, by name, and the
  distribution flags
  at a world of one (equal to the undistributed run);
* resume: a VQA run of 2 steps at dropout 0.1 resumed to 4 loads the
  parameters and AdamW's moments of step 2 bit for bit."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch
import jax

import nlvr2 as jax_nlvr2
import ve as jax_ve
import vqa as jax_vqa
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models import finetune as jax_finetune
from uc2_tpu.utils import logger as jax_logger
from uc2_torch import eval_nlvr2, nlvr2, ve, vqa
from uc2_torch.data import loader
from uc2_torch.data.synth import synth_corpus, synth_finetune_texts
from uc2_torch.models import finetune
from uc2_torch.parallel import multihost as MH
from uc2_torch.training import checkpoint
from tests.torch_dist_util import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"vocab_size": 512, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": True}
CORPUS = dict(txt_per_img=2, min_bb=4, max_bb=8, img_dim=16, n_classes=11,
              max_words=6, vocab=512)
RTOL = 1e-4
N_ANSWER = 9
FORMATS = ["triplet", "paired", "paired-attn"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A corpus of 10 images and 20 texts rewritten for VQA (9 answers),
    VE and NLVR2; the tiny config at dropout 0 and at 0.1; UC2 ``.pt``
    checkpoints of a reference VQA model moved away from init (with and
    without its head), written by the reference's converter."""
    root = tmp_path_factory.mktemp("finetune_driver")
    c = synth_corpus(str(root / "c"), n_imgs=10, seed=21, **CORPUS)
    out = {"root": root, "img_db": c["img_db"]}
    out["vqa"] = synth_finetune_texts(str(root / "vqa"), c["txt_db"], "vqa",
                                      seed=1, num_answer=N_ANSWER)["txt_db"]
    out["ve"] = synth_finetune_texts(str(root / "ve"), c["txt_db"], "vqa",
                                     seed=2, num_answer=3)["txt_db"]
    nl = synth_finetune_texts(str(root / "nlvr2"), c["txt_db"], "nlvr2",
                              seed=3)
    out["nlvr2"], out["annotations"] = nl["txt_db"], nl["annotations"]
    for name, drop in (("cfg", 0.0), ("cfg_drop", 0.1)):
        out[name] = str(root / f"{name}.json")
        with open(out[name], "w") as f:
            json.dump(dict(TINY, hidden_dropout_prob=drop,
                           attention_probs_dropout_prob=drop), f)
    params = jax_finetune.UC2ForVqa(JaxConfig(**TINY), N_ANSWER).init_params(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2, params)
    sd = {k: torch.tensor(v) for k, v in
          jax_convert.params_to_torch_state_dict(params).items()}
    out["ckpt_vqa"] = str(root / "vqa.pt")
    torch.save(sd, out["ckpt_vqa"])
    out["ckpt_enc"] = str(root / "enc.pt")
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("vqa_output")}, out["ckpt_enc"])
    return out


def _common(setup, out, cfg="cfg"):
    return ["--model_config", setup[cfg], "--output_dir", str(out),
            "--train_img_db", setup["img_db"],
            "--max_txt_len", "16", "--max_bb", "8", "--min_bb", "4",
            "--train_batch_size", "8", "--warmup_steps", "1",
            "--learning_rate", "3e-3", "--save_steps", "2",
            "--log_steps", "1", "--dtype", "float32", "--seed", "0"]


def _vqa_argv(setup, out, task="vqa", extra=()):
    argv = _common(setup, out) + ["--train_txt_db", setup[task],
                                  "--num_train_steps", "4"]
    if task == "vqa":
        argv += ["--checkpoint", setup["ckpt_vqa"], "--num_answer",
                 str(N_ANSWER), "--val_txt_db", setup["vqa"],
                 "--val_img_db", setup["img_db"], "--valid_steps", "2",
                 "--val_batches", "2", "--decay", "vqa", "--warm_int", "1",
                 "--decay_int", "1", "--decay_st", "3"]
    else:
        argv += ["--checkpoint", setup["ckpt_enc"], "--valid_steps", "4"]
    return argv + list(extra)


def _nlvr2_argv(setup, out, fmt, extra=()):
    return _common(setup, out) + [
        "--train_txt_db", setup["nlvr2"], "--fmt", fmt,
        "--checkpoint", setup["ckpt_enc"], "--num_train_steps", "3",
        "--valid_steps", "3", "--pred_csv", str(out) + ".csv"] + list(extra)


def _recording(mp, cls, seen):
    """Record every batch ``cls.next_batch`` gives."""
    orig = cls.next_batch

    def nxt(self):
        batch = orig(self)
        seen.append({k: np.array(v) for k, v in batch.items()
                     if not k.startswith("_") and k != "sample_size"})
        return batch
    mp.setattr(cls, "next_batch", nxt)


def _reference_heads(mp):
    """The port's VQA and NLVR2 models built from the reference's
    initialisation of the same config and seed, so that heads the
    checkpoint lacks start equal in both packages."""
    def init(jm, seed):
        return jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(seed)))

    def vqa_model(cfg, num_answer, device="cuda", seed=0):
        jm = jax_finetune.UC2ForVqa(JaxConfig(**cfg.to_dict()), num_answer)
        return Vqa(cfg, num_answer, device=device, params=init(jm, seed))

    def nlvr2_model(cfg, fmt="triplet", device="cuda", seed=0):
        jm = jax_finetune.UC2ForNlvr2(JaxConfig(**cfg.to_dict()), fmt=fmt)
        return Nlvr2(cfg, fmt=fmt, device=device, params=init(jm, seed))
    Vqa, Nlvr2 = finetune.UC2ForVqa, finetune.UC2ForNlvr2
    mp.setattr(finetune, "UC2ForVqa", vqa_model)
    mp.setattr(finetune, "UC2ForNlvr2", nlvr2_model)


def _parse(module, argv):
    return module.parse_with_config(module.build_parser(), argv)


def _run_both(setup, name, ref_main, port_main, argv_fn):
    """The reference's and the port's driver on the same argv: their
    batches, the reference's per-step losses (each reading of its loss
    meter) and validation scores, and the port's run."""
    mp = pytest.MonkeyPatch()
    ref_seen, port_seen, ref_losses, ref_val = [], [], [], []
    meter_call = jax_logger.RunningMeter.__call__
    real_validate = jax_vqa.validate
    try:
        _recording(mp, jax_loader.TaskLoader, ref_seen)
        mp.setattr(jax_logger.RunningMeter, "__call__",
                   lambda self, v: ref_losses.append(v) or meter_call(self,
                                                                      v))
        mp.setattr(jax_vqa, "validate",
                   lambda *a: ref_val.append(real_validate(*a))
                   or ref_val[-1])
        ref_out = setup["root"] / f"ref_{name}"
        ref_main(argv_fn(ref_out))
        jax_logger.TB_LOGGER.log_scalar_dict({})     # flushes its scalars
        _recording(mp, loader.TaskLoader, port_seen)
        _reference_heads(mp)
        port_out = setup["root"] / f"port_{name}"
        run = port_main(argv_fn(port_out) + ["--device", "cpu"])
    finally:
        mp.undo()
    return {"ref": (str(ref_out), ref_seen, ref_losses, ref_val),
            "port": (str(port_out), port_seen, run)}


def _ref_ve(argv):
    opts = _parse(jax_ve, argv)
    opts.num_answer = 3
    return jax_vqa.main(opts)


RUNS = {
    "vqa": (lambda a: jax_vqa.main(_parse(jax_vqa, a)),
            lambda a: vqa.main(_parse(vqa, a)),
            lambda s, o: _vqa_argv(s, o)),
    "ve": (_ref_ve, lambda a: ve.main(_parse(ve, a)),
           lambda s, o: _vqa_argv(s, o, "ve"))}
for _fmt in FORMATS:
    RUNS[f"nlvr2-{_fmt}"] = (
        lambda a: jax_nlvr2.main(_parse(jax_nlvr2, a)),
        lambda a: nlvr2.main(_parse(nlvr2, a)),
        lambda s, o, f=_fmt: _nlvr2_argv(s, o, f))


_DONE = {}


def _both(setup, name):
    """The two runs of case ``name``, made once for the module."""
    if name not in _DONE:
        ref_main, port_main, argv = RUNS[name]
        _DONE[name] = _run_both(setup, name, ref_main, port_main,
                                lambda o: argv(setup, o))
    return name, _DONE[name]


@pytest.fixture(scope="module", params=list(RUNS))
def both(request, setup):
    return _both(setup, request.param)


@pytest.fixture(scope="module", params=FORMATS)
def nlvr2_both(request, setup):
    return _both(setup, f"nlvr2-{request.param}")


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


def test_driver_draws_the_reference_batches(both):
    name, res = both
    ref_seen, port_seen = res["ref"][1], res["port"][1]
    steps = 3 if name.startswith("nlvr2") else 4
    # VQA: every training batch, then each validation's two batches
    assert len(port_seen) == len(ref_seen) == steps + (4 if name == "vqa"
                                                       else 0)
    rows = 16 if name in ("nlvr2-paired", "nlvr2-paired-attn") else 8
    for got, want in zip(port_seen, ref_seen):
        if "soft_targets" not in got or got["input_ids"].shape[0] != 32:
            assert got["input_ids"].shape[0] == rows
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_driver_losses_and_validation_match_reference(both):
    name, res = both
    ref_out, _, ref_losses, ref_val = res["ref"]
    port_out, _, run = res["port"]
    steps = 3 if name.startswith("nlvr2") else 4
    assert run.step == steps
    assert [s for s, _ in run.losses] == list(range(1, steps + 1))
    np.testing.assert_allclose([v for _, v in run.losses], ref_losses,
                               rtol=RTOL)
    ref, port = _scalars(ref_out), _scalars(port_out)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert [s for s, _ in port[k]] == [s for s, _ in ref[k]], k
        np.testing.assert_allclose([v for _, v in port[k]],
                                   [v for _, v in ref[k]], rtol=RTOL,
                                   err_msg=k)
    if name == "vqa":
        assert [s for s, _ in run.val] == [2, 4] and len(ref_val) == 2
        np.testing.assert_allclose([v for _, v in run.val], ref_val,
                                   rtol=RTOL)
        assert all(0 <= v <= 1 for v in ref_val)
    elif name == "ve":
        # no validation database: the reference's validate returns None
        assert ref_val == [None] and run.val == []
    else:
        assert not ref_val and not hasattr(run, "val")


def test_driver_writes_the_reference_artifacts(both):
    name, res = both
    ref, port = res["ref"][0], res["port"][0]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    with open(os.path.join(port, "restore_hps.json")) as f, \
            open(os.path.join(ref, "restore_hps.json")) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(port, "log", "hps.json")) as f:
        got = json.load(f)
    with open(os.path.join(ref, "log", "hps.json")) as f:
        want = json.load(f)
    assert got.pop("device") == "cpu" and got.pop("dist_backend") is None
    assert got.pop("output_dir") == port and want.pop("output_dir") == ref
    if name.startswith("nlvr2"):
        assert got.pop("pred_csv") == port + ".csv"
        assert want.pop("pred_csv") == ref + ".csv"
    assert got == want
    steps = [2, 4] if name == "vqa" else [4] if name == "ve" else [3]
    assert sorted(os.listdir(os.path.join(ref, "ckpt"))) == [
        f"model_step_{s}.msgpack" for s in steps]
    assert sorted(os.listdir(os.path.join(port, "ckpt"))) == [
        f"model_step_{s}.pt" for s in steps]
    run = res["port"][2]
    sd = torch.load(os.path.join(port, "ckpt", f"model_step_{steps[-1]}.pt"),
                    weights_only=True)
    assert all(torch.equal(sd[k], v) for k, v in
               run.model.state_dict().items())


def _score(main, argv):
    """(exit code, printed lines) of a scorer's main."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(*argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def ref_scorer():
    spec = importlib.util.spec_from_file_location(
        "ref_eval_nlvr2", os.path.join(ROOT, "scripts", "eval_nlvr2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_predictions_and_scores_match_reference(nlvr2_both, setup,
                                                       ref_scorer,
                                                       tmp_path):
    _, res = nlvr2_both
    ref_csv, port_csv = res["ref"][0] + ".csv", res["port"][0] + ".csv"
    with open(ref_csv, "rb") as f, open(port_csv, "rb") as g:
        want, got = f.read(), g.read()
    assert got == want
    rows = got.decode().splitlines()
    with open(setup["annotations"]) as f:
        ids = [json.loads(line)["identifier"] for line in f]
    assert [r.split(",")[0] for r in rows] == ids      # the ragged tail too
    assert {r.split(",")[1] for r in rows} <= {"true", "false"}
    assert res["port"][2].preds == dict(r.split(",") for r in rows)
    ann = setup["annotations"]
    code, lines = _score(eval_nlvr2.main, (port_csv, ann))
    assert (code, lines) == _score(ref_scorer.main, (ref_csv, ann))
    assert code == 0 and [line.split("=")[0] for line in lines] == [
        "accuracy", "consistency"]
    short = tmp_path / "short.csv"
    short.write_text("\n".join(rows[:-3]) + "\n")
    code, lines = _score(eval_nlvr2.main, (str(short), ann))
    assert (code, lines) == _score(ref_scorer.main, (str(short), ann))
    assert code == 1 and lines[0] == "Some predictions are missing! (3)"


@pytest.mark.parametrize("port,ref", [(vqa, jax_vqa), (ve, jax_ve),
                                      (nlvr2, jax_nlvr2)],
                         ids=["vqa", "ve", "nlvr2"])
def test_parsers_match_reference(port, ref):
    argv = ["--train_txt_db", "t", "--train_img_db", "i"]
    got = vars(_parse(port, argv))
    assert got.pop("device") == "cuda" and got.pop("dist_backend") is None
    assert got == vars(_parse(ref, argv))
    flags = {a.dest for a in port.build_parser()._actions}
    assert flags - {a.dest for a in ref.build_parser()._actions} == {
        "device", "dist_backend"}


UNPORTED = [(["--n_model", "2"], "--n_model"),
            (["--coordinator_address", "localhost:1"],
             "--coordinator_address"),
            (["--num_processes", "2"], "--num_processes"),
            (["--process_id", "0"], "--process_id")]


# the distribution flags at a world of one: the coordinator's flags start
# a process group of one over gloo
WORLD_OF_ONE = {
    "--coordinator_address": ["--coordinator_address", "127.0.0.1:{port}",
                              "--num_processes", "1", "--process_id", "0"],
    "--num_processes": ["--num_processes", "1"],
    "--process_id": ["--process_id", "0"]}
SHORT = ["--device", "cpu", "--num_train_steps", "2", "--valid_steps",
         "2", "--save_steps", "100"]


def _short_run(setup, out, driver, extra=()):
    if driver == "vqa":
        return vqa.main(_parse(vqa, _vqa_argv(setup, out,
                                              extra=SHORT + list(extra))))
    return nlvr2.main(_parse(nlvr2, _nlvr2_argv(setup, out, "triplet",
                                                SHORT + list(extra))))


@pytest.fixture(scope="module")
def undistributed(setup):
    """Two steps of each driver without any distribution flag."""
    return {d: _short_run(setup, setup["root"] / f"undistributed_{d}", d)
            for d in ("vqa", "nlvr2")}


@pytest.mark.parametrize("driver", ["vqa", "nlvr2"])
@pytest.mark.parametrize("extra,name", UNPORTED,
                         ids=[n for _, n in UNPORTED])
def test_unported_flags_raise_by_name(setup, tmp_path, driver, extra, name,
                                      request):
    """--n_model 2 in a world of one raises by name (tensor parallelism
    needs as many processes, tests/test_torch_tp.py). The distribution
    flags are ported: at a world of one each run equals the undistributed
    one, losses and parameters bit for bit."""
    out = tmp_path / "out"
    if name not in WORLD_OF_ONE:
        with pytest.raises(ValueError if name == "--n_model"
                           else NotImplementedError,
                           match=name.replace("-", "\\-")):
            _short_run(setup, out, driver, extra)
        return
    want = request.getfixturevalue("undistributed")[driver]
    flags = [f.format(port=free_port()) for f in WORLD_OF_ONE[name]]
    try:
        got = _short_run(setup, out, driver, flags)
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


def test_resumed_vqa_run_loads_the_saved_state(setup, tmp_path,
                                               monkeypatch):
    """Two steps at dropout 0.1, then the same command with
    ``--num_train_steps 4``: the restore gives the model and the optimizer
    of step 2 bit for bit, and the run goes on to step 4."""
    out = tmp_path / "resumed"

    def argv(steps):
        a = _common(setup, out, "cfg_drop") + [
            "--device", "cpu", "--train_txt_db", setup["vqa"],
            "--num_answer", str(N_ANSWER), "--valid_steps", "2",
            "--val_txt_db", setup["vqa"], "--val_img_db", setup["img_db"],
            "--val_batches", "1", "--num_train_steps", str(steps)]
        return _parse(vqa, a)
    first = vqa.main(argv(2))
    assert first.step == 2 and [s for s, _ in first.val] == [2]
    want = _state(first.model, first.optimizer)
    restored = []
    real = checkpoint.TrainingRestorer.restore

    def restore(self, model, opt):
        step = real(self, model, opt)
        restored.append((step, _state(model, opt)))
        return step
    monkeypatch.setattr(checkpoint.TrainingRestorer, "restore", restore)
    second = vqa.main(argv(4))
    (step, got), = restored
    assert step == 2 and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert second.step == 4
    assert [s for s, _ in first.losses + second.losses] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for _, v in first.losses + second.losses)
    assert [s for s, _ in second.val] == [4]
    assert sorted(os.listdir(out / "ckpt")) == ["model_step_2.pt",
                                                "model_step_4.pt"]
