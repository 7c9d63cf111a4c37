"""The port's drivers under tensor parallelism (``--n_model 2``) in two
processes over gloo on the CPU, against the reference's drivers with
``--n_model 2`` (a (4, 2) mesh on the 8 virtual devices of
tests/conftest.py), at a tiny config (hidden 32, two heads, one layer,
fp32, dropout 0) from one UC2 checkpoint:

* ``python -m uc2_torch.pretrain --n_model 2`` against ``pretrain.py``
  for two steps: both processes (one model group: one replica) draw the
  reference's global batches bit for bit, and the per-step losses agree
  within 1e-4;
* saved at step 2 and extended to 3: the restored step, shards and
  optimizer state (gathered) bit for bit, the third step's loss the same
  on both processes;
* its milestone (the whole model, gathered) loaded without tensor
  parallelism gives the scores the model group gave, within 1e-5;
* ``python -m uc2_torch.itm --n_model 2`` against ``itm.py --n_model 2``:
  the batches bit for bit, and the validation R@K equal; with ``--quant
  int8`` (the validation scored by the int8 serving products, their
  maxima over the model group) the losses within 1e-4 and the validation
  R@K equal.

Port processes import no JAX."""

import json
import os
import pickle
import threading

import numpy as np
import pytest
import torch
import jax

import itm as jax_itm
import pretrain as jax_pretrain
from tests.torch_dist_util import STORE, pretrain_argv, spawn
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.data.synth import synth_corpus
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.utils import logger as jax_logger
from uc2_torch.config import UC2Config
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.training.step import eval_step

TINY = {"vocab_size": 512, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": False, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}
TP_FLAGS = ["--n_model", "2", "--valid_steps", "2"]


def _itm_argv(meta, out):
    """itm.py's flags: 4 groups of 3 rows a batch, which the reference's
    data axis (8 devices / 2) divides, so both take the same groups."""
    return [
        "--model_config", meta["model_config"], "--output_dir", out,
        "--train_txt_db", meta["txt_db"], "--train_img_db", meta["img_db"],
        "--val_txt_db", meta["txt_db"], "--val_img_db", meta["img_db"],
        "--checkpoint", meta["itm_ckpt"], "--max_txt_len", "18",
        "--max_bb", "12", "--min_bb", "4", "--train_batch_size", "12",
        "--eval_batch_size", "8", "--num_train_steps", "2",
        "--warmup_steps", "1", "--learning_rate", "3e-3",
        "--valid_steps", "2", "--eval_txt_limit", "12", "--save_steps", "5",
        "--log_steps", "1", "--dtype", "float32", "--seed", "0",
        "--n_model", "2"]


PORT = r'''
import json, os, pickle, sys
pid, coord, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
from tests.torch_dist_util import pretrain_argv
from uc2_torch import itm, pretrain
from uc2_torch.data import loader
from uc2_torch.parallel import mesh as M, multihost as MH
from uc2_torch.training import checkpoint as C
from uc2_torch.training.step import eval_step
meta = json.load(open(os.path.join(tmp, "meta.json")))
dist = ["--device", "cpu", "--coordinator_address", coord,
        "--num_processes", "2", "--process_id", str(pid)]
seen = []
nxt0 = loader.MetaLoader.__next__
def nxt(self):
    name, batch = nxt0(self)
    seen.append((name, {k: np.array(v) for k, v in batch.items()
                        if not k.startswith("_") and k != "sample_size"}))
    return name, batch
loader.MetaLoader.__next__ = nxt
rank_seen = []
stacked0 = loader.TaskLoader.next_batch
def next_batch(self, *a, **k):
    batch = stacked0(self, *a, **k)
    if self.name == "itm-rank":
        rank_seen.append({k: np.array(v) for k, v in batch.items()
                          if not k.startswith("_") and k != "sample_size"})
    return batch
loader.TaskLoader.next_batch = next_batch
restored = {}
restore0 = C.TrainingRestorer.restore
def restore(self, model, opt):
    step = restore0(self, model, opt)
    restored.update(step=step, model=C.host_copy(model.state_dict()),
                    opt=C.host_copy(opt.state_dict()))    # gathers
    return step
C.TrainingRestorer.restore = restore
def same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b

out_dir = os.path.join(tmp, "port")
argv = pretrain_argv(meta, out_dir) + meta["tp_flags"] + dist
run1 = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                argv))
assert run1.step == 2 and (M.model_count(), M.data_count()) == (2, 1)
assert run1.model.roberta.layer[0].attention.qkv.weight.shape[0] == 48
# the model group's scores on an mlm and an itm batch of the stores, for
# the milestone check
from uc2_torch.data import collate, datasets, db
txt = db.TxtTokDb(meta["txt_db"], max_txt_len=18)
img = db.DetectFeatDb(meta["img_db"], 0.2, 12, 4, 12)
batches = {}
for task, ds in (("mlm", datasets.MlmDataset(txt, img)),
                 ("itm", datasets.ItmDataset(txt, img, 0.5))):
    rng = np.random.default_rng(1)
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    ex = [ds.get_example(i, rng) for i in range(8)]
    b = ds.collate(ex, collate.BucketSpec(20, 12, 8,
                                          type(ds).slot_budget(20, 12)))
    batches[task] = {k: v for k, v in b.items()
                     if not k.startswith("_") and k != "sample_size"}
scores = {t: {k: v.numpy() for k, v in eval_step(run1.model, {
    k: torch.from_numpy(v) for k, v in b.items()}, t).items()}
    for t, b in batches.items()}
logits = run1.model.forward_mlm({k: torch.from_numpy(v) for k, v in
                                 batches["mlm"].items()},
                                compute_loss=False).detach().numpy()
saved = (C.host_copy(run1.model.state_dict()),
         C.host_copy(run1.optimizer.state_dict()))
first = seen[:2]
argv[argv.index("--num_train_steps") + 1] = "3"
run2 = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                argv))
resumed = {"step": restored["step"], "run2": run2.step,
           "model": same(restored["model"], saved[0]),
           "opt": same(restored["opt"], saved[1])}

iout = os.path.join(tmp, "itm_port")
irun = itm.main(itm.parse_with_config(itm.build_parser(), [
    a.replace("{out}", iout) for a in meta["itm_argv"]] + dist))
itm_batches = list(rank_seen)
qout = os.path.join(tmp, "itm8_port")
qrun = itm.main(itm.parse_with_config(itm.build_parser(), [
    a.replace("{out}", qout) for a in meta["itm_argv"]]
    + ["--quant", "int8"] + dist))
pickle.dump({"itm8_losses": qrun.losses, "batches": first,
             "losses": run1.losses + run2.losses, "scores": scores,
             "logits": logits, "eval_batches": batches, "resumed": resumed,
             "itm_val": irun.val, "itm_losses": irun.losses,
             "itm_batches": itm_batches},
            open(os.path.join(tmp, f"port_{pid}.pkl"), "wb"))
MH.shutdown()
print("port done", pid)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's drivers in this process and the port's in two."""
    tmp = tmp_path_factory.mktemp("tp_driver")
    corpus = synth_corpus(str(tmp / "c"), n_imgs=16, txt_per_img=2,
                          min_bb=4, max_bb=12, img_dim=16, n_classes=11,
                          seed=5, max_words=7, vocab=512)
    cfgp = tmp / "tiny.json"
    cfgp.write_text(json.dumps(TINY))
    params = jax.tree_util.tree_map(np.asarray, JaxPretraining(
        JaxConfig(**TINY)).init_params(jax.random.PRNGKey(3)))
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(params).items()},
               tmp / "uc2.pt")
    rng = np.random.default_rng(0)
    rparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.2,
        JaxRetrieval(JaxConfig(**TINY)).init_params(jax.random.PRNGKey(4)))
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(rparams).items()},
               tmp / "itm.pt")
    meta = {"txt_db": corpus["txt_db"], "img_db": corpus["img_db"],
            "model_config": str(cfgp), "ckpt": str(tmp / "uc2.pt"),
            "itm_ckpt": str(tmp / "itm.pt")}
    (tmp / "meta.json").write_text(json.dumps(dict(
        meta, tp_flags=TP_FLAGS, itm_argv=_itm_argv(meta, "{out}"))))

    # the port's processes run beside the reference's drivers here
    failed = []

    def run_port():
        try:
            spawn(PORT, [STORE, tmp], 2, tmp)
        except AssertionError as e:
            failed.append(e)     # a process failed, hung or was killed
    port_run = threading.Thread(target=run_port)
    port_run.start()
    # the reference: pretrain.py for 2 steps; itm.py
    mp = pytest.MonkeyPatch()
    seen, losses, rank_seen = [], [], []
    nxt0 = jax_loader.MetaLoader.__next__

    def nxt(self):
        name, batch = nxt0(self)
        seen.append((name, {k: np.array(v) for k, v in batch.items()
                            if not k.startswith("_")
                            and k != "sample_size"}))
        return name, batch
    meter0 = jax_logger.RunningMeter.__call__

    def meter(self, v):
        losses.append(float(v))
        return meter0(self, v)
    batch0 = jax_loader.TaskLoader.next_batch

    def next_batch(self, *a, **k):
        batch = batch0(self, *a, **k)
        if self.name == "itm-rank":
            rank_seen.append({k: np.array(v) for k, v in batch.items()
                              if not k.startswith("_")
                              and k != "sample_size"})
        return batch
    mp.setattr(jax_loader.MetaLoader, "__next__", nxt)
    mp.setattr(jax_logger.RunningMeter, "__call__", meter)
    mp.setattr(jax_loader.TaskLoader, "next_batch", next_batch)
    try:
        argv = pretrain_argv(meta, str(tmp / "ref")) + TP_FLAGS
        jax_pretrain.main(jax_pretrain.parse_with_config(
            jax_pretrain.build_parser(), argv))
        ref = {"batches": seen[:2], "losses": list(losses)}
        del losses[:]
        iout = str(tmp / "itm_ref")
        jax_itm.main(jax_itm.parse_with_config(jax_itm.build_parser(),
                                               _itm_argv(meta, iout)))
        ref.update(itm_losses=list(losses), itm_batches=list(rank_seen),
                   itm_val=_val_logs(iout))
        del losses[:]
        qout = str(tmp / "itm8_ref")
        jax_itm.main(jax_itm.parse_with_config(
            jax_itm.build_parser(), _itm_argv(meta, qout)
            + ["--quant", "int8"]))
        ref.update(itm8_losses=list(losses), itm8_val=_val_logs(qout))
    finally:
        mp.undo()
        port_run.join()
    if failed:
        raise failed[0]
    port = []
    for p in (0, 1):
        with open(tmp / f"port_{p}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return {"tmp": tmp, "ref": ref, "port": port,
            "port_itm_val": _val_logs(str(tmp / "itm_port")),
            "port_itm8_val": _val_logs(str(tmp / "itm8_port"))}


def _val_logs(out):
    """{(step, name): value} of a run's validation scalars."""
    got = {}
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k.startswith("val_"):
                    got[(rec["step"], k)] = v
    return got


@pytest.mark.parametrize("pid", [0, 1])
def test_the_model_group_draws_the_reference_batches(runs, pid):
    got, want = runs["port"][pid]["batches"], runs["ref"]["batches"]
    assert len(got) == len(want) == 2
    for (gn, gb), (wn, wb) in zip(got, want):
        assert gn == wn and set(gb) <= set(wb)
        for k in gb:
            assert gb[k].dtype == wb[k].dtype, k
            assert np.array_equal(gb[k], wb[k]), k


def test_pretraining_losses_match_the_reference(runs):
    want = runs["ref"]["losses"]
    for pid in (0, 1):
        got = runs["port"][pid]["losses"]
        assert [s for s, _, _ in got] == [1, 2, 3]
        np.testing.assert_allclose([v for _, _, v in got[:2]], want,
                                   rtol=1e-4, atol=1e-4)
    assert runs["port"][0]["losses"] == runs["port"][1]["losses"]


@pytest.mark.parametrize("pid", [0, 1])
def test_the_resume_restores_bit_for_bit(runs, pid):
    r = runs["port"][pid]["resumed"]
    assert r == {"step": 2, "run2": 3, "model": True, "opt": True}


def test_the_milestone_loads_without_tensor_parallelism(runs):
    """``ckpt/model_step_2.pt`` holds the whole model: loaded into a model
    without tensor parallelism it gives the model group's scores."""
    sd = torch.load(runs["tmp"] / "port" / "ckpt" / "model_step_2.pt",
                    weights_only=True)
    m = UC2ForPretraining(UC2Config(**TINY, dtype="float32"), device="cpu")
    m.load_state_dict(sd)
    port = runs["port"][0]
    for task, want in port["scores"].items():
        b = {k: torch.from_numpy(v) for k, v in
             port["eval_batches"][task].items()}
        got = eval_step(m, b, task)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{task} {k}")
    b = {k: torch.from_numpy(v) for k, v in
         port["eval_batches"]["mlm"].items()}
    logits = m.forward_mlm(b, compute_loss=False).detach().numpy()
    assert logits.shape[-1] == TINY["vocab_size"]
    np.testing.assert_allclose(logits, port["logits"], rtol=1e-5, atol=1e-5)


def test_itm_validation_matches_the_reference(runs):
    for pid in (0, 1):
        got = runs["port"][pid]["itm_batches"]
        assert len(got) == len(runs["ref"]["itm_batches"]) == 2
        for gb, wb in zip(got, runs["ref"]["itm_batches"]):
            for k in gb:
                assert np.array_equal(gb[k], wb[k]), k
        np.testing.assert_allclose([v for _, v in
                                    runs["port"][pid]["itm_losses"]],
                                   runs["ref"]["itm_losses"], rtol=1e-4,
                                   atol=1e-4)
    want = runs["ref"]["itm_val"]
    assert want and runs["port_itm_val"] == want
    assert {k for _, k in want} >= {"val_img_r1", "val_img_r10"}


def test_itm_int8_validation_matches_the_reference(runs):
    """``--quant int8 --n_model 2``: the training in fp32 as above, the
    validation's scores through the int8 row-parallel products; the
    losses within 1e-4 and the validation R@K equal to ``itm.py``'s."""
    for pid in (0, 1):
        np.testing.assert_allclose([v for _, v in
                                    runs["port"][pid]["itm8_losses"]],
                                   runs["ref"]["itm8_losses"], rtol=1e-4,
                                   atol=1e-4)
    want = runs["ref"]["itm8_val"]
    assert want and runs["port_itm8_val"] == want
    assert {k for _, k in want} >= {"val_img_r1", "val_img_r10"}
