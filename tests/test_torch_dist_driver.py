"""The port's drivers in two processes over gloo on the CPU, each process
on its stripe of the data (the corpus and flags of
tests/test_multihost_2proc.py, at dropout 0 in the tiny config):

* ``python -m uc2_torch.pretrain`` with ``--zero1``, a save at step 2 and a
  resume to step 3, against ``pretrain.py``'s two-process run on the same
  inputs and the same UC2 checkpoint: each process's batches bit for bit,
  the per-step losses within 1e-4; the restored step, model and optimizer
  bit for bit, both stream files present; the host-sharded retrieval
  eval's merged R@K equal to the reference's;
* ``python -m uc2_torch.itm`` over two databases with hard negatives and
  ``--zero1``: per-process mined files, and the gathered score matrix
  (and ``test_results.json``) equal to one process's;
* ``python -m uc2_torch.vqa``: trains and validates; ``python -m
  uc2_torch.nlvr2``: its batch raised to the world, the prediction sweep
  over every example on both processes;
* each driver at ``--n_model 2`` for one step with ``UC2_ATTN_V2=1``,
  ``UC2_FFN_TRAIN=1`` and ``UC2_FUSE_ATTN_ALL=1`` under "pallas-train"
  (#9/#10's partial modes in training, #7's in the validation or the
  prediction sweep), its losses those of the same driver in one process
  at 1e-4.

Port processes import no JAX; the reference's set ``JAX_PLATFORMS=cpu``."""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import jax

from tests.torch_dist_util import free_port, spawn
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data.synth import synth_corpus
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_torch.config import UC2Config
from uc2_torch.data.synth import synth_finetune_texts
from uc2_torch.models.convert import params_to_jax
from uc2_torch.models.finetune import UC2ForImageTextRetrieval

TINY = {"vocab_size": 512, "hidden_size": 32, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "img_dim": 16, "img_label_dim": 11,
        "use_pallas_attention": False, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}


REFERENCE = r'''
import json, os, pickle, sys
pid, coord, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
import numpy as np
from tests.torch_dist_util import pretrain_argv
from uc2_tpu.data import loader
from uc2_tpu.utils import logger
meta = json.load(open(os.path.join(tmp, "meta.json")))
seen, losses = [], []
nxt0 = loader.MetaLoader.__next__
def nxt(self):
    name, batch = nxt0(self)
    seen.append((name, {k: np.array(v) for k, v in batch.items()
                        if not k.startswith("_") and k != "sample_size"}))
    return name, batch
loader.MetaLoader.__next__ = nxt
meter0 = logger.RunningMeter.__call__
def meter(self, v):
    losses.append(float(v))
    return meter0(self, v)
logger.RunningMeter.__call__ = meter
import pretrain
argv = pretrain_argv(meta, os.path.join(tmp, "ref"))
state = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                 argv))
assert int(state.step) == 2
first = seen[:2]
n1 = len(seen)
argv[argv.index("--num_train_steps") + 1] = "3"
state = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                 argv))
assert int(state.step) == 3
from uc2_tpu.config import UC2Config
from uc2_tpu.data.db import DetectFeatDb, TxtTokDb
from uc2_tpu.evalu.retrieval import full_retrieval_eval
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval
cfg = UC2Config(**json.load(open(meta["model_config"])), dtype="float32")
params = pickle.load(open(os.path.join(tmp, "retrieval.pkl"), "rb"))
log = full_retrieval_eval(
    UC2ForImageTextRetrieval(cfg), params,
    TxtTokDb(meta["txt_db"], max_txt_len=18),
    DetectFeatDb(meta["img_db"], 0.2, 12, 4, 12), 20, 12, batch_size=8)
pickle.dump({"batches": first + seen[n1:n1 + 1], "losses": losses,
             "rk": log}, open(os.path.join(tmp, f"ref_{pid}.pkl"), "wb"))
print("reference done", pid)
'''

PORT = r'''
import json, os, pickle, sys
pid, coord, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
from tests.torch_dist_util import pretrain_argv
from uc2_torch import itm, nlvr2, pretrain, vqa
from uc2_torch.data import loader
from uc2_torch.parallel import multihost as MH
from uc2_torch.training import checkpoint as C
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
restored = {}
restore0 = C.TrainingRestorer.restore
def restore(self, model, opt):
    step = restore0(self, model, opt)
    # copies: the live state moves on with the next step
    restored.update(step=step, model=C.host_copy(model.state_dict()),
                    opt=C.host_copy(opt.state_dict()))    # a gather
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

# ---- pretraining: 2 steps with a save at 2, then resumed to 3
argv = pretrain_argv(meta, os.path.join(tmp, "port")) + dist
run1 = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                argv))
assert run1.step == 2
saved = (C.host_copy(run1.model.state_dict()),
         C.host_copy(run1.optimizer.state_dict()))
assert run1.optimizer.parts, "--zero1 split no moment"
first = seen[:2]
n1 = len(seen)
argv[argv.index("--num_train_steps") + 1] = "3"
run2 = pretrain.main(pretrain.parse_with_config(pretrain.build_parser(),
                                                argv))
assert run2.step == 3 and restored["step"] == 2
assert same(restored["model"], saved[0]), "model not restored bit for bit"
assert same(restored["opt"], saved[1]), "optimizer not restored bit for bit"
for r in (0, 1):
    assert os.path.exists(os.path.join(tmp, "port",
                                       f"restore_stream_p{r}.json"))

# ---- host-sharded retrieval eval
from uc2_torch.config import UC2Config
from uc2_torch.data.db import DetectFeatDb, TxtTokDb
from uc2_torch.evalu.itm_metrics import itm_eval
from uc2_torch.evalu.retrieval import full_retrieval_eval, score_matrix
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
cfg = UC2Config(**json.load(open(meta["model_config"])), dtype="float32")
model = UC2ForImageTextRetrieval(cfg, device="cpu")
model.load_state_dict(torch.load(os.path.join(tmp, "retrieval.pt"),
                                 weights_only=True))
tdb = TxtTokDb(meta["txt_db"], max_txt_len=18)
idb = DetectFeatDb(meta["img_db"], 0.2, 12, 4, 12)
rk = full_retrieval_eval(model, tdb, idb, 20, 12, batch_size=8,
                         device="cpu")

# ---- itm: two databases, hard negatives, ZeRO-1, a gathered test eval
iout = os.path.join(tmp, "itm_out")
irun = itm.main(itm.parse_with_config(itm.build_parser(), [
    "--model_config", meta["model_config"], "--output_dir", iout,
    "--train_txt_db", json.dumps([meta["txt_db"], meta["txt_db2"]]),
    "--train_img_db", json.dumps([meta["img_db"], meta["img_db2"]]),
    "--test_datasets", json.dumps([{"name": "t", "db": meta["txt_db"],
                                    "img": meta["img_db"]}]),
    "--max_txt_len", "18", "--max_bb", "12", "--min_bb", "4",
    "--train_batch_size", "14", "--eval_batch_size", "8",
    "--num_train_steps", "2", "--warmup_steps", "1", "--valid_steps", "0",
    "--save_steps", "5", "--log_steps", "1", "--hard_neg_size", "2",
    "--zero1", "--dtype", "float32", "--seed", "0"] + dist))
assert irun.step == 2
for k in (0, 1):
    mine = os.path.join(iout, f"hard_negs_0.db{k}.host{pid}.json")
    pools = json.load(open(mine))
    assert pools["txt2hardimgs"] and pools["img2hardtxts"], mine
log, (m, t_ids, i_ids) = full_retrieval_eval(
    irun.model, tdb, idb, 20, 12, batch_size=8, return_matrix=True,
    device="cpu")
one = score_matrix(irun.model, tdb, idb, t_ids, i_ids, 20, 12,
                   batch_size=8, device="cpu")
assert np.array_equal(m, one), np.abs(m - one).max()
assert log == itm_eval(one, t_ids, i_ids, tdb.txt2img, tdb.img2txts)
assert irun.results["t"] == log
flat = torch.cat([p.detach().reshape(-1) for p in irun.model.parameters()])
both = MH.all_gather_object(flat.numpy())
assert np.array_equal(both[0], both[1]), "the processes' models differ"

# ---- vqa: trains and validates
vout = os.path.join(tmp, "vqa_out")
vrun = vqa.main(vqa.parse_with_config(vqa.build_parser(), [
    "--model_config", meta["model_config"], "--output_dir", vout,
    "--train_txt_db", meta["vqa_txt_db"], "--train_img_db", meta["img_db"],
    "--val_txt_db", meta["vqa_txt_db"], "--val_img_db", meta["img_db"],
    "--num_answer", "9", "--max_txt_len", "16", "--max_bb", "12",
    "--min_bb", "4", "--train_batch_size", "7", "--num_train_steps", "3",
    "--warmup_steps", "1", "--valid_steps", "3", "--val_batches", "2",
    "--save_steps", "3", "--log_steps", "1", "--dtype", "float32",
    "--seed", "0"] + dist))
assert vrun.step == 3 and len(vrun.val) == 1

# ---- nlvr2 (triplet): the batch raised to the world, the sweep whole
csv_path = os.path.join(tmp, "preds.csv")
nrun = nlvr2.main(nlvr2.parse_with_config(nlvr2.build_parser(), [
    "--model_config", meta["model_config"],
    "--output_dir", os.path.join(tmp, "nlvr2_out"),
    "--train_txt_db", meta["nlvr2_txt_db"], "--train_img_db", meta["img_db"],
    "--fmt", "triplet", "--max_txt_len", "16", "--max_bb", "12",
    "--min_bb", "4", "--train_batch_size", "3", "--num_train_steps", "2",
    "--warmup_steps", "1", "--valid_steps", "0", "--save_steps", "5",
    "--log_steps", "1", "--pred_csv", csv_path, "--dtype", "float32",
    "--seed", "0"] + dist))
assert nrun.step == 2
pickle.dump({"batches": first + seen[n1:n1 + 1], "losses": run1.losses
             + run2.losses, "rk": rk, "vqa": (vrun.losses, vrun.val),
             "vqa_rows": vrun.logs[-1][2], "nlvr2_rows": nrun.logs[-1][2],
             "preds": nrun.preds},
            open(os.path.join(tmp, f"port_{pid}.pkl"), "wb"))
MH.shutdown()
print("port done", pid)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two-process runs on one corpus and checkpoint."""
    tmp = tmp_path_factory.mktemp("dist_driver")
    corpus = synth_corpus(str(tmp / "c"), n_imgs=16, txt_per_img=2,
                          min_bb=4, max_bb=12, img_dim=16, n_classes=11,
                          seed=5, max_words=7, vocab=512)
    corpus2 = synth_corpus(str(tmp / "c2"), n_imgs=12, txt_per_img=2,
                           min_bb=4, max_bb=12, img_dim=16, n_classes=11,
                           seed=23, max_words=7, vocab=512)
    vqa_db = synth_finetune_texts(str(tmp / "vqa"), corpus["txt_db"], "vqa",
                                  seed=1, num_answer=9)["txt_db"]
    nl_db = synth_finetune_texts(str(tmp / "nlvr2"), corpus["txt_db"],
                                 "nlvr2", seed=3)["txt_db"]
    cfgp = tmp / "tiny.json"
    cfgp.write_text(json.dumps(TINY))
    params = JaxPretraining(JaxConfig(**TINY)).init_params(
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    torch.save({k: torch.tensor(v) for k, v in
                jax_convert.params_to_torch_state_dict(params).items()},
               tmp / "uc2.pt")
    sd = UC2ForImageTextRetrieval(UC2Config(**TINY, dtype="float32"),
                                  device="cpu", seed=1).state_dict()
    torch.save(sd, tmp / "retrieval.pt")
    with open(tmp / "retrieval.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params_to_jax(sd)), f)
    (tmp / "meta.json").write_text(json.dumps({
        "txt_db": corpus["txt_db"], "img_db": corpus["img_db"],
        "txt_db2": corpus2["txt_db"], "img_db2": corpus2["img_db"],
        "vqa_txt_db": vqa_db, "nlvr2_txt_db": nl_db,
        "model_config": str(cfgp),
        "ckpt": str(tmp / "uc2.pt")}))
    spawn(REFERENCE, [f"127.0.0.1:{free_port()}", tmp], 2, tmp)
    spawn(PORT, [f"127.0.0.1:{free_port()}", tmp], 2, tmp)

    def load(name):
        with open(tmp / name, "rb") as f:
            return pickle.load(f)
    return {"tmp": tmp,
            "ref": [load(f"ref_{p}.pkl") for p in (0, 1)],
            "port": [load(f"port_{p}.pkl") for p in (0, 1)],
            "csv": (tmp / "preds.csv").read_text().splitlines(),
            "nlvr2_ids": len(json.loads(open(os.path.join(
                nl_db, "id2len.json")).read()))}


@pytest.mark.parametrize("pid", [0, 1])
def test_each_process_draws_the_reference_batches(runs, pid):
    got, want = runs["port"][pid]["batches"], runs["ref"][pid]["batches"]
    assert len(got) == len(want) == 3
    for (gn, gb), (wn, wb) in zip(got, want):
        assert gn == wn and set(gb) <= set(wb)
        for k in gb:
            assert gb[k].dtype == wb[k].dtype, k
            assert np.array_equal(gb[k], wb[k]), k
    other = runs["port"][1 - pid]["batches"]
    assert not np.array_equal(got[0][1]["input_ids"],
                              other[0][1]["input_ids"])


def test_losses_and_merged_recall_match_the_reference(runs):
    for pid in (0, 1):
        port, ref = runs["port"][pid], runs["ref"][pid]
        assert [s for s, _, _ in port["losses"]] == [1, 2, 3]
        np.testing.assert_allclose([v for _, _, v in port["losses"]],
                                   ref["losses"], rtol=1e-4, atol=1e-4)
        assert port["rk"] == ref["rk"]
        assert {"img_r1", "txt_r1", "img_r10"} <= set(port["rk"])
    assert runs["port"][0]["losses"] == runs["port"][1]["losses"]


def test_vqa_trains_and_validates_in_two_processes(runs):
    p0, p1 = runs["port"]
    assert p0["vqa"] == p1["vqa"]
    losses, val = p0["vqa"]
    assert [s for s, _ in losses] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in losses)
    assert val[0][0] == 3 and 0.0 <= val[0][1] <= 1.0
    assert p0["vqa_rows"] == 3 * 2 * 6     # 7 rows rounded down to 6, 2 ranks


def test_nlvr2_raises_its_batch_and_sweeps_every_example(runs):
    """Triplet batches of 3 examples raised to 4 (the rows divide the two
    processes); both processes predict every example of the whole text
    database, and process 0 writes the CSV."""
    p0, p1 = runs["port"]
    assert p0["nlvr2_rows"] == 2 * 2 * 4
    assert p0["preds"] == p1["preds"]
    assert len(p0["preds"]) == runs["nlvr2_ids"] == len(runs["csv"])
    assert runs["csv"] == [f"{k},{v}" for k, v in p0["preds"].items()]


ROUTES = r'''
import json, os, pickle, sys
pid, coord, tmp, world = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          int(sys.argv[4]))
os.environ.update(UC2_ATTN_V2="1", UC2_FFN_TRAIN="1", UC2_FUSE_ATTN_ALL="1")
from tests.torch_dist_util import pretrain_argv
from uc2_torch import itm, nlvr2, pretrain, vqa
from uc2_torch.models import encoder as E
from uc2_torch.parallel import multihost as MH
meta = json.load(open(os.path.join(tmp, "meta.json")))
cfg = meta["routes_config"]
flags = ["--device", "cpu", "--n_model", str(world)] + (
    ["--coordinator_address", coord, "--num_processes", "2",
     "--process_id", str(pid)] if world == 2 else [])
calls = {}
def counted(name):
    fn = getattr(E, name)
    def call(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    setattr(E, name, call)
for name in ("fused_attn_block_v2", "fused_attn_block_v2_partial",
             "fused_ffn_block_train", "fused_ffn_block_train_partial"):
    counted(name)
out = {}
def run(name, mod, argv):
    global calls
    calls = {}
    r = mod.main(mod.parse_with_config(mod.build_parser(), argv + flags))
    out[name] = {"losses": [list(x) for x in r.losses], "calls": calls}
argv = [a for a in pretrain_argv(dict(meta, model_config=cfg),
                                 os.path.join(tmp, f"routes_pre_{world}"))
        if a != "--zero1"]
run("pretrain", pretrain, argv + [
    "--num_train_steps", "1", "--save_steps", "5", "--valid_steps", "1",
    "--val_datasets", argv[argv.index("--train_datasets") + 1]])
run("itm", itm, [
    "--model_config", cfg, "--output_dir", os.path.join(tmp, f"routes_itm_{world}"),
    "--train_txt_db", meta["txt_db"], "--train_img_db", meta["img_db"],
    "--val_txt_db", meta["txt_db"], "--val_img_db", meta["img_db"],
    "--max_txt_len", "18", "--max_bb", "12", "--min_bb", "4",
    "--train_batch_size", "12", "--eval_batch_size", "8",
    "--num_train_steps", "1", "--warmup_steps", "1", "--valid_steps", "1",
    "--eval_txt_limit", "8", "--save_steps", "5", "--log_steps", "1",
    "--dtype", "float32", "--seed", "0"])
run("vqa", vqa, [
    "--model_config", cfg, "--output_dir", os.path.join(tmp, f"routes_vqa_{world}"),
    "--train_txt_db", meta["vqa_txt_db"], "--train_img_db", meta["img_db"],
    "--val_txt_db", meta["vqa_txt_db"], "--val_img_db", meta["img_db"],
    "--num_answer", "9", "--max_txt_len", "16", "--max_bb", "12",
    "--min_bb", "4", "--train_batch_size", "8", "--num_train_steps", "1",
    "--warmup_steps", "1", "--valid_steps", "1", "--val_batches", "1",
    "--save_steps", "5", "--log_steps", "1", "--dtype", "float32",
    "--seed", "0"])
run("nlvr2", nlvr2, [
    "--model_config", cfg, "--output_dir", os.path.join(tmp, f"routes_nl_{world}"),
    "--train_txt_db", meta["nlvr2_txt_db"], "--train_img_db", meta["img_db"],
    "--fmt", "paired-attn", "--max_txt_len", "16", "--max_bb", "12",
    "--min_bb", "4", "--train_batch_size", "4", "--num_train_steps", "1",
    "--warmup_steps", "1", "--valid_steps", "0", "--save_steps", "5",
    "--log_steps", "1", "--pred_csv", os.path.join(tmp, f"routes_{world}.csv"),
    "--dtype", "float32", "--seed", "0"])
json.dump(out, open(os.path.join(tmp, f"routes_{world}_{pid}.json"), "w"))
MH.shutdown()
print("routes done", pid)
'''


@pytest.fixture(scope="module")
def routes(runs):
    """Every driver for one step under "pallas-train" with the kernel
    routes' switches set, at ``--n_model 2`` in two processes and without
    tensor parallelism in one, on ``runs``' stores and checkpoint."""
    tmp = runs["tmp"]
    cfgp = tmp / "tiny_routes.json"
    cfgp.write_text(json.dumps(dict(TINY,
                                    use_pallas_attention="pallas-train")))
    meta = json.loads((tmp / "meta.json").read_text())
    (tmp / "meta.json").write_text(json.dumps(dict(
        meta, routes_config=str(cfgp))))
    spawn(ROUTES, [f"127.0.0.1:{free_port()}", tmp, 2], 2, tmp)
    spawn(ROUTES, ["", tmp, 1], 1, tmp)
    return {w: [json.loads((tmp / f"routes_{w}_{p}.json").read_text())
                for p in range(w)] for w in (1, 2)}


@pytest.mark.parametrize("driver", ["pretrain", "itm", "vqa", "nlvr2"])
def test_tensor_parallel_drivers_take_every_route(routes, driver):
    """Under ``--n_model 2`` the drivers take the kernel routes that raised
    before: the training FFN block in its partial modes in every layer of
    the step, #7's partial mode in the inference that follows (validation,
    or nlvr2's prediction sweep); the losses are the one-process run's,
    which takes the whole kernels, at 1e-4, the same on both processes."""
    one = routes[1][0][driver]
    assert one["losses"]
    assert set(one["calls"]) == {"fused_attn_block_v2",
                                 "fused_ffn_block_train"}
    for p in (0, 1):
        got = routes[2][p][driver]
        assert set(got["calls"]) == {"fused_attn_block_v2_partial",
                                     "fused_ffn_block_train_partial"}
        assert got["calls"]["fused_ffn_block_train_partial"] == \
            one["calls"]["fused_ffn_block_train"]
        assert got["calls"]["fused_attn_block_v2_partial"] == \
            one["calls"]["fused_attn_block_v2"]
        assert [x[:-1] for x in got["losses"]] == \
            [x[:-1] for x in one["losses"]]
        np.testing.assert_allclose([x[-1] for x in got["losses"]],
                                   [x[-1] for x in one["losses"]],
                                   rtol=1e-4, atol=1e-4)
    assert routes[2][0][driver]["losses"] == routes[2][1][driver]["losses"]
