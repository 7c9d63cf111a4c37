"""Data parallelism across processes (``uc2_torch.parallel``) on the CPU
over gloo, in spawned processes that import nothing of JAX, at a tiny
config (h = 64, two layers, fp32, dropout 0):

* the object and store collectives at worlds 1 and 2, the store broadcast
  from a thread while the main thread runs collectives, a store wait
  given up when its stop is set, a resume that one process cannot see
  refused on both;
* the two processes' gradients of mlm, itm with OT, mrfr and a stacked
  accumulation window of mlm, each process on its half of a batch,
  summed by ``reduce_grads``, against the gradient that the reference's
  loss and grad function (``uc2_tpu.training.step``) gives on the whole
  batch in one process, at 1e-4;
* ZeRO-1 equal to the replicated two-process run bit for bit after three
  steps (AdamW and Adamax), each process holding about half of the
  moments, ``state_dict`` gathering them whole and ``load_state_dict``
  cutting them again;
* the two processes' dropout keep masks differ, and process 0's are the
  one-process masks."""

import json
import threading

import numpy as np
import pytest
import torch
import jax

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, datasets
from uc2_torch.data.memdb import synth_pretrain_corpus
from uc2_torch.models.convert import params_from_jax, params_to_jax
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng, dropout
from uc2_torch.parallel import multihost as MH
from uc2_torch.pretrain import step_seed
from tests.torch_dist_util import STORE, spawn

VOCAB = 1000
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, use_pallas_attention=False)
CORPUS = dict(n_imgs=8, txt_per_img=2, vocab=VOCAB, img_dim=32, min_bb=3,
              max_bb=8, max_words=4, n_classes=11)
LT, NB, B = 24, 8, 8          # B rows a global batch, B / 2 a process
TOL = dict(rtol=1e-4, atol=1e-4)
# task -> (reference task, loss keywords)
TASKS = {"mlm": ("mlm", {}), "itm-ot": ("itm-ot", {"itm_ot_lambda": 0.1}),
         "mrfr": ("mrfr", {}), "mlm-stacked": ("mlm", {})}


# ------------------------------------------------ object and store collectives
COLLECTIVES = r'''
import sys, threading, torch
rank, addr = int(sys.argv[1]), sys.argv[2]
from uc2_torch.parallel import multihost as MH
assert MH.maybe_initialize(addr, 2, rank, device="cpu")
assert MH.maybe_initialize(addr, 2, rank, device="cpu")      # kept
assert (MH.process_count(), MH.process_index()) == (2, rank)
assert MH.all_gather_object({"r": rank}) == [{"r": 0}, {"r": 1}]
assert MH.broadcast_object("x" if rank == 0 else None) == "x"
assert MH.broadcast_object(rank * 10, root=1) == 10
assert MH.sum_across_hosts(rank + 0.5) == 2.0
MH.check_restore_agrees(True)
try:                           # a resume that process 1 cannot see
    MH.check_restore_agrees(rank == 0)
    raise SystemExit("a one-sided resume was let through")
except RuntimeError as e:      # on every process, not only process 1
    assert "visible to processes [0] only" in str(e), e
res = {}
def bg():
    for i in range(3):
        res[i] = MH.kv_broadcast_object(
            f"uc2/test/{i}", {"win": i} if rank == 0 else None)
t = threading.Thread(target=bg)
t.start()
for _ in range(20):            # the group's collectives meanwhile
    x = torch.ones(4) * (rank + 1)
    torch.distributed.all_reduce(x)
    assert x.tolist() == [3.0] * 4
t.join(timeout=60)
assert not t.is_alive(), "kv broadcast deadlocked"
assert res == {i: {"win": i} for i in range(3)}, res
if rank == 1:                  # a wait that process 0 never answers
    stop = threading.Event()
    threading.Timer(0.2, stop.set).start()
    try:
        MH.kv_broadcast_object("uc2/test/never", stop=stop)
        raise SystemExit("the wait was not given up")
    except MH.Cancelled:
        pass
torch.distributed.barrier()
if rank == 0:
    MH.kv_delete("uc2/test/0")
    MH.kv_delete("uc2/test/missing")
torch.distributed.barrier()
assert not MH._kv_store().check(["uc2/test/0"])
MH.shutdown()
assert MH.process_count() == 1
print("collectives ok", rank)
'''


def test_collectives_at_world_two(tmp_path):
    outs = spawn(COLLECTIVES, [STORE], 2, tmp_path)
    assert all("collectives ok" in o for o in outs)


def test_collectives_at_world_one_and_from_the_environment(monkeypatch):
    """World 1 over gloo in this process (flags, then the environment):
    each object collective is the identity, the store broadcast returns
    its object from a thread; without a coordinator nothing starts."""
    assert not MH.maybe_initialize(device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        MH.maybe_initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="dist_backend gloo"):
        MH.maybe_initialize("127.0.0.1:0", 1, 0,
                            backend="nccl", device="cpu")
    for how in ("flags", "env"):
        # port 0: the store of a group of one binds a port the OS chooses
        if how == "env":
            monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
            monkeypatch.setenv("MASTER_PORT", "0")
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            args = ()
        else:
            args = ("127.0.0.1:0", 1, 0)
        try:
            assert MH.maybe_initialize(*args, device="cpu")
            assert (MH.process_count(), MH.process_index()) == (1, 0)
            assert torch.distributed.get_backend() == "gloo"
            assert MH.all_gather_object(7) == [7]
            assert MH.broadcast_object("y") == "y"
            assert MH.sum_across_hosts(2.5) == 2.5
            got = []
            t = threading.Thread(target=lambda: got.append(
                MH.kv_broadcast_object("uc2/one", [1, 2])))
            t.start()
            t.join(timeout=30)
            assert got == [[1, 2]]
            MH.kv_delete("uc2/one")
        finally:
            MH.shutdown()
        assert MH.process_count() == 1


TORCHRUN = r'''
import os
from uc2_torch.parallel import multihost as MH
assert os.environ["TORCHELASTIC_USE_AGENT_STORE"] == "True"
assert MH.maybe_initialize(device="cpu")       # from torchrun's environment
r = MH.process_index()
assert (MH.process_count(), MH.all_gather_object(r)) == (2, [0, 1])
assert MH.kv_broadcast_object("uc2/tr", "v" if r == 0 else None) == "v"
MH.shutdown()
print("torchrun ok", r)
'''


def test_torchrun_environment_starts_the_group(tmp_path):
    """Under torchrun (``--standalone``: the agent binds a port the OS
    chooses) the agent serves the store at MASTER_PORT: the processes join
    it as clients."""
    script = tmp_path / "tr.py"
    script.write_text(TORCHRUN)
    out = spawn("import runpy, sys\n"
                "sys.argv = ['torchrun'] + sys.argv[2:]\n"
                "runpy.run_module('torch.distributed.run', "
                "run_name='__main__')\n",
                ["--nproc_per_node", "2", "--standalone", script], 1,
                tmp_path)
    assert out[0].count("torchrun ok") == 2


# ------------------------------------------- gradients, ZeRO-1, dropout masks
STEPS = r'''
import json, sys
import numpy as np, torch
rank, addr, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from uc2_torch.parallel import mesh as M, multihost as MH
assert MH.maybe_initialize(addr, 2, rank, device="cpu")
from uc2_torch.config import UC2Config
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng, dropout
from uc2_torch.pretrain import step_seed
from uc2_torch.training import optim as O, step as S
meta = json.load(open(f"{tmp}/meta.json"))
sd = torch.load(f"{tmp}/init.pt", weights_only=True)
cfg = UC2Config(**meta["cfg"])

def local(task):
    """This process's rows of the task's global batch."""
    z = np.load(f"{tmp}/batch_{task}.npz")
    ax = 1 if task.endswith("stacked") else 0
    out = {}
    for k in z.files:
        a = z[k]
        h = a.shape[ax] // 2
        out[k] = torch.from_numpy(np.ascontiguousarray(
            a[:, rank * h:(rank + 1) * h] if ax else
            a[rank * h:(rank + 1) * h]))
    return out

def model():
    m = UC2ForPretraining(cfg, device="cpu", seed=rank + 5)
    m.load_state_dict(sd)
    M.broadcast_params(m)          # rank 0's copy everywhere
    return m

out = {}
for name, (task, kw) in meta["tasks"].items():
    m = model()
    metrics = S.accumulate_grads(S.make_loss_fn(task, **kw), m, local(name),
                                 None)
    params = list(m.parameters())
    metrics = M.reduce_grads(params, metrics)
    np.savez(f"{tmp}/grads_{name}_{rank}.npz", **{
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        for n, p in m.named_parameters()})
    out[name] = {k: float(v) for k, v in metrics.items()}

# ZeRO-1 against the replicated run: three steps of three tasks
steps = [("mlm", "mlm", {}), ("itm-ot", "itm-ot", {"itm_ot_lambda": 0.1}),
         ("mrfr", "mrfr", {})]
for optim in ("adamw", "adamax"):
    runs = {}
    for zero1 in (False, True):
        m = model()
        opt = O.build_optimizer(m, O.warmup_linear(1e-3, 2, 10), 0.01,
                                grad_norm=1.0, optim=optim, zero1=zero1)
        for name, task, kw in steps:
            S.train_step(m, opt, local(name), None, task=task, **kw)
        runs[zero1] = (m, opt)
    (m0, o0), (m1, o1) = runs[False], runs[True]
    same = all(torch.equal(a, b) for a, b in
               zip(m0.state_dict().values(), m1.state_dict().values()))
    s0, s1 = o0.state_dict(), o1.state_dict()       # s1: gathered
    moments = [k for k in s0["state"]["state"][0] if k != "step"]
    same_state = all(torch.equal(s0["state"]["state"][i][k],
                                 s1["state"]["state"][i][k])
                     for i in s0["state"]["state"] for k in moments)
    own = sum(o1.opt.state[t][moments[0]].numel()
              for g in o1.opt.param_groups for t in g["params"])
    total = sum(p.numel() for p in m1.parameters())
    # the replicated state read back under ZeRO-1 and gathered again
    o2 = O.build_optimizer(model(), O.warmup_linear(1e-3, 2, 10), 0.01,
                           grad_norm=1.0, optim=optim, zero1=True)
    o2.load_state_dict(s0)
    s2 = o2.state_dict()
    reloaded = s2["count"] == 3 and all(
        torch.equal(s0["state"]["state"][i][k], s2["state"]["state"][i][k])
        for i in s0["state"]["state"] for k in moments)
    flat = torch.cat([p.detach().reshape(-1) for p in m1.parameters()])
    others = MH.all_gather_object(flat.numpy())
    out[f"zero1_{optim}"] = {
        "params_equal": same, "state_equal": same_state,
        "reloaded": reloaded, "own_moments": own, "total": total,
        "ranks_equal": bool(np.array_equal(others[0], others[1]))}

keep = dropout(torch.ones(64, 64), 0.1, DropoutRng(step_seed(0, 5, rank),
                                                   "cpu")) > 0
np.save(f"{tmp}/keep_{rank}.npy", keep.numpy())
json.dump(out, open(f"{tmp}/out_{rank}.json", "w"))
MH.shutdown()
print("steps ok", rank)
'''


def _batch(ds, rng, n):
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    ex = [ds.get_example(i, rng) for i in range(len(ds))][:n]
    return ds.collate(ex, collate.BucketSpec(LT, NB, n,
                                             type(ds).slot_budget(LT, NB)))


def _global_batches(corpus):
    """Each case's global batch (B rows; the stacked case two micro-batches
    of B rows on a leading axis)."""
    txt, img = corpus
    mlm = datasets.MlmDataset(txt, img, 0.3)
    out = {"mlm": _batch(mlm, np.random.default_rng(1), B),
           "itm-ot": _batch(datasets.ItmDataset(txt, img, 0.5),
                            np.random.default_rng(2), B),
           "mrfr": _batch(datasets.MrfrDataset(txt, img, 0.4),
                          np.random.default_rng(3), B)}
    micro = [_batch(mlm, np.random.default_rng(s), B) for s in (4, 5)]
    out["mlm-stacked"] = {k: np.stack([m[k] for m in micro])
                          for k in micro[0]}
    for name, b in out.items():
        out[name] = {k: v for k, v in b.items()
                     if not k.startswith("_") and k != "sample_size"}
        ax = 1 if name.endswith("stacked") else 0
        assert all(v.shape[ax] == B for v in out[name].values()), name
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The two processes' results and the inputs they were given."""
    tmp = tmp_path_factory.mktemp("dist")
    corpus = synth_pretrain_corpus(3, **CORPUS)
    batches = _global_batches(corpus)
    for name, b in batches.items():
        np.savez(tmp / f"batch_{name}.npz", **b)
    sd = UC2ForPretraining(UC2Config(**TINY), device="cpu",
                           seed=0).state_dict()
    torch.save(sd, tmp / "init.pt")
    (tmp / "meta.json").write_text(json.dumps(
        {"cfg": TINY, "tasks": {k: list(v) for k, v in TASKS.items()}}))
    spawn(STEPS, [STORE, tmp], 2, tmp)
    out = [json.loads((tmp / f"out_{r}.json").read_text()) for r in (0, 1)]
    return {"tmp": tmp, "batches": batches, "sd": sd, "out": out}


@pytest.mark.parametrize("name", list(TASKS))
def test_two_process_gradients_match_the_reference_on_the_whole_batch(
        two, name):
    """Each process's loss is its sum over the global count: the summed
    gradients and metrics are the reference's on the concatenated batch."""
    task, kw = TASKS[name]
    params = jax.tree_util.tree_map(np.asarray, params_to_jax(two["sd"]))
    jm = JaxPretraining(JaxConfig(**TINY))
    loss_fn = jax_step.make_loss_fn(jm, task, **kw)
    batch = {k: jax.numpy.asarray(v) for k, v in two["batches"][name].items()}
    rng = jax.random.PRNGKey(0) if name.endswith("stacked") else None
    grads, metrics = jax.jit(lambda p, b: jax_step.accumulated_grads(
        loss_fn, p, b, rng))(params, batch)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for r in (0, 1):
        got = np.load(two["tmp"] / f"grads_{name}_{r}.npz")
        assert set(got.files) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k,
                                       **TOL)
        m = two["out"][r][name]
        for k in ("loss", "n_units") + (("xe", "ot") if task == "itm-ot"
                                        else ()):
            np.testing.assert_allclose(m[k], float(metrics[k]), err_msg=k,
                                       **TOL)
    assert two["out"][0][name] == two["out"][1][name]


@pytest.mark.parametrize("optim", ["adamw", "adamax"])
def test_zero1_equals_the_replicated_run_bit_for_bit(two, optim):
    for r in (0, 1):
        z = two["out"][r][f"zero1_{optim}"]
        assert z["params_equal"] and z["state_equal"] and z["reloaded"]
        assert z["ranks_equal"]
        assert 0.45 < z["own_moments"] / z["total"] < 0.55, z


def test_the_processes_draw_different_dropout_masks(two):
    k0, k1 = (np.load(two["tmp"] / f"keep_{r}.npy") for r in (0, 1))
    one = (dropout(torch.ones(64, 64), 0.1,
                   DropoutRng(step_seed(0, 5), "cpu")) > 0).numpy()
    assert np.array_equal(k0, one) and not np.array_equal(k0, k1)
    assert 0.85 < k1.mean() < 0.95
