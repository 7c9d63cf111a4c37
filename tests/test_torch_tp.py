"""Tensor parallelism (``--n_model``, ``uc2_torch/parallel/tensor.py``) on
the CPU over gloo, at the tiny config of tests/test_tp_equivalence.py
(h = 64, 4 heads, 2 layers, FFN 128, fp32) with a vocabulary of 511,
which two processes do not divide:

* shard and gather are exact for every parameter, and the port shards
  exactly the parameters the reference's ``_RULES`` shard;
* the partial modes of #2 and #3 summed over the shards, with the
  epilogue, are the whole blocks' plain versions;
* the Philox mask of a shard of the heads (``h0``, ``n_tot``) is the mask
  of those heads of the whole launch, bit for bit, in the training
  attention and in the eager dropout;
* two processes at ``n_model 2``: one mlm (with and without the chunked
  CE), itm and vmlm-soft step each
  (losses and the gathered updated parameters) against ``uc2_tpu``'s
  ``make_train_step`` on the same batch and parameters at dropout 0, at
  1e-4; the mlm step at dropout 0.1 against the port's one-process step
  at 1e-5, the first layer's attention masks the same bit for bit, and
  under remat bit for bit the step without it;
* the kernel routes at ``n_model 2``: scores under "fused-force" with
  ``UC2_ATTN_V2=1`` (#7's partial mode in every layer) against the
  reference's under the same; one "pallas-train" mlm step with
  ``UC2_FFN_TRAIN=1`` (#9/#10's partial modes) against the reference's
  ``make_train_step`` with its Pallas FFN kernel, at 1e-4; int8 scores
  against the reference's int8 scores at 1e-4 and bit for bit the port's
  one-process int8 scores, every process of the group missing the weight
  cache at the same calls;
* four processes as 2 x 2 with ZeRO-1: the gathered gradients against the
  reference's on the whole batch at 1e-4, and the replicated parameters
  bit for bit across each model group after two steps; the retrieval
  eval's score matrix, striped over the two replicas and gathered from
  one process of each model group, one process's matrix within 1e-5;
* a world that ``--n_model`` does not divide raises by name.

Spawned processes import nothing of JAX."""

import json

import numpy as np
import pytest
import torch
import jax

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.parallel.mesh import param_pspec
from uc2_tpu.training import optim as jax_optim
from uc2_tpu.training import step as jax_step
from uc2_torch.config import UC2Config
from uc2_torch.data import collate, datasets, labels
from uc2_torch.data.db import DetectFeatDb, TxtTokDb
from uc2_torch.data.memdb import synth_pretrain_corpus
from uc2_torch.data.synth import synth_corpus
from uc2_torch.evalu.retrieval import score_matrix
from uc2_torch.models import convert
from uc2_torch.models.finetune import UC2ForImageTextRetrieval, UC2ForNlvr2
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_torch.ops import fused_block as fb
from uc2_torch.ops.attention import xla_attention
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.ops.flash_attention import flash_attention_train_plain
from uc2_torch.ops.philox import dropout_bits, keep_mask
from uc2_torch.parallel import mesh as M
from uc2_torch.parallel import tensor as TP
from uc2_torch.training import optim
from uc2_torch.training.step import train_step
from tests.torch_dist_util import STORE, spawn

VOCAB = 511
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, img_dim=32, img_label_dim=11,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, use_pallas_attention=False)
CORPUS = dict(n_imgs=8, txt_per_img=2, vocab=VOCAB, img_dim=32, min_bb=3,
              max_bb=8, max_words=4, n_classes=11)
WORDS = {lang: [f"{lang}{i}" for i in range(10)] for lang in ("en", "de")}
LT, NB, B = 24, 8, 8
# the scored batches of the kernel routes: joint L = 17 and 128
SCORE_LENGTHS = ((10, 7), (62, 66))
TOL = dict(rtol=1e-4, atol=1e-4)
# case -> (task, LM-head CE chunks): the chunked CE streams each process's
# vocabulary shard
TASKS = {"mlm": ("mlm", 0), "itm": ("itm", 0), "vmlm-soft": ("vmlm-soft", 0),
         "mlm-chunked": ("mlm", 3)}
LR, CLIP = 1e-3, 5.0


def _tok(word):
    return labels.hash_tokenize(word, vocab_size=VOCAB)


# ------------------------------------------------------------ shards
def _ref_path(key, value):
    """The reference parameter path of the port's ``key``."""
    tree = convert.params_to_jax({key: value})
    path = []
    while isinstance(tree, dict):
        (k, tree), = tree.items()
        path.append(k)
    return "/".join(path)


@pytest.mark.parametrize("model", ["pretraining", "retrieval", "nlvr2"])
def test_the_port_shards_what_the_reference_rules_shard(model):
    cfg = UC2Config(**TINY)
    m = {"pretraining": lambda: UC2ForPretraining(cfg, device="cpu"),
         "retrieval": lambda: UC2ForImageTextRetrieval(cfg, device="cpu"),
         "nlvr2": lambda: UC2ForNlvr2(cfg, fmt="paired-attn",
                                      device="cpu")}[model]()
    sd = m.state_dict()
    sharded = {k for k in sd if convert.tp_kind(k)}
    want = {k for k, v in sd.items()
            if "model" in tuple(param_pspec(_ref_path(k, v)))}
    assert sharded == want and sharded
    n = cfg.num_hidden_layers
    assert len(sharded) == 6 * n + (2 if model == "pretraining" else 1)
    for T in (2, 4):
        shards = [convert.shard_state_dict(sd, r, T) for r in range(T)]
        whole = convert.gather_state_dict(shards)
        assert list(whole) == list(sd)
        assert all(torch.equal(whole[k], sd[k]) for k in sd)
        for k in sharded:
            assert sum(s[k].numel() for s in shards) == sd[k].numel(), k
        # a process's QKV rows are [q | k | v] of its heads
        qkv = "roberta.layer.0.attention.qkv.weight"
        d = cfg.head_dim
        n_l = cfg.num_attention_heads // T
        rows = shards[1][qkv].reshape(3, n_l * d, -1)
        full = sd[qkv].reshape(3, cfg.num_attention_heads * d, -1)
        assert torch.equal(rows, full[:, n_l * d:2 * n_l * d])
    if model == "pretraining":
        V = shards[0]["cls.bias"].shape[0]
        assert V == -(-VOCAB // 4)
        assert [s["roberta.embeddings.word_embeddings.weight"].shape[0]
                for s in shards] == [128, 128, 128, 127]


def test_shard_module_cuts_in_place_and_loads_whole_states():
    cfg = UC2Config(**TINY)
    m = UC2ForPretraining(cfg, device="cpu", seed=0)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    TP.shard_module(m, 1, 2)
    got = m.state_dict()
    assert all(torch.equal(got[k], v) for k, v in
               convert.shard_state_dict(sd, 1, 2).items())
    assert {n for n, p in m.named_parameters() if TP.is_sharded(p)} == {
        k for k in sd if convert.tp_kind(k)}
    with pytest.raises(ValueError, match="must divide the attention heads"):
        TP.shard_module(UC2ForPretraining(cfg, device="cpu"), 0, 3)


# ------------------------------------------------------- partial modes
def _block_inputs(seed, b=3, L=37, n=4, d=16, F=128):
    g = torch.Generator().manual_seed(seed)
    H = n * d
    r = lambda *s: torch.randn(*s, generator=g)
    qkv = r(b, L, 3 * H)
    q, k, v = (t.view(b, L, n, d) for t in qkv.split(H, dim=-1))
    mask = (torch.arange(L)[None] < torch.tensor([L, L - 5, 9])[:b, None])
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    return dict(q=q, k=k, v=v, bias=bias, x=r(b, L, H), wo=r(H, H) * 0.1,
                bo=r(H) * 0.1, gamma=r(H) * 0.1 + 1, beta=r(H) * 0.1,
                w1=r(F, H) * 0.1, b1=r(F) * 0.1, w2=r(H, F) * 0.1,
                b2=r(H) * 0.1)


@pytest.mark.parametrize("T", [2, 4])
def test_partial_blocks_summed_are_the_whole_blocks(T):
    a = _block_inputs(T)
    n, d = a["q"].shape[2:]
    nl, Fl = n // T, a["w1"].shape[0] // T
    parts = [fb.fused_attn_block_partial(
        a["q"][:, :, m * nl:(m + 1) * nl], a["k"][:, :, m * nl:(m + 1) * nl],
        a["v"][:, :, m * nl:(m + 1) * nl], a["bias"],
        a["wo"][:, m * nl * d:(m + 1) * nl * d]) for m in range(T)]
    got = fb.block_epilogue(sum(parts), a["bo"], a["x"], a["gamma"],
                            a["beta"])
    want = fb.fused_attn_block_plain(a["q"], a["k"], a["v"], a["bias"],
                                     a["x"], a["wo"], a["bo"], a["gamma"],
                                     a["beta"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    parts = [fb.fused_ffn_block_partial(
        a["x"], a["w1"][m * Fl:(m + 1) * Fl], a["b1"][m * Fl:(m + 1) * Fl],
        a["w2"][:, m * Fl:(m + 1) * Fl]) for m in range(T)]
    got = fb.block_epilogue(sum(parts), a["b2"], a["x"], a["gamma"],
                            a["beta"])
    want = fb.fused_ffn_block_plain(a["x"], a["w1"], a["b1"], a["w2"],
                                    a["b2"], a["gamma"], a["beta"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- masks by head
@pytest.mark.parametrize("T", [2, 4])
def test_a_shard_of_the_heads_draws_the_whole_launchs_masks(T):
    b, n, L, seed = 3, 12, 70, 1234
    n_l = n // T
    bits = dropout_bits(seed, b, n, L, L)
    keep = keep_mask(seed, 0.1, b, n, L, L)
    a = _block_inputs(5, b=b, L=L, n=n, d=8)
    whole = flash_attention_train_plain(a["q"], a["k"], a["v"], a["bias"],
                                        seed, 0.1)
    for m in range(T):
        sl = slice(m * n_l, (m + 1) * n_l)
        assert torch.equal(dropout_bits(seed, b, n_l, L, L, h0=m * n_l,
                                        n_tot=n), bits[:, sl])
        assert torch.equal(keep_mask(seed, 0.1, b, n_l, L, L, h0=m * n_l,
                                     n_tot=n), keep[:, sl])
        got = flash_attention_train_plain(
            a["q"][:, :, sl], a["k"][:, :, sl], a["v"][:, :, sl], a["bias"],
            seed, 0.1, m * n_l, n)
        torch.testing.assert_close(got, whole[:, :, sl], rtol=1e-6,
                                   atol=1e-6)
        # the eager dropout draws the whole layer's mask and keeps the slice
        eager = xla_attention(a["q"][:, :, sl], a["k"][:, :, sl],
                              a["v"][:, :, sl], a["bias"], 0.1,
                              DropoutRng(7, "cpu"), heads=(m * n_l, n))
        full = xla_attention(a["q"], a["k"], a["v"], a["bias"], 0.1,
                             DropoutRng(7, "cpu"))
        torch.testing.assert_close(eager, full[:, :, sl], rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="are not among"):
        keep_mask(seed, 0.1, b, n_l, L, L, h0=n, n_tot=n)


# ------------------------------------------------------ spawned steps
WORKER = r'''
import json, sys, hashlib
import numpy as np, torch
rank, addr, tmp, world, n_model = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], int(sys.argv[4]),
                                   int(sys.argv[5]))
from uc2_torch.config import UC2Config
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import flash_attention as fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.parallel import mesh as M, multihost as MH, tensor as TP
from uc2_torch.training import optim as O, step as S
assert MH.maybe_initialize(addr, world, rank, device="cpu")
M.init_grid(n_model)
assert (M.model_count(), M.data_count()) == (n_model, world // n_model)
meta = json.load(open(f"{tmp}/meta.json"))
sd = torch.load(f"{tmp}/init.pt", weights_only=True)
d, dn = M.data_index(), M.data_count()

def local(task):
    z = np.load(f"{tmp}/batch_{task}.npz")
    h = z["input_ids"].shape[0] // dn
    return {k: torch.from_numpy(np.ascontiguousarray(z[k][d * h:(d + 1) * h]))
            for k in z.files}

def model(chunks=0, **kw):
    m = UC2ForPretraining(UC2Config(**dict(meta["cfg"], **kw)),
                          lm_ce_chunks=chunks, device="cpu", seed=rank + 5)
    m.load_state_dict(sd)
    return TP.place_model(m)

def optimizer(m, zero1=False):
    return O.build_optimizer(m, O.constant(meta["lr"]), grad_norm=meta["clip"],
                             zero1=zero1)

def whole(m):
    return {k: v.numpy() for k, v in TP.full_state_dict(m).items()}

out = {}
if world == 2:
    for case, (task, chunks) in meta["tasks"].items():
        m = model(chunks)
        opt = optimizer(m)
        met = S.train_step(m, opt, local(task), None, task=task,
                           valid_ids=meta["valid_ids"])
        out[case] = {k: float(v) for k, v in met.items()}
        params = whole(m)
        if rank == 0:
            np.savez(f"{tmp}/params_{case}.npz", **params)
    # dropout 0.1 under the training kernels' plain versions: record the
    # first layer's attention keep mask
    masks = []
    keep0 = fa.keep_mask
    def keep(*a, **k):
        got = keep0(*a, **k)
        masks.append(got)
        return got
    fa.keep_mask = keep
    m = model(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
              use_pallas_attention="pallas-train")
    opt = optimizer(m)
    met = S.train_step(m, opt, local("mlm"), DropoutRng(7, "cpu"),
                       task="mlm")
    out["drop"] = {k: float(v) for k, v in met.items()}
    np.save(f"{tmp}/mask_{rank}.npy", masks[0].numpy())
    params = whole(m)
    if rank == 0:
        np.savez(f"{tmp}/params_drop.npz", **params)
    # the same step under remat: the recompute runs the layer's
    # collectives again, in the same order on both processes
    m = model(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
              use_pallas_attention="pallas-train", remat="full")
    again = S.train_step(m, optimizer(m), local("mlm"), DropoutRng(7, "cpu"),
                         task="mlm")
    out["remat_bitwise"] = (float(again["loss"]) == out["drop"]["loss"]
                            and all(np.array_equal(v, params[k])
                                    for k, v in whole(m).items()))
    # the kernel routes (their plain versions here), each call counted
    import os
    from uc2_torch.models import encoder as E
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    from uc2_torch.ops import int8
    calls = {}
    def counted(name):
        fn = getattr(E, name)
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        setattr(E, name, call)
    for name in ("fused_attn_block_v2_partial", "fused_attn_block_partial",
                 "fused_ffn_block_partial", "fused_ffn_block_train_partial",
                 "int8_linear_row_parallel"):
        counted(name)
    rsd = torch.load(f"{tmp}/retrieval.pt", weights_only=True)
    def retrieval(**kw):
        r = UC2ForImageTextRetrieval(UC2Config(**dict(meta["cfg"], **kw)),
                                     device="cpu")
        r.load_state_dict(rsd)
        return TP.place_model(r)
    sb = torch.load(f"{tmp}/score_batches.pt", weights_only=True)
    os.environ["UC2_ATTN_V2"] = "1"
    with torch.no_grad():
        v2 = [retrieval(use_pallas_attention="fused-force").scores(b).numpy()
              for b in sb]
    del os.environ["UC2_ATTN_V2"]
    out["v2_calls"], calls = calls, {}
    r8 = retrieval(quant="int8")
    misses = []
    with torch.no_grad():
        for again in range(3):
            if again == 2:     # an update: every weight quantizes again
                for p in r8.parameters():
                    p.mul_(1.0)
            n0 = int8.weight_codes.misses
            q8 = [r8.scores(b).numpy() for b in sb]
            misses.append(int8.weight_codes.misses - n0)
    out["int8_calls"], calls = calls, {}
    out["int8_misses"] = misses
    np.savez(f"{tmp}/routes_{rank}.npz", **{f"v2_{i}": s for i, s in
                                            enumerate(v2)},
             **{f"q8_{i}": s for i, s in enumerate(q8)})
    os.environ["UC2_FFN_TRAIN"] = "1"
    m = model(use_pallas_attention="pallas-train")
    met = S.train_step(m, optimizer(m), local("mlm"), DropoutRng(7, "cpu"),
                       task="mlm")
    del os.environ["UC2_FFN_TRAIN"]
    out["ffn_train"] = {k: float(v) for k, v in met.items()}
    out["ffn_train_calls"] = calls
    params = whole(m)
    if rank == 0:
        np.savez(f"{tmp}/params_ffn_train.npz", **params)
else:
    m = model()
    met = S.accumulate_grads(S.make_loss_fn("mlm"), m, local("mlm"), None)
    M.reduce_grads(list(m.parameters()), met)
    grads = {n: (TP.gather_param(p.grad, p.tp_kind) if TP.is_sharded(p)
                 else p.grad).numpy() for n, p in m.named_parameters()}
    if rank == 0:
        np.savez(f"{tmp}/grads_grid.npz", **grads)
    m = model()
    opt = optimizer(m, zero1=True)
    own = sum(st["exp_avg"].numel() for st in opt.opt.state.values())
    for task in ("mlm", "itm"):
        S.train_step(m, opt, local(task), None, task=task)
    rep = hashlib.sha1()
    for n, p in m.named_parameters():
        if not TP.is_sharded(p):
            rep.update(p.detach().numpy().tobytes())
    shard = hashlib.sha1(m.roberta.layer[0].attention.qkv.weight.detach()
                         .numpy().tobytes()).hexdigest()
    out["grid"] = {"replicated": rep.hexdigest(), "qkv": shard,
                   "parts": len(opt.parts), "place": [d, M.model_index()]}
    from uc2_torch.data.db import DetectFeatDb, TxtTokDb
    from uc2_torch.evalu.retrieval import full_retrieval_eval
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    rm = UC2ForImageTextRetrieval(UC2Config(**meta["cfg"]), device="cpu")
    rm.load_state_dict(torch.load(f"{tmp}/retrieval.pt", weights_only=True))
    TP.place_model(rm)
    log, (mat, t_ids, i_ids) = full_retrieval_eval(
        rm, TxtTokDb(meta["txt_db"], max_txt_len=18),
        DetectFeatDb(meta["img_db"], 0.2, 8, 3, 8), 20, 8, batch_size=4,
        return_matrix=True, device="cpu")
    np.save(f"{tmp}/matrix_{rank}.npy", mat)
    out["grid"]["eval"] = [log, t_ids, i_ids]
json.dump(out, open(f"{tmp}/out_{world}_{rank}.json", "w"))
MH.shutdown()
print("tp ok", rank)
'''


def _batch(ds, seed):
    rng = np.random.default_rng(seed)
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    ex = [ds.get_example(i, rng) for i in range(len(ds))][:B]
    b = ds.collate(ex, collate.BucketSpec(LT, NB, B,
                                          type(ds).slot_budget(LT, NB)))
    return {k: v for k, v in b.items()
            if not k.startswith("_") and k != "sample_size"}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The spawned runs: two processes at n_model 2, four at 2 x 2."""
    tmp = tmp_path_factory.mktemp("tp")
    txt, img = synth_pretrain_corpus(3, **CORPUS)
    vocab = labels.LabelVocab(tokenize=_tok, words=WORDS)
    batches = {"mlm": _batch(datasets.MlmDataset(txt, img, 0.3), 1),
               "itm": _batch(datasets.ItmDataset(txt, img, 0.5), 2),
               "vmlm-soft": _batch(datasets.VmlmSoftDataset(
                   txt, img, 0.4, vocab), 3)}
    for name, b in batches.items():
        np.savez(tmp / f"batch_{name}.npz", **b)
    sd = UC2ForPretraining(UC2Config(**TINY), device="cpu",
                           seed=0).state_dict()
    # away from the initialisation, so that every gradient is alive
    g = torch.Generator().manual_seed(1)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in sd.items()}
    torch.save(sd, tmp / "init.pt")
    valid_ids = [int(i) for i in vocab.valid_ids]
    stores = synth_corpus(str(tmp / "stores"), n_imgs=6, txt_per_img=2,
                          vocab=VOCAB, img_dim=32, n_classes=11, min_bb=3,
                          max_bb=8, seed=4, max_words=5)
    retrieval = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu",
                                         seed=2).state_dict()
    torch.save(retrieval, tmp / "retrieval.pt")
    score_batches = [_score_batch(Lt, Nb) for Lt, Nb in SCORE_LENGTHS]
    torch.save([{k: torch.from_numpy(v) for k, v in b.items()}
                for b in score_batches], tmp / "score_batches.pt")
    (tmp / "meta.json").write_text(json.dumps(
        {"cfg": TINY, "tasks": TASKS, "valid_ids": valid_ids,
         "lr": LR, "clip": CLIP, **stores}))
    spawn(WORKER, [STORE, tmp, 2, 2], 2, tmp)
    spawn(WORKER, [STORE, tmp, 4, 2], 4, tmp)
    out = {(w, r): json.loads((tmp / f"out_{w}_{r}.json").read_text())
           for w, rs in ((2, range(2)), (4, range(4))) for r in rs}
    return {"tmp": tmp, "batches": batches, "sd": sd, "out": out,
            "valid_ids": np.asarray(valid_ids), "stores": stores,
            "retrieval": retrieval, "score_batches": score_batches}


def _score_batch(Lt, Nb, b=3, seed=1):
    """A scored batch with padded text and regions
    (tests/test_torch_int8.py's)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, (b, Lt))
    ids[:, 0] = 0
    ids[0, Lt - 3:] = 1
    mask = np.ones((b, Lt + Nb), np.int64)
    mask[0, Lt - 3:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0
    return {"input_ids": ids,
            "img_feat": rng.standard_normal((b, Nb, TINY["img_dim"])).astype(
                np.float32),
            "img_pos_feat": rng.random((b, Nb, 7)).astype(np.float32),
            "attn_mask": mask}


def _jax_batch(b):
    return {k: jax.numpy.asarray(v, jax.numpy.int32 if v.dtype == np.int64
                                 else None) for k, v in b.items()}


@pytest.mark.parametrize("case", list(TASKS))
def test_two_processes_step_as_the_reference(tp, case):
    """One AdamW step at n_model 2 (one replica: both processes read the
    whole batch) against the reference's ``make_train_step`` on the same
    batch and parameters: the loss, the global norm and every updated
    parameter, gathered whole, at 1e-4."""
    task, chunks = TASKS[case]
    params = jax.tree_util.tree_map(np.asarray,
                                    convert.params_to_jax(tp["sd"]))
    jm = JaxPretraining(JaxConfig(**TINY), lm_ce_chunks=chunks)
    tx = jax_optim.build_optimizer(params, jax_optim.constant(LR),
                                   grad_norm=CLIP)
    step = jax.jit(jax_step.make_train_step(
        jm, task, tx, valid_ids=tp["valid_ids"] if "soft" in task else None,
        donate=False))
    state, metrics = step(jax_step.create_train_state(params, tx),
                          _jax_batch(tp["batches"][task]),
                          jax.random.PRNGKey(0))
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          state.params))
    got = np.load(tp["tmp"] / f"params_{case}.npz")
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL)
    for r in (0, 1):
        m = tp["out"][(2, r)][case]
        np.testing.assert_allclose(m["loss"], float(metrics["loss"]), **TOL)
        np.testing.assert_allclose(m["grad_norm"],
                                   float(metrics["grad_norm"]), **TOL)
    assert tp["out"][(2, 0)][case] == tp["out"][(2, 1)][case]


def test_dropout_draws_the_one_process_masks(tp):
    """At dropout 0.1 under "pallas-train" the two processes' step is the
    one-process step within 1e-5: each shard's first attention mask is
    the one-process mask of its heads, bit for bit, and the hidden
    dropout draws the same elements (same seeds, same shapes)."""
    cfg = UC2Config(**dict(TINY, hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1,
                           use_pallas_attention="pallas-train"))
    m = UC2ForPretraining(cfg, device="cpu", seed=0)
    m.load_state_dict(tp["sd"])
    from uc2_torch.ops import flash_attention as fa
    masks = []
    keep0 = fa.keep_mask
    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "keep_mask",
               lambda *a, **k: masks.append(keep0(*a, **k)) or masks[-1])
    try:
        opt = optim.build_optimizer(m, optim.constant(LR), grad_norm=CLIP)
        met = train_step(m, opt, {k: torch.from_numpy(v) for k, v in
                                  tp["batches"]["mlm"].items()},
                         DropoutRng(7, "cpu"), task="mlm")
    finally:
        mp.undo()
    n_l = TINY["num_attention_heads"] // 2
    for r in (0, 1):
        got = np.load(tp["tmp"] / f"mask_{r}.npy")
        assert np.array_equal(got, masks[0][:, r * n_l:(r + 1) * n_l])
        np.testing.assert_allclose(tp["out"][(2, r)]["drop"]["loss"],
                                   float(met["loss"]), rtol=1e-5, atol=1e-5)
    got = np.load(tp["tmp"] / "params_drop.npz")
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # remat="full" recomputes each layer, its collectives included: the
    # step is the step without it, bit for bit
    assert tp["out"][(2, 0)]["remat_bitwise"]
    assert tp["out"][(2, 1)]["remat_bitwise"]


def test_a_two_by_two_grid_with_zero1(tp):
    """Four processes as 2 replicas x 2 shards: the gradients, summed over
    the replicas and gathered over the shards, are the reference's on the
    whole batch; after two ZeRO-1 steps the replicated parameters are the
    same bits on both processes of each model group, and each shard on
    both replicas."""
    params = jax.tree_util.tree_map(np.asarray,
                                    convert.params_to_jax(tp["sd"]))
    jm = JaxPretraining(JaxConfig(**TINY))
    loss_fn = jax_step.make_loss_fn(jm, "mlm")
    grads, _ = jax.jit(lambda p, b: jax_step.accumulated_grads(
        loss_fn, p, b, None))(params, _jax_batch(tp["batches"]["mlm"]))
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = np.load(tp["tmp"] / "grads_grid.npz")
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL)
    g = {r: tp["out"][(4, r)]["grid"] for r in range(4)}
    assert [g[r]["place"] for r in range(4)] == [[0, 0], [0, 1], [1, 0],
                                                  [1, 1]]
    assert g[0]["replicated"] == g[1]["replicated"]
    assert g[2]["replicated"] == g[3]["replicated"]
    assert g[0]["qkv"] == g[2]["qkv"] and g[1]["qkv"] == g[3]["qkv"]
    assert g[0]["qkv"] != g[1]["qkv"]
    assert all(g[r]["parts"] > 0 for r in range(4))
    # the score matrix of the two replicas' stripes, on every process
    log, t_ids, i_ids = g[0]["eval"]
    m = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu")
    m.load_state_dict(tp["retrieval"])
    one = score_matrix(m, TxtTokDb(tp["stores"]["txt_db"], max_txt_len=18),
                       DetectFeatDb(tp["stores"]["img_db"], 0.2, 8, 3, 8),
                       t_ids, i_ids, 20, 8, batch_size=4, device="cpu")
    for r in range(4):
        assert g[r]["eval"] == g[0]["eval"]
        got = np.load(tp["tmp"] / f"matrix_{r}.npy")
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
    assert len(t_ids) == 12 and set(log) >= {"img_r1", "txt_r1"}


# ------------------------------------------------------- kernel routes
def _reference_scores(tp, monkeypatch, env=None, **kw):
    """The reference's scores of the scored batches under ``kw``, each one
    ``jax.jit`` program (its Pallas kernels in interpret mode)."""
    if env:
        monkeypatch.setenv(env, "1")
    params = jax.tree_util.tree_map(np.asarray,
                                    convert.params_to_jax(tp["retrieval"]))
    jm = JaxRetrieval(JaxConfig(**dict(TINY, **kw)))
    return [np.asarray(jax.jit(jm.scores)(params, _jax_batch(b)))
            for b in tp["score_batches"]]


def test_attn_v2_scores_under_tensor_parallelism(tp, monkeypatch):
    """"fused-force" with ``UC2_ATTN_V2=1`` at n_model 2: #7's partial
    mode and #3's in every layer of both processes (no #2), the scores
    the reference's under the same routing at 1e-4."""
    want = _reference_scores(tp, monkeypatch, "UC2_ATTN_V2",
                             use_pallas_attention="fused-force")
    n = len(SCORE_LENGTHS) * TINY["num_hidden_layers"]
    for r in (0, 1):
        assert tp["out"][(2, r)]["v2_calls"] == {
            "fused_attn_block_v2_partial": n, "fused_ffn_block_partial": n}
        got = np.load(tp["tmp"] / f"routes_{r}.npz")
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"v2_{i}"], w, **TOL)


def test_int8_scores_under_tensor_parallelism(tp, monkeypatch):
    """``quant="int8"`` at n_model 2: the row-parallel products take the
    maxima over the model group and sum the int32 sums exactly, so the
    scores are the port's one-process int8 scores bit for bit and the
    reference's at 1e-4; both processes miss the weight cache at the
    same calls (every weight at the first batches and after an update,
    none in between)."""
    want = _reference_scores(tp, monkeypatch, quant="int8")
    one = UC2ForImageTextRetrieval(UC2Config(**dict(TINY, quant="int8")),
                                   device="cpu")
    one.load_state_dict(tp["retrieval"])
    n_w = 4 * TINY["num_hidden_layers"]
    for r in (0, 1):
        o = tp["out"][(2, r)]
        assert o["int8_misses"] == [n_w, 0, n_w]
        assert o["int8_calls"] == {"int8_linear_row_parallel": 3 * n_w}
        got = np.load(tp["tmp"] / f"routes_{r}.npz")
        for i, (w, b) in enumerate(zip(want, tp["score_batches"])):
            with torch.no_grad():
                mine = one.scores({k: torch.from_numpy(v)
                                   for k, v in b.items()}).numpy()
            assert np.array_equal(got[f"q8_{i}"], mine)
            np.testing.assert_allclose(got[f"q8_{i}"], w, **TOL)


def test_ffn_train_step_under_tensor_parallelism(tp, monkeypatch):
    """One mlm step under "pallas-train" with ``UC2_FFN_TRAIN=1`` at
    n_model 2 and dropout 0 (#9/#10's partial modes in every layer)
    against the reference's ``make_train_step`` under the same (its
    training attention and FFN kernels in interpret mode): the loss, the
    global norm and every updated parameter at 1e-4."""
    monkeypatch.setenv("UC2_FFN_TRAIN", "1")
    params = jax.tree_util.tree_map(np.asarray,
                                    convert.params_to_jax(tp["sd"]))
    jm = JaxPretraining(JaxConfig(**dict(
        TINY, use_pallas_attention="pallas-train")))
    tx = jax_optim.build_optimizer(params, jax_optim.constant(LR),
                                   grad_norm=CLIP)
    step = jax.jit(jax_step.make_train_step(jm, "mlm", tx, donate=False))
    state, metrics = step(jax_step.create_train_state(params, tx),
                          _jax_batch(tp["batches"]["mlm"]),
                          jax.random.PRNGKey(0))
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          state.params))
    got = np.load(tp["tmp"] / "params_ffn_train.npz")
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL)
    for r in (0, 1):
        o = tp["out"][(2, r)]
        assert o["ffn_train_calls"] == {
            "fused_ffn_block_train_partial": TINY["num_hidden_layers"]}
        np.testing.assert_allclose(o["ffn_train"]["loss"],
                                   float(metrics["loss"]), **TOL)
        np.testing.assert_allclose(o["ffn_train"]["grad_norm"],
                                   float(metrics["grad_norm"]), **TOL)
    assert tp["out"][(2, 0)]["ffn_train"] == tp["out"][(2, 1)]["ffn_train"]


def test_a_world_that_n_model_does_not_divide_raises():
    """Without a process group (a world of one) ``--n_model 2`` raises by
    name, and the grid stays at one process a model."""
    with pytest.raises(ValueError, match="--n_model 2 does not divide"):
        M.init_grid(2)
    assert M.model_count() == 1
