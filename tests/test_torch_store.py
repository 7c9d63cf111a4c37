"""The port's U2S stores and databases (uc2_torch/data/store.py, db.py,
synth.py) against the reference package on the CPU: the msgpack codec
against ``msgpack`` itself, byte-identical corpora from one seed, every
record read by the native and the pure-Python readers, and the databases,
the task datasets, the loaders and the retrieval evaluation over them, bit
for bit."""

import filecmp
import json
import os
import shutil

import msgpack
import numpy as np
import pytest
import jax

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import datasets as jax_datasets
from uc2_tpu.data import db as jax_db
from uc2_tpu.data import labels as jax_labels
from uc2_tpu.data import loader as jax_loader
from uc2_tpu.data import store as jax_store
from uc2_tpu.data.collate import default_buckets as jax_buckets
from uc2_tpu.data.synth import synth_corpus as jax_synth
from uc2_tpu.evalu import retrieval as jax_retrieval
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_torch.config import UC2Config
from uc2_torch.data import datasets, db, labels, loader, native_build, store
from uc2_torch.data.collate import default_buckets
from uc2_torch.data.synth import synth_corpus
from uc2_torch.evalu import retrieval
from uc2_torch.models.finetune import UC2ForImageTextRetrieval

VOCAB = 1000
CORPUS = dict(n_imgs=10, txt_per_img=2, vocab=VOCAB, img_dim=16,
              n_classes=11, min_bb=4, max_bb=40, max_words=6, seed=11)


@pytest.fixture(scope="module")
def ref_corpus(tmp_path_factory):
    """An unpaired and a paired corpus with soft labels, written by the
    reference's synth_corpus."""
    root = tmp_path_factory.mktemp("ref_corpus")
    return {paired: jax_synth(str(root / f"p{int(paired)}"), paired=paired,
                              soft_label_dim=9, **CORPUS)
            for paired in (False, True)}


def _records(path):
    """(key, raw msgpack bytes) of every record, by the reference reader."""
    r = jax_store.StoreReader(path)
    return [(k, r.get_raw(k)) for k in r.keys()]


def _store_files(corpus):
    return [os.path.join(corpus["img_db"], "feat.u2s"),
            os.path.join(corpus["txt_db"], "txt.u2s"),
            os.path.join(corpus["soft_label_db"], "soft_labels.u2s")]


def _same(a, b):
    """Decoded values equal in type and content (arrays bit for bit)."""
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(b, dict):
        return (type(a) is dict and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in b))
    if isinstance(b, list):
        return (type(a) is list and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


# ------------------------------------------------------------------ codec
EDGE_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, 1e300, "", "a" * 31,
    "a" * 32, "é" * 200, "x" * 70000, b"", b"x" * 255, b"y" * 256,
    b"z" * 70000, list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    (1, [2, (3,)]), {"a": {"b": [1, None]}}, np.int64(-5), np.float32(2.5),
    np.float64(0.1), np.arange(6, dtype=np.float16).reshape(2, 3),
    np.zeros((0, 4), np.int32)]


@pytest.mark.parametrize("i", range(len(EDGE_VALUES)))
def test_codec_bytes_are_msgpacks(i):
    v = EDGE_VALUES[i]
    want = msgpack.packb(v, default=jax_store._default, use_bin_type=True)
    got = store.pack_value(v)
    assert got == want
    assert _same(store.unpack_value(got), jax_store.unpack_value(want))


def test_codec_reads_float32_and_refuses_extra_bytes():
    assert store.unpack_value(msgpack.packb(1.5, use_single_float=True)) \
        == 1.5
    with pytest.raises(ValueError):
        store.unpack_value(msgpack.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        store.pack_value(object())


@pytest.mark.parametrize("paired", [False, True])
def test_codec_on_every_synth_record(ref_corpus, paired):
    """Every record synth_corpus writes: our decode equals msgpack's, and
    our encode of that value gives the stored bytes back."""
    for path in _store_files(ref_corpus[paired]):
        for key, raw in _records(path):
            want = jax_store.unpack_value(raw)
            got = store.unpack_value(raw)
            assert _same(got, want), key
            assert store.pack_value(got) == raw, key


# ----------------------------------------------------------------- corpus
@pytest.mark.parametrize("kw", [dict(paired=False), dict(paired=True),
                                dict(paired=True, soft_label_dim=7,
                                     compress=False)])
def test_synth_corpus_is_byte_identical(tmp_path, kw):
    ours = synth_corpus(str(tmp_path / "ours"), **CORPUS, **kw)
    ref = jax_synth(str(tmp_path / "ref"), **CORPUS, **kw)
    assert list(ours) == list(ref)
    for k in ref:
        names = sorted(os.listdir(ref[k]))
        assert names == sorted(os.listdir(ours[k]))
        for n in names:
            assert filecmp.cmp(os.path.join(ours[k], n),
                               os.path.join(ref[k], n), shallow=False), n


# ---------------------------------------------------------------- readers
@pytest.mark.parametrize("native", [True, False])
def test_reader_reads_every_reference_record(ref_corpus, native):
    before = dict(store.READS)
    n = 0
    for path in _store_files(ref_corpus[True]):
        ref = jax_store.StoreReader(path)
        ours = store.StoreReader(path, native=native)
        keys = ref.keys()
        assert ours.keys() == keys and len(ours) == len(ref) == len(keys)
        for k in keys:
            assert ours.get_raw(k) == ref.get_raw(k)
            assert _same(ours[k], ref[k])
        assert ours.batch_get_raw(keys) == ref.batch_get_raw(keys)
        assert all(_same(a, b) for a, b in zip(ours.batch_get(keys),
                                               ref.batch_get(keys)))
        assert ours.get_raw("missing") is None
        assert ours.get("missing", 3) == 3
        with pytest.raises(KeyError):
            ours["missing"]
        ours.close()
        n += 4 * len(keys)
    side = "native" if native else "python"
    assert store.READS[side] - before[side] == n
    other = "python" if native else "native"
    assert store.READS[other] == before[other]


def test_python_lz4_decoder_matches_the_library(tmp_path):
    """Overlapping matches, long literal and match runs, incompressible
    tails: the pure-Python block decoder against the native one."""
    rng = np.random.default_rng(0)
    values = {"zeros": np.zeros(5000, np.float32),
              "period3": np.tile(np.arange(3, dtype=np.uint8), 4000),
              "mixed": np.concatenate([rng.integers(0, 4, 3000),
                                       np.arange(700),
                                       rng.integers(0, 2 ** 31, 2000)]),
              "random": rng.standard_normal(3000).astype(np.float32)}
    path = str(tmp_path / "x.u2s")
    with store.StoreWriter(path) as w:
        for k, v in values.items():
            w.put(k, v)
    ours = store.StoreReader(path, native=False)
    for k, v in values.items():
        assert ours[k].tobytes() == v.tobytes()
        assert ours.get_raw(k) == store.StoreReader(path).get_raw(k)
    codecs = [e[3] for e in ours._index.values()]
    assert store.CODEC_LZ4 in codecs


def test_native_build_raises_and_names_the_command(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "_error", None)
    monkeypatch.setattr(native_build, "OUT", str(tmp_path / "libu2s.so"))
    monkeypatch.setattr(native_build, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "SRC", str(tmp_path / "missing.cpp"))
    open(tmp_path / "missing.cpp", "w").write("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ -O3"):
        native_build.load()
    with pytest.raises(RuntimeError, match="did not build"):
        store.StoreReader(str(tmp_path / "any.u2s"))
    monkeypatch.setattr(native_build, "_error", None)


# -------------------------------------------------------------- databases
def _img_copy(corpus, tmp_path, name):
    """A private copy of the image database (the nbb cache is a file)."""
    dst = str(tmp_path / name)
    shutil.copytree(corpus["img_db"], dst)
    return dst


@pytest.mark.parametrize("conf_th,min_bb,max_bb", [
    (0.2, 10, 100), (0.5, 4, 20), (0.0, 1, 8), (-1, 10, 100)])
def test_detect_feat_db_matches_reference(ref_corpus, tmp_path, conf_th,
                                          min_bb, max_bb):
    corpus = ref_corpus[False]
    ours = db.DetectFeatDb(_img_copy(corpus, tmp_path, "ours"), conf_th,
                           max_bb, min_bb, num_bb=12)
    ref = jax_db.DetectFeatDb(_img_copy(corpus, tmp_path, "ref"), conf_th,
                              max_bb, min_bb, num_bb=12)
    names = jax_store.StoreReader(os.path.join(corpus["img_db"],
                                               "feat.u2s")).get("__keys__")
    assert [ours.name2nbb[n] for n in names] == \
        [ref.name2nbb[n] for n in names]
    if conf_th != -1:
        cache = f"nbb_th{conf_th}_max{max_bb}_min{min_bb}.json"
        assert filecmp.cmp(os.path.join(ours.img_dir, cache),
                           os.path.join(ref.img_dir, cache), shallow=False)
        # the cache a reference run left is read back as it is
        again = db.DetectFeatDb(ref.img_dir, conf_th, max_bb, min_bb)
        assert again.name2nbb == ref.name2nbb
    for n in names:
        assert n in ours and _same(list(ours[n]), list(ref[n]))
        assert _same(ours.get_dump(n), ref.get_dump(n))
    assert "missing" not in ours
    ours.prefetch(names[:5] + names[:2])
    ref.prefetch(names[:5])
    assert list(ours._cache) == list(ref._cache) == names[:5]
    for n in names[:5]:
        assert _same(list(ours[n]), list(ref[n]))
    ours.prefetch(names, cache_cap=3)
    assert list(ours._cache) == names[-3:]
    fp32 = db.DetectFeatDb(ours.img_dir, conf_th, max_bb, min_bb,
                           keep_fp16=False, native=False)
    assert fp32[names[0]][0].dtype == np.float32
    assert _same(list(fp32[names[0]]), list(jax_db.DetectFeatDb(
        ref.img_dir, conf_th, max_bb, min_bb, keep_fp16=False)[names[0]]))


@pytest.mark.parametrize("max_txt_len,shard", [
    (60, None), (14, None), (-1, (0, 3)), (30, (2, 3))])
def test_txt_tok_db_matches_reference(ref_corpus, max_txt_len, shard):
    for corpus in ref_corpus.values():
        ours = db.TxtTokDb(corpus["txt_db"], max_txt_len, shard=shard)
        ref = jax_db.TxtTokDb(corpus["txt_db"], max_txt_len, shard=shard)
        assert ours.ids == ref.ids and ours.id2len == ref.id2len
        assert (ours.cls_, ours.sep, ours.mask, ours.v_range) == \
            (ref.cls_, ref.sep, ref.mask, ref.v_range)
        assert ours.txt2img == ref.txt2img
        assert ours.img2txts == ref.img2txts
        for i in ref.ids:
            assert _same(ours[i], ref[i])
            ids = ref[i]["input_ids"]
            assert _same(ours.combine_inputs(ids, ids[:2]),
                         ref.combine_inputs(ids, ids[:2]))
        assert db.get_ids_and_lens(ours) == jax_db.get_ids_and_lens(ref)


def test_soft_label_routing_and_group_dbs(ref_corpus, tmp_path):
    corpus = ref_corpus[True]
    ours = db.SoftLabelDb(corpus["soft_label_db"])
    ref = jax_db.SoftLabelDb(corpus["soft_label_db"])
    names = json.load(open(os.path.join(corpus["txt_db"], "txt2img.json")))
    for n in set(names.values()):
        assert _same(ours[n], ref[n])
    a = db.DetectFeatDb(_img_copy(corpus, tmp_path, "a"))
    b = db.DetectFeatDb(_img_copy(ref_corpus[False], tmp_path, "b"))
    ja = jax_db.DetectFeatDb(a.img_dir)
    jb = jax_db.DetectFeatDb(b.img_dir)
    route = db.RoutingImageDb({"coco_00000": a}, default=b)
    jroute = jax_db.RoutingImageDb({"coco_00000": ja}, default=jb)
    for n in ("coco_000001.npz", "coco_000012.npz"):
        assert (n in route) == (n in jroute)
    for n in ("coco_000001.npz", "coco_000009.npz"):
        assert route.name2nbb[n] == jroute.name2nbb[n]
        assert _same(list(route[n]), list(jroute[n]))
        assert _same(route.get_dump(n), jroute.get_dump(n))
    assert sorted(route.name2nbb.keys()) == sorted(jroute.name2nbb.keys())
    with pytest.raises(KeyError):
        db.RoutingImageDb({"x": a})["coco_000001.npz"]
    group = db.ImageDbGroup(0.2, 100, 10, 36)
    assert group[a.img_dir] is group[a.img_dir]
    assert group[a.img_dir].name2nbb == a.name2nbb


# --------------------------------------------- datasets, loaders, retrieval
def _task_datasets(pkg, dbmod, corpus, vocab):
    txt = dbmod.TxtTokDb(corpus["txt_db"], 60)
    img = dbmod.DetectFeatDb(corpus["img_db"], 0.2, 40, 4, 36)
    return {"itm": pkg.ItmDataset(txt, img, 0.5),
            "mlm": pkg.MlmDataset(txt, img),
            "vmlm": pkg.VmlmDataset(txt, img, label_vocab=vocab, lang="de"),
            "tlm": pkg.TlmDataset(txt, img, "mix")}


def _tok(word):
    return labels.hash_tokenize(word, vocab_size=VOCAB)


@pytest.mark.parametrize("task", ["itm", "mlm", "vmlm", "tlm"])
def test_datasets_and_loaders_over_stores_match_reference(ref_corpus, task):
    """The port's task datasets and TaskLoader over the port's databases
    give the reference's batches over the reference's databases, bit for
    bit (the loader's prefetch reads the images through the store's
    thread pool first)."""
    corpus = ref_corpus[True]
    ours = _task_datasets(datasets, db, corpus,
                          labels.LabelVocab(tokenize=_tok))[task]
    ref = _task_datasets(jax_datasets, jax_db, corpus,
                         jax_labels.LabelVocab(tokenize=_tok))[task]
    assert ours.lens == ref.lens and ours.txt_lens == ref.txt_lens
    got = loader.TaskLoader(task, ours, default_buckets(60, 40, 512), seed=3)
    want = jax_loader.TaskLoader(task, ref, jax_buckets(60, 40, 512), seed=3)
    for _ in range(4):
        g, w = got.next_batch(), want.next_batch()
        assert set(g) == set(w)
        for k in w:
            assert _same(np.asarray(g[k]), np.asarray(w[k])), k
    assert ours.img_db._cache and list(ours.img_db._cache) == \
        list(ref.img_db._cache)


def test_full_retrieval_eval_over_stores_matches_reference(ref_corpus):
    tiny = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64, img_dim=16, dtype="float32")
    corpus = ref_corpus[False]
    jm = JaxRetrieval(JaxConfig(**tiny))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    port = UC2ForImageTextRetrieval(UC2Config(**tiny), device="cpu",
                                    params=params)
    txt, jtxt = (m.TxtTokDb(corpus["txt_db"], 22) for m in (db, jax_db))
    img, jimg = (m.DetectFeatDb(corpus["img_db"], 0.2, 40, 4)
                 for m in (db, jax_db))
    want, (wm, wt, wi) = jax_retrieval.full_retrieval_eval(
        jm, params, jtxt, jimg, 22, 40, batch_size=8, return_matrix=True)
    got, (gm, gt, gi) = retrieval.full_retrieval_eval(
        port, txt, img, 22, 40, batch_size=8, return_matrix=True,
        device="cpu")
    assert (gt, gi) == (wt, wi)
    np.testing.assert_allclose(gm, wm, rtol=1e-4, atol=1e-4)
    assert got == want
