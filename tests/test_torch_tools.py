"""The port's profiling and FLOP utilities and its offline data tools
against the reference package's on the CPU:

* ``trace`` writes a Chrome trace with the port's ``span`` ranges;
* the FLOP model equal to ``uc2_tpu/utils/flops.py`` at several shapes;
* ``data.mdb`` written by the port byte for byte the reference's for the
  same items (leaf, branch and overflow pages), each reader reading the
  other's; LZ4 frames decoded across the two packages;
* ``python -m uc2_torch.import_lmdb`` on a fixture in the original
  release's format (built as tests/test_lmdb_import.py builds one, and by
  the port's own ``reference_lmdb``, byte for byte the same) giving the
  stores scripts/import_lmdb.py gives, npz and msgpack-numpy image values;
  then two port pretraining steps from the imported stores;
* ``params_to_uc2_state_dict`` and ``python -m uc2_torch.export_uc2``
  equal, key for key and value for value, to the reference's
  ``params_to_torch_state_dict(params_to_jax(...))``, and loadable back;
* the M3P tokenizer's gating, as tests/test_utils.py holds the
  reference's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import jax

from tests.test_lmdb_import import u2s_to_reference_lmdb
from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.data import lmdbio as jax_lmdbio
from uc2_tpu.data import lz4frame as jax_lz4frame
from uc2_tpu.models import convert as jax_convert
from uc2_tpu.models.pretraining import UC2ForPretraining as JaxPretraining
from uc2_tpu.utils import flops as jax_flops
from uc2_torch import export_uc2, import_lmdb
from uc2_torch.config import UC2Config
from uc2_torch.data import lmdbio, lz4frame
from uc2_torch.data.collate import BucketSpec
from uc2_torch.data.datasets import MlmDataset
from uc2_torch.data.db import DetectFeatDb, TxtTokDb
from uc2_torch.data.loader import TaskLoader, task_batch_to_device
from uc2_torch.data.store import StoreReader
from uc2_torch.data.synth import reference_lmdb, synth_corpus
from uc2_torch.models import convert
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training.optim import build_optimizer, constant
from uc2_torch.training.step import train_step
from uc2_torch.utils import flops, profiling
from uc2_torch.utils.m3p_tokenizer import M3PTokenizer


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.span("uc2_matmul"):
            (a @ a).sum()
    path = tmp_path / "t" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "uc2_matmul" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    assert profiling.records()[-1].name == "uc2_matmul"


@pytest.mark.parametrize("Lt,Nb,M", [(62, 36, 24), (62, 100, 24),
                                     (410, 100, 144), (22, 0, 3)])
def test_flops_match_reference(Lt, Nb, M):
    assert (flops.encoder_fwd_flops_per_pair(Lt + Nb)
            == jax_flops.encoder_fwd_flops_per_pair(Lt + Nb))
    assert (flops.encoder_fwd_flops_per_pair(Lt + Nb, n_layers=2, H=64,
                                             F=128)
            == jax_flops.encoder_fwd_flops_per_pair(Lt + Nb, n_layers=2,
                                                    H=64, F=128))
    assert (flops.grad_flops_per_example(Lt, Nb, M)
            == jax_flops.grad_flops_per_example(Lt, Nb, M))
    assert not hasattr(flops, "CHIP_PEAK_TFLOPS")


def _items(n=700, seed=0):
    """Keys enough for branch pages; values small, large (overflow pages)
    and empty."""
    rng = np.random.default_rng(seed)
    out = {f"key_{i:05d}": rng.bytes(int(rng.integers(0, 300)))
           for i in range(n)}
    out["big_value"] = rng.bytes(3 * 4096 + 17)
    out["mid_value"] = rng.bytes(2000)
    return out


def test_lmdb_files_are_the_reference_bytes(tmp_path):
    items = _items()
    for name, mod in (("port", lmdbio), ("ref", jax_lmdbio)):
        os.makedirs(tmp_path / name)
        with mod.LmdbWriter(str(tmp_path / name)) as w:
            for k, v in items.items():
                w.put(k, v)
    port = (tmp_path / "port" / "data.mdb").read_bytes()
    assert port == (tmp_path / "ref" / "data.mdb").read_bytes()
    assert len(port) > 10 * 4096
    for reader, src in ((lmdbio.LmdbReader, "ref"),
                        (jax_lmdbio.LmdbReader, "port")):
        r = reader(str(tmp_path / src))
        got = dict(r.items())
        assert got == {k.encode(): v for k, v in items.items()}
        assert r.get(b"big_value") == items["big_value"]


def test_lz4_frames_cross_packages():
    rng = np.random.default_rng(1)
    for data in (b"", b"uc2" * 5000, rng.bytes(70000),
                 bytes(3 << 20)):                # several decode chunks
        a, b = lz4frame.compress(data), jax_lz4frame.compress(data)
        assert a == b
        assert lz4frame.decompress(b) == data == jax_lz4frame.decompress(a)


def _reference_importer():
    spec = importlib.util.spec_from_file_location(
        "import_lmdb_ref", os.path.join(os.path.dirname(__file__), "..",
                                        "scripts", "import_lmdb.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A corpus in the release's format (the reference's fixture and the
    port's), imported by both importers."""
    root = tmp_path_factory.mktemp("lmdb_tools")
    corpus = synth_corpus(str(root / "u2s"), n_imgs=12, txt_per_img=2,
                          min_bb=4, max_bb=10, img_dim=16, n_classes=11,
                          seed=3, max_words=6, vocab=512)
    ref_lmdb = u2s_to_reference_lmdb(corpus["txt_db"], corpus["img_db"],
                                     str(root / "ref_lmdb"))
    port_lmdb = reference_lmdb(corpus["txt_db"], corpus["img_db"],
                               str(root / "port_lmdb"))
    mp_lmdb = reference_lmdb(corpus["txt_db"], corpus["img_db"],
                             str(root / "mp_lmdb"), npz=False)
    ref = _reference_importer()
    out = {}
    for name, mod in (("ref", ref), ("port", import_lmdb)):
        mod.import_txt(ref_lmdb[0], str(root / name / "txt_db"))
        mod.import_img(ref_lmdb[1], str(root / name / "img_db"), npz=True)
        mod.import_img(mp_lmdb["img_db"], str(root / name / "mp_img_db"))
        out[name] = root / name
    return {"corpus": corpus, "ref_lmdb": ref_lmdb, "port_lmdb": port_lmdb,
            "out": out}


def test_port_fixture_is_the_reference_fixture(imported):
    for kind, i in (("txt_db", 0), ("img_db", 1)):
        ref_dir, port_dir = imported["ref_lmdb"][i], imported["port_lmdb"][kind]
        assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
        for f in os.listdir(ref_dir):
            with open(os.path.join(ref_dir, f), "rb") as a, \
                    open(os.path.join(port_dir, f), "rb") as b:
                assert a.read() == b.read(), (kind, f)


@pytest.mark.parametrize("db,store", [("txt_db", "txt.u2s"),
                                      ("img_db", "feat.u2s"),
                                      ("mp_img_db", "feat.u2s")])
def test_importer_writes_the_reference_stores(imported, db, store):
    ref, port = (imported["out"][k] / db for k in ("ref", "port"))
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert (port / store).read_bytes() == (ref / store).read_bytes()
    for side in os.listdir(ref):
        assert (port / side).read_bytes() == (ref / side).read_bytes()
    got, want = (StoreReader(str(d / store), native=False)
                 for d in (port, ref))
    assert got.keys() == want.keys()
    orig = StoreReader(os.path.join(imported["corpus"][db.replace(
        "mp_", "")], store), native=False)
    assert sorted(got.keys()) == sorted(orig.keys())
    if db == "txt_db":
        assert all(got[k] == orig[k] for k in orig.keys())
    else:
        assert list(got["__keys__"]) == list(orig["__keys__"])
        for f in orig["__keys__"]:
            for field in ("features", "norm_bb", "conf", "soft_labels"):
                np.testing.assert_array_equal(got[f][field], orig[f][field])


def test_two_port_steps_from_imported_stores(imported):
    cfg = UC2Config(vocab_size=512, hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=64,
                    max_position_embeddings=64, img_dim=16,
                    img_label_dim=11, dtype="float32")
    out = imported["out"]["port"]
    txt_db = TxtTokDb(str(out / "txt_db"), max_txt_len=18)
    img_db = DetectFeatDb(str(out / "img_db"), 0.2, 10, 4, 10)
    loader = TaskLoader("mlm", MlmDataset(txt_db, img_db),
                        [BucketSpec(20, 10, 4, 12)], seed=0)
    model = UC2ForPretraining(cfg, device="cpu", seed=0)
    opt = build_optimizer(model, constant(1e-4))
    put = task_batch_to_device("cpu")
    losses = []
    for i in range(2):
        _, batch = put(("mlm", loader.next_batch()))
        losses.append(float(train_step(model, opt, batch,
                                       DropoutRng(i, "cpu"))["loss"]))
    assert all(np.isfinite(losses)) and opt.count == 2


@pytest.fixture(scope="module")
def pretraining_state():
    tree = JaxPretraining(JaxConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=40, img_dim=16, img_label_dim=7)
    ).init_params(jax.random.PRNGKey(0))
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def test_export_matches_reference(pretraining_state, tmp_path):
    want = jax_convert.params_to_torch_state_dict(
        convert.params_to_jax(pretraining_state))
    got = convert.params_to_uc2_state_dict(pretraining_state)
    assert list(got) == list(want) and len(got) > 40
    assert "roberta.encoder.layer.1.attention.self.value.weight" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    src, dst = tmp_path / "model_step_2.pt", tmp_path / "uc2.pt"
    torch.save(pretraining_state, src)
    assert export_uc2.main(str(src), str(dst)) == len(want)
    sd = torch.load(dst, weights_only=True)
    assert all(np.array_equal(sd[k].numpy(), want[k]) for k in want)
    # the UC2 keys load back to the same parameters (UC2 checkpoints carry
    # no NCE head, in either package)
    back = convert.params_from_jax(convert.torch_to_params(sd))
    assert {k.split(".")[0] for k in pretraining_state
            if k not in back} == {"nce_output"}
    for k, v in back.items():
        assert torch.equal(v, pretraining_state[k]), k


def test_m3p_tokenizer_gating():
    tok = M3PTokenizer()
    assert tok.bos_id == 0 and tok.pad_id == 1 and tok.eos_id == 2
    assert tok.unk_id == 3 and tok.mask_id == 250001
    if tok.sp is None and tok._hf is None:
        with pytest.raises(RuntimeError):
            tok.encode("hello")
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="sentencepiece"):
            M3PTokenizer(spm_path="/nonexistent/sentencepiece.model")
