"""A small copy of the benchmark's tree for CPU runs of the harness: the
committed configurations, traffic and limits with tiny widths and counts,
the committed metric readers."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
TINY_MODEL = {"hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 64,
              "img_dim": 16, "vocab_size": 1200, "dtype": "float32"}
# the published widths and depth: scores spread between pairs as at
# full size (a fault that mixes pairs up shows)
WIDE_MODEL = {"vocab_size": 1200, "dtype": "float32"}
TINY_SCORE = {"n_imgs": 12, "txt_per_img": 2, "batch_size": 5,
              "captions_per_call": 3, "warmup_captions": 1,
              "check_pairs": 20, "ref_block": 8}
WIDE_SCORE = {"n_imgs": 40, "txt_per_img": 2, "batch_size": 8,
              "captions_per_call": 3, "warmup_captions": 1,
              "check_pairs": 120, "ref_block": 40}
TINY_TRAIN = {"batch_size": 4, "max_bb": 16, "min_words": 1,
              "max_words": 3, "trace_steps": 2,
              "buckets": [[8, 12, 3, 4], [16, 24, 2, 6]],
              "bucket_deck": 4, "accum": 2,
              "check": [["mlm", 0], ["itm", 1], ["vmlm", 1], ["tlm", 0]]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips on machines without one")


def tiny_tree(root: Path, model=TINY_MODEL, score=TINY_SCORE) -> Path:
    """``root`` with BENCHMARK.json and ``root/files``: the benchmark's
    files cut to tiny sizes (the model's to ``model``, the scoring
    traffic's to ``score``). Returns ``root/files``."""
    files = root / "files"
    for kind in ("configs", "traffic", "workloads", "metrics"):
        (files / kind).mkdir(parents=True, exist_ok=True)
    for f in (HERE / "metrics").glob("*.py"):
        shutil.copy(f, files / "metrics" / f.name)
    for f in (HERE / "workloads").glob("*.json"):
        shutil.copy(f, files / "workloads" / f.name)
    for f in (HERE / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(model)
        (files / "configs" / f.name).write_text(json.dumps(c))
    for f in (HERE / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(score if t["driver"] == "score" else TINY_TRAIN)
        (files / "traffic" / f.name).write_text(json.dumps(t))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return files


@pytest.fixture
def tiny(tmp_path):
    from h100bench.harness import Bench
    files = tiny_tree(tmp_path)
    return Bench(tmp_path, files)


@pytest.fixture
def wide(tmp_path):
    from h100bench.harness import Bench
    files = tiny_tree(tmp_path, WIDE_MODEL, WIDE_SCORE)
    return Bench(tmp_path, files)
