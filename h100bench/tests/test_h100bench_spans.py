"""The readers of the port's spans and counters on the CPU at tiny sizes:
the gallery load and the padded slots of a traced score call, each run's
reading its own call's, no reading of the stream spans on the host's
clock, and none from a program without the spans."""

import json

import numpy as np
import pytest

from h100bench import harness
from h100bench.frozen.generators import gallery
from h100bench.tests.conftest import TINY_SCORE

SEED = 2 ** 33 + 11
SCORE = ("gallery_ms.score", "padded_slots.score")
TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train",
         "lm_head_ms.train")
# the buckets' upper region edges at text width 62: num_bb 36 -> 18, 36;
# num_bb 100 -> 36, 66, 100
EDGES = {"uc2-base.score-nbb36": (18, 36),
         "uc2-base.score-nbb100": (36, 66, 100)}


def hand_count(bench, cell) -> float:
    """100 x (1 - pairs / slots) of one traced call of ``cell``: every
    caption against each bucket's images in tiles of the batch size."""
    w = bench.workload(cell)
    c, t = bench.config(w["config"]), bench.traffic(w["traffic"])
    tok = dict(t, vocab_size=c["vocab_size"], img_dim=c["img_dim"],
               first_word_id=c["first_word_id"])
    nbb = np.minimum(gallery(SEED, tok, t["num_bb"], "cpu")[2], t["num_bb"])
    tiles = 0
    low = 0
    for edge in EDGES[cell]:
        n = int(((nbb > low) & (nbb <= edge)).sum())
        tiles += -(-n // t["batch_size"])
        low = edge
    assert tiles * t["batch_size"] > t["n_imgs"]     # some slots padded
    return 100.0 * (1.0 - t["n_imgs"] / (tiles * t["batch_size"]))


def test_score_readers_read_their_own_call(tiny):
    """Two traced score runs in one process: each reads the gallery load
    of its call and its own padded share."""
    for cell in EDGES:
        r = harness.run_cell(tiny, cell, SEED, 0.2, True, "cpu")
        m = r["metrics"]
        assert r["correct"], r
        assert m["gallery_ms.score"]["value"] > 0
        assert m["gallery_ms.score"]["unit"] == "ms/call"
        assert m["padded_slots.score"]["value"] == pytest.approx(
            hand_count(tiny, cell), abs=1e-9)
    assert TINY_SCORE["captions_per_call"] > 1


def test_train_readers_give_no_reading_on_the_host_clock(tiny):
    """The training spans are recorded, marked on the host's clock, and
    their readers give no reading there."""
    from uc2_torch.utils.profiling import records
    for cell in ("uc2-base.pretrain-mix", "uniter-base.nlvr2-triplet"):
        r = harness.run_cell(tiny, cell, SEED, 0.2, True, "cpu")
        assert not set(r["metrics"]) & {n for m in TRAIN for n in (
            m, m.replace(".train", ".train_step"))}
        steps = [x for x in records() if x.name == "train.step"]
        assert steps and not any(x.on_device for x in steps)


def test_readers_without_the_spans(tiny, monkeypatch):
    """A program without ``records`` (one from before the spans): every new
    reader gives no reading and raises nothing."""
    from uc2_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    trace = harness.Trace([], None, 1.0, 2, [], {}, {})
    for name in SCORE + TRAIN:
        assert tiny.reader(name)(trace) is None, name


def test_the_new_entries_name_their_readers():
    spec = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    names = {m["name"]: m for m in spec["per_layer"]}
    for name in SCORE + TRAIN + tuple(
            m.replace(".train", ".train_step") for m in TRAIN[:3]):
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
        assert names[name]["workloads"]
