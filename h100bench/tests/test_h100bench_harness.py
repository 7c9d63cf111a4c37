"""The harness on the CPU at tiny sizes: cells, configurations and metrics
found by name, the result line, the reference against the port, the
imports, and the check failing runs with planted faults."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.tests.conftest import HERE, tiny_tree

CELLS = ("uc2-base.score-nbb36", "uniter-base.nlvr2-triplet",
         "uc2-base.score-nbb100", "uc2-base.pretrain-mix")
SEED = 2 ** 33 + 7          # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", CELLS)
def test_reference_holds_the_port_at_fp32(tiny, cell):
    """At fp32 on the CPU the port and the reference agree far inside
    every limit: the reference computes what the port computes."""
    r = harness.run_cell(tiny, cell, SEED, 0.2, False, "cpu")
    assert r["correct"], r
    for name, c in r["checks"].items():
        assert c["value"] < 1e-4, (name, c)


def test_result_line_keys(tiny):
    r = harness.run_cell(tiny, CELLS[0], SEED, 0.2, True, "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes", "busy_s", "window_s"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    r0 = harness.run_cell(tiny, CELLS[0], SEED, 0.2, False, "cpu")
    assert set(r0["metrics"]) == {"score_pairs_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r0["metrics"].values())


def test_each_cell_reports_the_metrics_it_names(tiny):
    """A cell reports the end-to-end metrics that list it and, traced,
    the per-layer metrics that list it (on the CPU the device's readers
    find nothing to read): the NLVR2 cell carries its rate per layer."""
    cell = CELLS[1]
    r0 = harness.run_cell(tiny, cell, SEED, 0.2, False, "cpu")
    assert set(r0["metrics"]) == {m["name"] for m in tiny.end_to_end(cell)}
    assert set(r0["metrics"]) == {"train_step_p90_ms", "setup_s"}
    r1 = harness.run_cell(tiny, cell, SEED, 0.2, True, "cpu")
    assert set(r1["metrics"]) == {"examples_per_s.train_step",
                                  "mfu.train_step"}
    assert all(m["value"] > 0 for m in r1["metrics"].values())
    moves = {m["moves"] for m in tiny.per_layer(cell)}
    assert moves <= set(r0["metrics"])


def test_cell_config_and_metric_added_as_files_only(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric run
    with no edit of any file the benchmark has."""
    files = tiny_tree(tmp_path)
    c = json.loads((files / "configs" / "uc2-base.json").read_text())
    c["num_hidden_layers"] = 1
    (files / "configs" / "uc2-one.json").write_text(json.dumps(c))
    t = json.loads((files / "traffic" / "score-nbb36.json").read_text())
    t["num_bb"] = 20
    (files / "traffic" / "score-nbb20.json").write_text(json.dumps(t))
    (files / "workloads" / "uc2-one.score-nbb20.json").write_text(
        json.dumps({"checks": {"score_gap": {"limit": 1.0}}}))
    (files / "metrics" / "units_in_slice.score.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "uc2-one.score-nbb20",
                              "config": "uc2-one", "traffic": "score-nbb20",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "units_in_slice.score",
                              "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "model",
                              "moves": "score_pairs_per_s",
                              "workloads": ["uc2-one.score-nbb20"]})
    spec["end_to_end"][0]["workloads"].append("uc2-one.score-nbb20")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tmp_path, files)
    r = harness.run_cell(bench, "uc2-one.score-nbb20", SEED, 0.2, True, "cpu")
    assert r["correct"]
    # 3 captions x (12 images over batches of 5 in the 20-region buckets)
    assert r["metrics"]["units_in_slice.score"]["value"] > 0
    r0 = harness.run_cell(bench, "uc2-one.score-nbb20", SEED, 0.2, False,
                          "cpu")
    assert "score_pairs_per_s" in r0["metrics"]


def test_every_named_file_exists():
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
        limits = json.loads((HERE / "workloads" / f"{w['name']}.json")
                            .read_text())["checks"]
        assert all(v["limit"] > 0 for v in limits.values())
    for c in spec["configs"]:
        assert (HERE.parent / c["file"]).is_file()
    for m in spec["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_generators_repeat_by_seed():
    from h100bench.frozen import generators as G
    t = json.loads((HERE / "traffic" / "nlvr2-triplet.json").read_text())
    c = json.loads((HERE / "configs" / "uniter-base.json").read_text())
    t.update({k: c[k] for k in ("vocab_size", "img_dim", "first_word_id",
                                "pad_token_id", "cls_token_id",
                                "sep_token_id")}, batch_size=3, img_dim=8)
    a, la = G.nlvr2_batch(SEED, 4, t, "cpu")
    b, lb = G.nlvr2_batch(SEED, 4, t, "cpu")
    c2, _ = G.nlvr2_batch(SEED + 1, 4, t, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["img_feat"], c2["img_feat"])
    assert np.array_equal(la[0], lb[0]) and np.array_equal(la[1], lb[1])
    g = dict(json.loads((HERE / "traffic" / "score-nbb36.json").read_text()),
             vocab_size=100, img_dim=8, first_word_id=4, n_imgs=5)
    x, y = G.gallery(SEED, g, 36, "cpu"), G.gallery(SEED, g, 36, "cpu")
    assert all(np.array_equal(np.asarray(u, object) if isinstance(u, list)
                              else u, np.asarray(v, object)
                              if isinstance(v, list) else v)
               for u, v in zip(x, y))
    w1 = G.make_weights({"a.weight": (3, 4), "b.LayerNorm.weight": (4,)},
                        SEED, "cpu")
    w2 = G.make_weights({"a.weight": (3, 4), "b.LayerNorm.weight": (4,)},
                        SEED, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert abs(float(w1["b.LayerNorm.weight"].mean()) - 1.0) < 0.1
    assert G.sub_seed(SEED, "x") != G.sub_seed(SEED, "y")


def test_counts_by_hand():
    from h100bench.frozen import bounds as BD
    from h100bench.frozen import flops as FL
    # one layer at L = 10, H = 4, F = 8: 2*10*4*16 + 2*10*64 + 4*100*4
    assert FL.encoder_fwd_flops_per_pair(10, 1, 4, 8) == 1280 + 1280 + 1600
    assert FL.img_embed_flops(3, 4, 5) == 120
    assert FL.grad_flops_per_example(2, 3, 0, 1, 4, 8, 50, 5) == 3 * (
        FL.encoder_fwd_flops_per_pair(5, 1, 4, 8) + 120)
    # #3 at 300 x 98 rows of uc2-base
    rows = 300 * 98
    nbytes, flops = BD.ffn_block(rows)
    assert nbytes == 2 * rows * 768 * 2 + 2 * 768 * 3072 * 2 + (3072 + 3 * 768) * 4
    assert flops == 4 * rows * 768 * 3072
    assert BD.bound_s(nbytes, flops) == pytest.approx(flops / 989e12)
    # #5 / #6a / #6b at (32, 262), 12 heads of 64, rate 0.1
    assert BD.attn_train_fwd(32, 262) == (4 * 32 * 262 * 768 * 2 + 32 * 262 * 4,
                                          4 * 32 * 12 * 262 * 262 * 64)
    act, stat, bits = 32 * 262 * 768 * 2, 3 * 32 * 12 * 262 * 4, \
        32 * 12 * 320 * 320 // 8
    assert BD.attn_bwd_rows(32, 262) == (5 * act + 32 * 262 * 4 + stat + bits,
                                         6 * 32 * 12 * 262 * 262 * 64)
    assert BD.attn_bwd_keys(32, 262) == (
        6 * act + 32 * 262 * 4 + stat + 32 * 12 * 262 * 4 + bits,
        8 * 32 * 12 * 262 * 262 * 64)


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "uc2_tpu.ops", "uc2_torch",
         "uc2_torch.ops", "jaxtyping", "uc2_tpu_extra"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "uc2_tpu.ops"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process leaves no JAX, Flax or uc2_tpu in
    sys.modules."""
    files = tiny_tree(tmp_path)
    code = (
        "import sys; from pathlib import Path\n"
        "from h100bench import harness\n"
        f"b = harness.Bench(Path({str(tmp_path)!r}), Path({str(files)!r}))\n"
        f"r = harness.run_cell(b, {CELLS[1]!r}, 5, 0.1, False, 'cpu')\n"
        "print(harness.forbidden_modules(sys.modules), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_program():
    banned = {"uc2_torch", "uc2_tpu", "jax", "jaxlib", "flax"}
    for f in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & banned, f


def test_no_result_without_a_card(tmp_path):
    """``run`` exits 2 and prints no result line where CUDA is missing;
    the same from a tree that holds only the benchmark's files."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=HERE.parent)
    assert out.returncode == 2 and out.stdout == ""
    import shutil
    shutil.copytree(HERE, tmp_path / "h100bench")
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_pretrain_rows_route_as_the_ports_batcher():
    """Every row of a mix step lies in the bucket the port's own
    ``pick_bucket`` routes it to, with its text whole; each task's steps
    fall on the buckets in proportion to the rows routed there over the
    bucket's batch size; the check's steps take every task and bucket."""
    from uc2_torch.data.collate import BucketSpec, pick_bucket
    from h100bench.frozen import generators as G
    t = json.loads((HERE / "traffic" / "pretrain-mix.json").read_text())
    c = json.loads((HERE / "configs" / "uc2-base.json").read_text())
    t.update({k: c[k] for k in ("vocab_size", "first_word_id",
                                "pad_token_id", "cls_token_id",
                                "sep_token_id")}, img_dim=4, accum=1)
    specs = [BucketSpec(lt, nb, b, m) for lt, nb, b, m in t["buckets"]]
    assert {task for task, _ in t["check"]} == set(t["mix"])
    assert {bi for _, bi in t["check"]} == set(range(len(t["buckets"])))
    for step in (0, 3, 4, 40):
        task, b, (n_txt, nr, _) = G.pretrain_batch(SEED, step, t, "cpu")
        bi = [x[0] for x in t["buckets"]].index(b["input_ids"].shape[-1])
        assert all(pick_bucket(specs, int(a), int(n)) == bi
                   for a, n in zip(n_txt, nr))
        ids = b["input_ids"][0].numpy()
        assert all(ids[r, n - 1] == t["sep_token_id"]
                   for r, n in enumerate(n_txt))
    for task in t["mix"]:
        rows = G.bucket_rows(t, task)
        want = np.asarray([len(r) / s.batch_size for r, s in
                           zip(rows, specs)])
        deck = np.asarray(G.bucket_deck(t, task))
        assert np.abs(deck / deck.sum() - want / want.sum()).max() < 0.02
    got = [G.task_and_bucket(SEED, i, t)[0] for i in range(21)]
    assert sorted(got) == sorted(n for n, w in t["mix"].items()
                                 for _ in range(w))
