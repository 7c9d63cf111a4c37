"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped (the CPU, fp32, small sizes: the
scoring cells at the published widths and two layers), each fault planted
in the port's entry the window drives, the committed limits."""

import pytest
import torch

from h100bench import harness

SEED = 2 ** 32 + 11


def run(bench, cell):
    return harness.run_cell(bench, cell, SEED, 0.2, False, "cpu")


@pytest.mark.parametrize("cell", ["uc2-base.score-nbb36",
                                  "uc2-base.score-nbb100"])
def test_sound_scoring_passes(wide, cell):
    assert run(wide, cell)["correct"]


@pytest.mark.parametrize("cell", ["uniter-base.nlvr2-triplet",
                                  "uc2-base.pretrain-mix"])
def test_sound_training_passes(tiny, cell):
    assert run(tiny, cell)["correct"]


def test_score_altered_where_produced(wide, monkeypatch):
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    real = UC2ForImageTextRetrieval.scores

    def altered(self, batch, *a, **k):
        s = real(self, batch, *a, **k).clone()
        s[0] += 1.0
        return s
    monkeypatch.setattr(UC2ForImageTextRetrieval, "scores", altered)
    assert not run(wide, "uc2-base.score-nbb36")["correct"]


def test_score_half_batch_left_out(wide, monkeypatch):
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    real = UC2ForImageTextRetrieval.scores

    def half(self, batch, *a, **k):
        B = batch["input_ids"].shape[0]
        s = real(self, {n: v[:(B + 1) // 2] for n, v in batch.items()},
                 *a, **k)
        return torch.cat([s, s.mean().expand(B - s.shape[0])])
    monkeypatch.setattr(UC2ForImageTextRetrieval, "scores", half)
    assert not run(wide, "uc2-base.score-nbb36")["correct"]


@pytest.mark.parametrize("cell", ["uniter-base.nlvr2-triplet",
                                  "uc2-base.pretrain-mix"])
def test_train_step_leaves_state_unchanged(tiny, monkeypatch, cell):
    import uc2_torch.training.step as S
    real = S.train_step

    def still(model, opt, batch, rng, **k):
        before = [p.detach().clone() for p in model.parameters()]
        m = real(model, opt, batch, rng, **k)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return m
    monkeypatch.setattr(S, "train_step", still)
    assert not run(tiny, cell)["correct"]


@pytest.mark.parametrize("cell", ["uniter-base.nlvr2-triplet",
                                  "uc2-base.pretrain-mix"])
def test_train_half_batch_left_out(tiny, monkeypatch, cell):
    import uc2_torch.training.step as S
    real = S.train_step

    def half(model, opt, batch, rng, **k):
        cut = slice(None, batch["input_ids"].shape[-2] // 2)
        return real(model, opt, {n: v[:, cut] if batch["input_ids"].dim() == 3
                                 else v[cut] for n, v in batch.items()},
                    rng, **k)
    monkeypatch.setattr(S, "train_step", half)
    assert not run(tiny, cell)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["uc2-base.score-nbb36",
                                  "uc2-base.pretrain-mix",
                                  "uniter-base.nlvr2-triplet",
                                  "uc2-base.score-nbb100"])
def test_control_fails_the_check_on_the_card(cell):
    """The control, the reference in fp8, at the cell's own size reads
    above a committed limit where the port reads within them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.Bench()
    w = bench.workload(cell)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    d = harness.driver(traffic).Driver(cfg, traffic, SEED, "cuda")
    d.setup()
    d.window(0.01)
    d.free()
    checks, limits = d.check(), bench.limits(cell)
    assert all(checks[k] <= lim["limit"] for k, lim in limits.items())
    control = d.control()
    assert any(control[k] > lim["limit"] for k, lim in limits.items())
