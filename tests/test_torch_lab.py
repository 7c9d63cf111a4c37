"""The kernel lab of uc2_torch (``python -m uc2_torch.lab``) and the two
kernels only it reaches, on the CPU: #8's plain version
(``fused_layer_block_plain``) against the reference's ``fused_layer_block``
in interpret mode, #11's (``attention_bf16_probs_plain``) against the
reference lab's ``_fwd_v4`` with ``_kernel_bf16`` in interpret mode, #1's
plain version against the lab's batch-block and query-split variants of
#1's function (which the port's lab runs as #1), and every lab mode run
through the plain versions at a tiny size.

``scripts/kernel_lab.py`` is imported by its path. Its kernels run under
``pltpu.force_tpu_interpret_mode()``, each call as one ``jax.jit``
program: interpret mode runs a kernel through host callbacks, which can
deadlock against JAX operations dispatched eagerly while they run."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from uc2_tpu.ops import fused_block as jfb
from uc2_torch import lab
from uc2_torch.ops.flash_attention import flash_attention, flash_attention_v3
from uc2_torch.ops.fused_block import (fused_attn_block_plain,
                                       fused_ffn_block_plain,
                                       fused_layer_block,
                                       fused_layer_block_plain)
from uc2_torch.ops.lab_attention import (attention_bf16_probs,
                                         attention_bf16_probs_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one layer in fp32, sums taken in another order
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs rounded at the same points, fp32 sums in another order: two
# bf16 ulps of the value
BF16_RTOL = 2.0 ** -7
TINY_LAB = ["--device", "cpu", "--batch", "2", "--txt_len", "8", "--num_bb",
            "8", "--iters", "1"]
RACERS = {"op": ["v3", "v3bb1", "v3bb4", "v4bf16", "v4qs", "xla", "sdpa"],
          "block": ["fusedblock", "xlablock"],
          "block2": ["v1chain", "v2inkernel"],
          "ffn": ["xlaffn", "fusedffn"],
          "layer": ["xlalayer", "split2", "onekernel"]}
CE_RACERS = ["xlace_grad", "chunked8_grad", "matmul_roofline"]


@pytest.fixture(scope="module")
def kernel_lab():
    """scripts/kernel_lab.py, imported by its path."""
    path = os.path.join(ROOT, "scripts", "kernel_lab.py")
    spec = importlib.util.spec_from_file_location("reference_kernel_lab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(fn, *arrays):
    """One jitted call of a lab variant under TPU interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(fn)(*map(jnp.asarray, arrays)),
                          np.float32)


def _heads(rng, B, L, n, d, scale=1.0):
    return [(rng.standard_normal((B, L, n, d)) * scale).astype(np.float32)
            for _ in range(3)]


def _bias(rng, B, L):
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    mask[:, :2] = 1.0
    return ((1.0 - mask) * -10000.0)[:, None, None, :]


# ------------------------------------------------------------------ #8
def _layer_inputs(B=2, L=32, n=2, d=16, Fi=64, seed=3):
    """The inputs of tests/test_fused_block.py's whole-layer test, with the
    weights in the reference's [in, out] layout."""
    H = n * d
    rng = np.random.default_rng(seed)
    f32 = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    q, k, v = (f32(B, L, n, d) for _ in range(3))
    x = f32(B, L, H)
    wo, bo = f32(H, H), f32(H)
    g1 = (1.0 + rng.standard_normal(H) * 0.1).astype(np.float32)
    be1 = f32(H)
    w1, b1, w2, b2 = f32(H, Fi), f32(Fi), f32(Fi, H), f32(H)
    g2 = (1.0 + rng.standard_normal(H) * 0.1).astype(np.float32)
    be2 = f32(H)
    return dict(q=q, k=k, v=v, bias=_bias(rng, B, L), x=x, wo=wo, bo=bo,
                g1=g1, be1=be1, w1=w1, b1=b1, w2=w2, b2=b2, g2=g2, be2=be2)


ACTS = ("q", "k", "v", "x", "wo", "w1", "w2")   # bf16 in the bf16 case
ORDER = ("q", "k", "v", "bias", "x", "wo", "bo", "g1", "be1", "w1", "b1",
         "w2", "b2", "g2", "be2")


def _reference(a, dtype):
    return {k: jnp.asarray(v, dtype if k in ACTS else jnp.float32)
            for k, v in a.items()}


def _port(a, dtype):
    """The same values for the port, weights as [out, in]."""
    out = {k: torch.from_numpy(np.ascontiguousarray(
        v.T if k in ("wo", "w1", "w2") else v)) for k, v in a.items()}
    return {k: t.to(dtype) if k in ACTS else t for k, t in out.items()}


def test_fused_layer_block_plain_matches_pallas():
    a = _layer_inputs()
    r = _reference(a, jnp.float32)
    want = np.asarray(jfb.fused_layer_block(*(r[k] for k in ORDER),
                                            eps=1e-12, interpret=True))
    p = _port(a, torch.float32)
    before = fused_layer_block.launches
    got = fused_layer_block(*(p[k] for k in ORDER), eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
    assert fused_layer_block.launches == before          # CPU: no launch


@pytest.mark.parametrize("L", [64, 65])
def test_fused_layer_block_plain_matches_pallas_at_tile_edges(L):
    """At the edges of the kernel's 64-row query tiles: a whole tile, and
    one row past it."""
    a = _layer_inputs(B=1, L=L, seed=L)
    r = _reference(a, jnp.float32)
    want = np.asarray(jfb.fused_layer_block(*(r[k] for k in ORDER),
                                            eps=1e-12, interpret=True))
    p = _port(a, torch.float32)
    got = fused_layer_block(*(p[k] for k in ORDER), eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


def _bf16_close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)


def test_fused_layer_block_plain_keeps_the_fp32_residual():
    """bf16 activations: the layer (#8) adds LN1's fp32 output as the FFN's
    residual, the split #2 -> #3 adds its bf16 rounding. The plain version
    matches the reference's layer, the port's split matches the
    reference's split, and the two functions differ at most of the
    positions where the reference's two differ."""
    a = _layer_inputs(seed=7)
    a = {k: v * 20.0 if k in ("q", "k", "v", "x") else v
         for k, v in a.items()}
    r, p = _reference(a, jnp.bfloat16), _port(a, torch.bfloat16)
    ref_layer = np.asarray(jfb.fused_layer_block(
        *(r[k] for k in ORDER), eps=1e-12, interpret=True), np.float32)
    ref_x2 = jfb.fused_attn_block(*(r[k] for k in ORDER[:9]), eps=1e-12,
                                  interpret=True)
    ref_split = np.asarray(jfb.fused_ffn_block(
        ref_x2, *(r[k] for k in ORDER[9:]), eps=1e-12, interpret=True),
        np.float32)
    port_layer = fused_layer_block_plain(*(p[k] for k in ORDER))
    port_split = fused_ffn_block_plain(
        fused_attn_block_plain(*(p[k] for k in ORDER[:9])),
        *(p[k] for k in ORDER[9:]))
    _bf16_close(port_layer, ref_layer)
    _bf16_close(port_split, ref_split)
    assert (port_layer.float().numpy() == ref_layer).mean() > 0.99
    ref_differs = ref_layer != ref_split
    port_differs = (port_layer != port_split).numpy()
    assert ref_differs.mean() > 0.1
    assert port_differs[ref_differs].mean() > 0.5


def test_fused_layer_block_refuses_wrong_shapes():
    p = _port(_layer_inputs(), torch.float32)
    bad = dict(p, w2=p["w2"].t())          # [F, H]: the reference's layout
    with pytest.raises(ValueError):
        fused_layer_block(*(bad[k] for k in ORDER))
    with pytest.raises(ValueError):
        fused_layer_block(*(p[k].to("meta") for k in ORDER))


# ----------------------------------------------------------------- #11
# e is rounded to bf16 in both versions, from fp32 scores whose sums are
# taken in another order: a rounding flip moves one probability by up to
# 2^-8 (before the division by a sum >= 1), so one output by up to
# 2^-8 * |v_j - o| <= 2^-7 max|v|. Such flips are rare: nearly every output
# agrees to the fp32 sums' precision.
def _v4_tolerance(v):
    return 2.0 ** -7 * float(np.abs(v).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bf16_probs_plain_matches_kernel_lab(kernel_lab, dtype):
    rng = np.random.default_rng(11)
    q, k, v = _heads(rng, 2, 40, 2, 64)
    bias = _bias(rng, 2, 40)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qj, kj, vj = (jnp.asarray(t, jdt) for t in (q, k, v))
    want = _interpret(
        lambda *a: kernel_lab._fwd_v4(*a, kernel_lab._kernel_bf16),
        qj, kj, vj, bias)
    before = attention_bf16_probs.launches
    got = attention_bf16_probs(*(torch.from_numpy(t).to(tdt)
                                 for t in (q, k, v)),
                               torch.from_numpy(bias)).float().numpy()
    assert attention_bf16_probs.launches == before       # CPU: no launch
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=_v4_tolerance(np.asarray(vj, np.float32)))
    close = np.isclose(got, want, rtol=rtol, atol=1e-5)
    assert close.mean() > 0.99
    # not #1's function: normalising before rounding gives other values
    normalised = flash_attention_v3(*(torch.from_numpy(t).to(tdt)
                                      for t in (q, k, v)),
                                    torch.from_numpy(bias)).float().numpy()
    assert not np.array_equal(normalised, got)


def test_attention_bf16_probs_takes_row_stride_views():
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.standard_normal((2, 24, 3 * 128)).astype(
        np.float32)).bfloat16()
    q, k, v = (t.view(2, 24, 2, 64) for t in qkv.split(128, dim=-1))
    bias = torch.from_numpy(_bias(rng, 2, 24))
    got = attention_bf16_probs(q, k, v, bias)
    want = attention_bf16_probs_plain(*(t.contiguous() for t in (q, k, v)),
                                      bias)
    assert got.shape == (2, 24, 2, 64) and torch.equal(got, want)


# -------------------------------------------- #1 and the lab's variants of it
@pytest.mark.parametrize("variant", ["v3bb1", "v3bb4", "v4qs"])
def test_flash_attention_plain_matches_lab_variants(kernel_lab, variant):
    """The lab's BB = 1 / 4 and query-split variants compute #1's function,
    so the port's lab runs them as #1: its plain version matches each at
    the JAX kernel tests' fp32 bar (L even, so the query split halves it)."""
    rng = np.random.default_rng(13)
    q, k, v = _heads(rng, 4, 24, 2, 16)
    bias = _bias(rng, 4, 24)
    want = _interpret(kernel_lab.VARIANTS[variant], q, k, v, bias)
    before = flash_attention.launches
    got = flash_attention_v3(*(torch.from_numpy(t) for t in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert flash_attention.launches == before


# ---------------------------------------------------------------- the lab
@pytest.mark.parametrize("mode", list(RACERS))
def test_lab_mode_runs_every_racer_on_the_cpu(mode, capsys):
    assert lab.main(TINY_LAB + ["--mode", mode]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    for name in RACERS[mode]:
        assert f"RESULT {name}: " in out and " maxerr=" in out, name


def test_lab_ce_race_runs_every_racer_on_the_cpu(capsys):
    assert lab.ce_race(2, 1, torch.device("cpu"), V=1000) == []
    out = capsys.readouterr().out
    assert "FAILED" not in out
    for name in CE_RACERS:
        assert f"RESULT {name}: " in out, name
    assert "TF/s" in out


def test_lab_reports_a_failed_racer_and_exits_1(monkeypatch, capsys):
    def broken(*args):
        raise RuntimeError("broken racer")
    monkeypatch.setitem(lab.OP_VARIANTS, "v4bf16", broken)
    assert lab.main(TINY_LAB + ["--mode", "op"]) == 1
    out = capsys.readouterr().out
    assert "RESULT v4bf16: FAILED RuntimeError broken racer" in out
    assert "RESULT xla: " in out                 # the others still ran


def test_lab_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError):
        lab.main(["--mode", "op"])
