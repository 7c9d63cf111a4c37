"""Rules of the uc2_torch package: it imports nothing of JAX or of the
reference package, nor msgpack, lz4, flax, orbax or tensorboardX (a GPU
machine need not have them), its entry points run on the GPU unless the
caller asks for the CPU, its config and parameters line up with the
reference's."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from uc2_tpu.config import UC2Config as JaxConfig
from uc2_tpu.models.finetune import UC2ForImageTextRetrieval as JaxRetrieval
from uc2_torch import resolve_device
from uc2_torch.config import UC2Config
from uc2_torch.models.convert import params_from_jax, params_to_jax
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=40, img_dim=16, dtype="float32")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import uc2_torch
for m in pkgutil.walk_packages(uc2_torch.__path__, "uc2_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "uc2_tpu",
                                    "msgpack", "lz4", "orbax",
                                    "tensorboardX"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = UC2Config(**TINY)
    with pytest.raises(RuntimeError):
        UC2ForImageTextRetrieval(cfg)                  # default: cuda
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        UC2ForPretraining(cfg)
    with pytest.raises(RuntimeError):
        DropoutRng(0)
    model = UC2ForImageTextRetrieval(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    model = UC2ForPretraining(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert DropoutRng(0, "cpu").device.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_config_fields_and_json_match_reference():
    ours = {f.name for f in dataclasses.fields(UC2Config)}
    ref = {f.name for f in dataclasses.fields(JaxConfig)}
    assert ours == ref
    path = os.path.join(ROOT, "config", "uc2-base.json")
    a, b = UC2Config.from_json_file(path), JaxConfig.from_json_file(path)
    assert a.to_dict() == b.to_dict() and a.head_dim == b.head_dim == 64


def test_params_round_trip_exactly():
    tree = JaxRetrieval(JaxConfig(**TINY)).init_params(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["roberta"]["img_embeddings"]["mask_embedding"] = np.ones(
        (2, 16), np.float32)
    sd = params_from_jax(tree)
    back = params_to_jax(sd)
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(back)[0]] == [p for p, _ in flat(tree)[0]]
    for (_, a), (_, b) in zip(flat(back)[0], flat(tree)[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # fused QKV keeps its [q | k | v] layout, transposed to [out, in]
    qkv = tree["roberta"]["layer_1"]["attention"]["qkv"]["kernel"]
    assert np.array_equal(sd["roberta.layer.1.attention.qkv.weight"].numpy(),
                          qkv.T)
    # and the state dict loads into the port's module as it is
    model = UC2ForImageTextRetrieval(UC2Config(**TINY), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
