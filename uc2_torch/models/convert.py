"""Parameters between the reference package's tree and the port's
``state_dict``.

The reference (Flax) tree is nested dicts of arrays, e.g.
``roberta/layer_0/attention/qkv/kernel`` of shape [in, out]. The port's
keys are the same path joined by dots, with ``layer_i`` as ``layer.i``,
Dense ``kernel`` as the nn.Linear ``weight`` (transposed to [out, in];
the fused QKV stays one [3H, H] matrix, [q | k | v] along the output), and
the embedding tables as ``<name>.weight``. Both directions are exact.
The full pretraining tree (``roberta``, ``cls``, ``feat_regress``,
``region_classifier``, ``itm_output``, ``nce_output``) maps the same way;
the tied LM decoder has no key of its own in either package.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

EMBEDDINGS = ("word_embeddings", "position_embeddings",
              "token_type_embeddings")


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or any array with ``__array__``)
    -> port ``state_dict`` of fp32 CPU tensors."""
    out = {}
    for path, leaf in _walk(tree):
        arr = np.asarray(leaf)
        names = list(path)
        if names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        elif names[-1] in EMBEDDINGS:
            names.append("weight")
        key = re.sub(r"(^|\.)layer_(\d+)(?=\.)", r"\1layer.\2", ".".join(names))
        out[key] = torch.tensor(arr)            # a contiguous copy
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port ``state_dict`` -> reference parameter tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        names = re.sub(r"(^|\.)layer\.(\d+)(?=\.)", r"\1layer_\2",
                       key).split(".")
        if names[-1] == "weight":
            if len(names) > 1 and names[-2] in EMBEDDINGS:
                names.pop()
            elif arr.ndim == 2:          # Dense; LayerNorm scales are 1-D
                names[-1] = "kernel"
                arr = arr.T
        node = tree
        for p in names[:-1]:
            node = node.setdefault(p, {})
        node[names[-1]] = np.ascontiguousarray(arr)
    return tree


def load_params(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Copy a reference parameter tree into ``module`` (on its device).

    The reference creates ``mask_embedding`` only for MRM runs, so a tree
    without it leaves the module's own; any other missing or unexpected
    key raises."""
    sd = params_from_jax(tree)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("mask_embedding")]
    if missing or unexpected:
        raise KeyError(f"parameter tree does not fit the module: missing "
                       f"{missing}, unexpected {unexpected}")
