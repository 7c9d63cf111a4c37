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

Loading a UC2 PyTorch checkpoint (``.pt`` keys of the original UC2, UNITER
or Hugging Face XLM-R) is the reference's conversion, copied from
uc2_tpu/models/convert.py: ``normalize_state_dict``, ``add_model_prefix``,
``filter_partial`` (``--load_embedding_only``, ``--load_layer``),
``torch_to_params`` (to a partial reference tree), ``merge_params`` (over
the model's own tree) and ``splice_early_adaptation``;
``load_partial_tree`` puts the result into a port module, and
``init_rank_from_itm`` starts a retrieval model's rank head from its ITM
head. The way back, ``params_to_uc2_state_dict`` (``python -m
uc2_torch.export_uc2``), writes a port milestone under the original UC2
key names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

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


# ------------------------------------------------ UC2 PyTorch checkpoints
def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    # torch tensor (cpu)
    return t.detach().cpu().float().numpy()


def normalize_state_dict(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Apply the reference's key normalizations:
    gamma→weight / beta→bias (model/model.py:210-220), strip the
    'roberta.bert.' double prefix (model/model.py:255-257), strip
    'module.' (DDP artifacts), and drop 'not_load.' markers' content.
    """
    out = {}
    for k, v in state_dict.items():
        if k.startswith("not_load."):
            continue
        k = re.sub(r"^module\.", "", k)
        k = re.sub(r"^roberta\.bert\.", "roberta.", k)
        k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        out[k] = _np(v)
    return out


def add_model_prefix(state_dict, prefix: str = "roberta"):
    """rename_checkpoint (pretrain.py:72-80): a bare-encoder checkpoint
    (keys like 'embeddings.*', 'encoder.*') gets the model prefix."""
    need = any(k.startswith(("embeddings.", "encoder.", "img_embeddings."))
               for k in state_dict)
    if not need:
        return state_dict
    return {(f"{prefix}.{k}" if k.startswith(
        ("embeddings.", "encoder.", "img_embeddings.", "pooler."))
        else k): v for k, v in state_dict.items()}


def filter_partial(state_dict, load_embedding_only=False,
                   load_layer: Optional[int] = None):
    """xlmr_sublayer_loading (model/model.py:24-41): keep only XLM-R
    embeddings, or only encoder layers <= load_layer."""
    if load_embedding_only:
        return {k: v for k, v in state_dict.items()
                if "roberta.embeddings" in k}
    if load_layer:
        def keep(k):
            m = re.match(r"roberta\.encoder\.layer\.(\d+)\.", k)
            return not (m and int(m.group(1)) > load_layer)
        return {k: v for k, v in state_dict.items() if keep(k)}
    return state_dict


_LN = {"weight": "weight", "bias": "bias"}


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def torch_to_params(state_dict: Dict[str, Any],
                    load_embedding_only: bool = False,
                    load_layer: Optional[int] = None,
                    strict_unused: bool = False) -> Dict[str, Any]:
    """Convert a (UC2 / UNITER / HF-XLM-R) torch state dict to a param tree.

    Returns a *partial* tree containing only the keys present in the
    checkpoint; merge over randomly initialized params with `merge_params`.
    """
    sd = normalize_state_dict(state_dict)
    sd = add_model_prefix(sd)
    sd = filter_partial(sd, load_embedding_only, load_layer)

    tree: Dict[str, Any] = {}
    qkv_parts: Dict[tuple, Dict[str, np.ndarray]] = {}
    unused = []

    for k, v in sd.items():
        # unify legacy 'bert.' root (UNITER twin, model/model.py:778+) and HF
        k = re.sub(r"^bert\.", "roberta.", k)
        k = re.sub(r"^lm_head\.", "cls.", k)  # HF XLM-R LM head naming

        m = re.match(r"roberta\.embeddings\.(.+)", k)
        if m:
            sub = m.group(1)
            if sub == "word_embeddings.weight":
                _set(tree, ("roberta", "embeddings", "word_embeddings"), v)
            elif sub == "position_embeddings.weight":
                _set(tree, ("roberta", "embeddings", "position_embeddings"), v)
            elif sub in ("new_token_type_embeddings.weight",
                         "token_type_embeddings.weight"):
                _set(tree, ("roberta", "token_type_embeddings"), v)
            elif sub.startswith("LayerNorm."):
                _set(tree, ("roberta", "embeddings", "LayerNorm",
                            sub.split(".")[1]), v)
            elif sub == "position_ids":
                pass  # HF buffer, not a parameter
            else:
                unused.append(k)
            continue

        m = re.match(r"roberta\.img_embeddings\.(.+)", k)
        if m:
            sub = m.group(1)
            if sub == "mask_embedding.weight":
                _set(tree, ("roberta", "img_embeddings", "mask_embedding"), v)
            else:
                mod, leaf = sub.rsplit(".", 1)
                if leaf == "weight" and v.ndim == 2:
                    _set(tree, ("roberta", "img_embeddings", mod, "kernel"),
                         v.T)
                else:
                    name = "bias" if leaf == "bias" else leaf
                    _set(tree, ("roberta", "img_embeddings", mod, name), v)
            continue

        m = re.match(r"roberta\.encoder\.layer\.(\d+)\.(.+)", k)
        if m:
            i, sub = int(m.group(1)), m.group(2)
            layer = f"layer_{i}"
            qm = re.match(r"attention\.self\.(query|key|value)\.(weight|bias)",
                          sub)
            if qm:
                qkv_parts.setdefault(("roberta", layer),
                                     {})[f"{qm.group(1)}.{qm.group(2)}"] = v
            elif sub.startswith("attention.output.dense."):
                leaf = sub.split(".")[-1]
                _set(tree, ("roberta", layer, "attention_output_dense",
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            elif sub.startswith("attention.output.LayerNorm."):
                _set(tree, ("roberta", layer, "attention_output_LayerNorm",
                            sub.split(".")[-1]), v)
            elif sub.startswith("intermediate.dense."):
                leaf = sub.split(".")[-1]
                _set(tree, ("roberta", layer, "intermediate_dense",
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            elif sub.startswith("output.dense."):
                leaf = sub.split(".")[-1]
                _set(tree, ("roberta", layer, "output_dense",
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            elif sub.startswith("output.LayerNorm."):
                _set(tree, ("roberta", layer, "output_LayerNorm",
                            sub.split(".")[-1]), v)
            else:
                unused.append(k)
            continue

        m = re.match(r"roberta\.pooler\.dense\.(weight|bias)", k)
        if m:
            leaf = m.group(1)
            _set(tree, ("roberta", "pooler", "dense",
                        "kernel" if leaf == "weight" else "bias"),
                 v.T if leaf == "weight" else v)
            continue

        # ----- heads -----
        m = re.match(r"cls\.(.+)", k)
        if m:
            sub = m.group(1)
            # UNITER BertOnlyMLMHead: cls.predictions.transform.dense /
            # .transform.LayerNorm / .bias / .decoder  (model/layer.py:205-233)
            sub = sub.replace("predictions.transform.", "")
            sub = sub.replace("predictions.", "")
            sub = sub.replace("LayerNorm.", "layer_norm.")
            if sub.startswith("decoder."):
                continue  # tied to word embeddings (decoder.bias dup of bias)
            if sub == "bias":
                _set(tree, ("cls", "bias"), v)
            elif sub.startswith("dense."):
                leaf = sub.split(".")[-1]
                _set(tree, ("cls", "dense",
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            elif sub.startswith("layer_norm."):
                _set(tree, ("cls", "layer_norm", sub.split(".")[-1]), v)
            else:
                unused.append(k)
            continue

        if k.startswith("vis_cls."):
            continue  # constructed but unused in reference forwards (§2.1)

        m = re.match(r"feat_regress\.(.+)", k)
        if m:
            sub = m.group(1)
            if sub == "weight":
                continue  # tied: transpose of img_linear
            if sub == "bias":
                _set(tree, ("feat_regress", "bias"), v)
            elif sub.startswith("net.0."):
                leaf = sub.split(".")[-1]
                _set(tree, ("feat_regress", "dense",
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            elif sub.startswith("net.2."):
                _set(tree, ("feat_regress", "layer_norm", sub.split(".")[-1]),
                     v)
            continue

        m = re.match(r"region_classifier\.net\.(\d)\.(weight|bias)", k)
        if m:
            idx, leaf = int(m.group(1)), m.group(2)
            name = {0: "dense", 2: "layer_norm", 3: "out"}[idx]
            if name == "layer_norm":
                _set(tree, ("region_classifier", name, leaf), v)
            else:
                _set(tree, ("region_classifier", name,
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            continue

        m = re.match(r"(itm_output|rank_output)\.(weight|bias)", k)
        if m:
            head, leaf = m.group(1), m.group(2)
            _set(tree, (head, "out", "kernel" if leaf == "weight" else "bias"),
                 v.T if leaf == "weight" else v)
            continue

        m = re.match(r"vqa_output\.(\d)\.(weight|bias)", k)
        if m:
            idx, leaf = int(m.group(1)), m.group(2)
            name = {0: "dense", 2: "layer_norm", 3: "out"}[idx]
            if name == "layer_norm":
                _set(tree, ("vqa_output", name, leaf), v)
            else:
                _set(tree, ("vqa_output", name,
                            "kernel" if leaf == "weight" else "bias"),
                     v.T if leaf == "weight" else v)
            continue

        unused.append(k)

    # pack fused qkv
    for (root, layer), parts in qkv_parts.items():
        if len(parts) == 6:
            kernel = np.concatenate([parts["query.weight"].T,
                                     parts["key.weight"].T,
                                     parts["value.weight"].T], axis=1)
            bias = np.concatenate([parts["query.bias"], parts["key.bias"],
                                   parts["value.bias"]])
            _set(tree, (root, layer, "attention", "qkv", "kernel"), kernel)
            _set(tree, (root, layer, "attention", "qkv", "bias"), bias)

    if strict_unused and unused:
        raise ValueError(f"unconverted checkpoint keys: {unused[:20]}")
    return tree


def merge_params(init_params: Dict[str, Any],
                 loaded: Dict[str, Any],
                 path: str = "") -> Dict[str, Any]:
    """Overlay loaded leaves onto an initialized tree (shape-checked)."""
    out = {}
    for k, v in init_params.items():
        if k in loaded:
            lv = loaded[k]
            if isinstance(v, dict):
                out[k] = merge_params(v, lv, f"{path}/{k}")
            else:
                if tuple(np.shape(lv)) != tuple(np.shape(v)):
                    raise ValueError(
                        f"shape mismatch at {path}/{k}: "
                        f"ckpt {np.shape(lv)} vs model {np.shape(v)}")
                out[k] = np.asarray(lv, dtype=np.float32)
        else:
            out[k] = v
    return out


def splice_early_adaptation(params, adaptation_state_dict):
    """'Early adaptation' splice: load a separately-trained vision-to-word
    linear into img_embeddings.img_linear (reference pretrain.py:438-441)."""
    sd = normalize_state_dict(adaptation_state_dict)
    w = sd.get("img_linear.weight", sd.get("weight"))
    b = sd.get("img_linear.bias", sd.get("bias"))
    tgt = params["roberta"]["img_embeddings"]["img_linear"]
    if w is not None:
        tgt["kernel"] = np.asarray(w).T.astype(np.float32)
    if b is not None:
        tgt["bias"] = np.asarray(b).astype(np.float32)
    return params


def load_partial_tree(module: torch.nn.Module, loaded: Dict[str, Any]) -> None:
    """Overlay a partial reference tree (``torch_to_params``'s output) on
    ``module``'s own parameters, shape-checked; the leaves it lacks keep
    their values."""
    load_params(module, merge_params(params_to_jax(module.state_dict()),
                                     loaded))


def params_to_uc2_state_dict(state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, np.ndarray]:
    """A port ``state_dict`` (a milestone: fused ``qkv`` keys) -> a state
    dict under the original UC2 key names (numpy values): the fused
    ``qkv`` split into ``query``, ``key`` and ``value``, kernels transposed
    to [out, in], the tied LM decoder and region regressor written out.
    The reference's ``params_to_torch_state_dict`` over ``params_to_jax``."""
    params = params_to_jax(state_dict)
    sd: Dict[str, np.ndarray] = {}
    root = params.get("roberta", {})

    def put(k, v):
        sd[k] = np.asarray(v)

    if "token_type_embeddings" in root:
        put("roberta.embeddings.new_token_type_embeddings.weight",
            root["token_type_embeddings"])
    emb = root.get("embeddings", {})
    for k, leaf in (("word_embeddings", "word_embeddings"),
                    ("position_embeddings", "position_embeddings")):
        if leaf in emb:
            put(f"roberta.embeddings.{k}.weight", emb[leaf])
    if "LayerNorm" in emb:
        put("roberta.embeddings.LayerNorm.weight", emb["LayerNorm"]["weight"])
        put("roberta.embeddings.LayerNorm.bias", emb["LayerNorm"]["bias"])

    ie = root.get("img_embeddings", {})
    for mod, tree in ie.items():
        if mod == "mask_embedding":
            put("roberta.img_embeddings.mask_embedding.weight", tree)
        elif "kernel" in tree:
            put(f"roberta.img_embeddings.{mod}.weight",
                np.asarray(tree["kernel"]).T)
            put(f"roberta.img_embeddings.{mod}.bias", tree["bias"])
        else:
            put(f"roberta.img_embeddings.{mod}.weight", tree["weight"])
            put(f"roberta.img_embeddings.{mod}.bias", tree["bias"])

    i = 0
    while f"layer_{i}" in root:
        lt = root[f"layer_{i}"]
        base = f"roberta.encoder.layer.{i}"
        qkv = np.asarray(lt["attention"]["qkv"]["kernel"])
        qb = np.asarray(lt["attention"]["qkv"]["bias"])
        H = qkv.shape[0]
        for j, name in enumerate(("query", "key", "value")):
            put(f"{base}.attention.self.{name}.weight",
                qkv[:, j * H:(j + 1) * H].T)
            put(f"{base}.attention.self.{name}.bias", qb[j * H:(j + 1) * H])
        put(f"{base}.attention.output.dense.weight",
            np.asarray(lt["attention_output_dense"]["kernel"]).T)
        put(f"{base}.attention.output.dense.bias",
            lt["attention_output_dense"]["bias"])
        for src, dst in (("attention_output_LayerNorm",
                          "attention.output.LayerNorm"),
                         ("output_LayerNorm", "output.LayerNorm")):
            put(f"{base}.{dst}.weight", lt[src]["weight"])
            put(f"{base}.{dst}.bias", lt[src]["bias"])
        put(f"{base}.intermediate.dense.weight",
            np.asarray(lt["intermediate_dense"]["kernel"]).T)
        put(f"{base}.intermediate.dense.bias",
            lt["intermediate_dense"]["bias"])
        put(f"{base}.output.dense.weight",
            np.asarray(lt["output_dense"]["kernel"]).T)
        put(f"{base}.output.dense.bias", lt["output_dense"]["bias"])
        i += 1

    if "pooler" in root:
        put("roberta.pooler.dense.weight",
            np.asarray(root["pooler"]["dense"]["kernel"]).T)
        put("roberta.pooler.dense.bias", root["pooler"]["dense"]["bias"])

    if "cls" in params:
        cls = params["cls"]
        put("cls.dense.weight", np.asarray(cls["dense"]["kernel"]).T)
        put("cls.dense.bias", cls["dense"]["bias"])
        put("cls.layer_norm.weight", cls["layer_norm"]["weight"])
        put("cls.layer_norm.bias", cls["layer_norm"]["bias"])
        put("cls.bias", cls["bias"])
        if "word_embeddings" in emb:  # tied decoder
            put("cls.decoder.weight", emb["word_embeddings"])
    if "feat_regress" in params:
        fr = params["feat_regress"]
        put("feat_regress.net.0.weight", np.asarray(fr["dense"]["kernel"]).T)
        put("feat_regress.net.0.bias", fr["dense"]["bias"])
        put("feat_regress.net.2.weight", fr["layer_norm"]["weight"])
        put("feat_regress.net.2.bias", fr["layer_norm"]["bias"])
        put("feat_regress.bias", fr["bias"])
        if "img_linear" in ie:  # tied
            put("feat_regress.weight", np.asarray(
                ie["img_linear"]["kernel"]).T)
    if "region_classifier" in params:
        rc = params["region_classifier"]
        put("region_classifier.net.0.weight",
            np.asarray(rc["dense"]["kernel"]).T)
        put("region_classifier.net.0.bias", rc["dense"]["bias"])
        put("region_classifier.net.2.weight", rc["layer_norm"]["weight"])
        put("region_classifier.net.2.bias", rc["layer_norm"]["bias"])
        put("region_classifier.net.3.weight",
            np.asarray(rc["out"]["kernel"]).T)
        put("region_classifier.net.3.bias", rc["out"]["bias"])
    for head in ("itm_output", "rank_output"):
        if head in params:
            put(f"{head}.weight", np.asarray(params[head]["out"]["kernel"]).T)
            put(f"{head}.bias", params[head]["out"]["bias"])
    if "vqa_output" in params:
        vq = params["vqa_output"]
        put("vqa_output.0.weight", np.asarray(vq["dense"]["kernel"]).T)
        put("vqa_output.0.bias", vq["dense"]["bias"])
        put("vqa_output.2.weight", vq["layer_norm"]["weight"])
        put("vqa_output.2.bias", vq["layer_norm"]["bias"])
        put("vqa_output.3.weight", np.asarray(vq["out"]["kernel"]).T)
        put("vqa_output.3.bias", vq["out"]["bias"])
    return sd


@torch.no_grad()
def init_rank_from_itm(model: torch.nn.Module) -> None:
    """The retrieval model's rank head set to its ITM head's "match" row
    (the reference's ``init_rank_from_itm``: its ``kernel[:, 1:2]`` is
    the port's ``weight[1:2]``)."""
    itm, rank = model.itm_output.out, model.rank_output.out
    rank.weight.copy_(itm.weight[1:2])
    rank.bias.copy_(itm.bias[1:2])


# ------------------------------------------------- tensor-parallel shards
# The reference's ``_RULES`` (uc2_tpu/parallel/mesh.py) on the port's key
# names: QKV and the FFN's first dense column-parallel, the attention
# output and the FFN's second dense row-parallel, the word table and the
# LM head's bias vocab-sharded; every other parameter replicated.
_TP_RULES = (
    (re.compile(r"attention\.qkv\.(weight|bias)$"), "qkv"),
    (re.compile(r"attention_output_dense\.weight$"), "row"),
    (re.compile(r"intermediate_dense\.(weight|bias)$"), "col"),
    (re.compile(r"(^|\.)output_dense\.weight$"), "row"),
    (re.compile(r"embeddings\.word_embeddings\.weight$"), "vocab"),
    (re.compile(r"^cls\.bias$"), "vocab"),
)


def tp_kind(key: str) -> Optional[str]:
    """How parameter ``key`` is split over a model group: "qkv" (the
    fused [3H, ...] rows, head-aligned: a process owns [q_h | k_h | v_h]
    of its heads), "col" (rows, [out, in]'s outputs), "row" (columns, the
    inputs), "vocab" (rows of the vocabulary, ``vocab_range``), or None
    (replicated)."""
    for pat, kind in _TP_RULES:
        if pat.search(key):
            return kind
    return None


def vocab_range(V: int, m: int, T: int):
    """(lo, hi): the rows of a vocabulary of ``V`` that process ``m`` of
    ``T`` owns, ceil(V / T) a process and the rest on the last (no padded
    rows exist: they would need masking out of every logit)."""
    size = -(-V // T)
    lo = min(m * size, V)
    return lo, min(lo + size, V)


def shard_tensor(t: torch.Tensor, kind: str, m: int, T: int) -> torch.Tensor:
    """Process ``m`` of ``T``'s shard of the whole tensor ``t`` (a
    contiguous copy)."""
    if kind == "qkv":
        three = t.reshape(3, T, t.shape[0] // (3 * T), *t.shape[1:])
        return three[:, m].reshape(-1, *t.shape[1:]).clone()
    if kind == "vocab":
        lo, hi = vocab_range(t.shape[0], m, T)
        return t[lo:hi].clone()
    axis = {"col": 0, "row": 1}[kind]
    if t.shape[axis] % T:
        raise ValueError(f"{T} processes do not divide dimension {axis} of "
                         f"{tuple(t.shape)}")
    return t.chunk(T, dim=axis)[m].clone()


def gather_tensors(pieces, kind: str) -> torch.Tensor:
    """The whole tensor from every process's shard, in order: the inverse
    of ``shard_tensor``, exactly."""
    if kind == "qkv":
        rest = pieces[0].shape[1:]
        return torch.cat([p.reshape(3, -1, *rest) for p in pieces],
                         dim=1).reshape(-1, *rest)
    return torch.cat(list(pieces), dim=1 if kind == "row" else 0)


def shard_state_dict(full: Dict[str, torch.Tensor], m: int,
                     T: int) -> Dict[str, torch.Tensor]:
    """Process ``m`` of ``T``'s state dict: each sharded entry cut
    (``tp_kind``), the others as they are."""
    return {k: (shard_tensor(v, tp_kind(k), m, T) if tp_kind(k) else v)
            for k, v in full.items()}


def gather_state_dict(shards) -> Dict[str, torch.Tensor]:
    """The whole state dict from the ``T`` processes' state dicts, in
    order (the replicated entries are taken from the first)."""
    return {k: (gather_tensors([s[k] for s in shards], tp_kind(k))
                if tp_kind(k) else v) for k, v in shards[0].items()}
