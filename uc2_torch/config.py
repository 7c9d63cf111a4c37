"""Model configuration: ``UC2Config``, the same fields and JSON loading as
``uc2_tpu/config.py`` so one config file drives both packages, and the
drivers' ``parse_with_config``."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Optional

IMG_DIM = 2048
IMG_LABEL_DIM = 1601


@dataclasses.dataclass(frozen=True)
class UC2Config:
    """Architecture config of the single-stream vision-language encoder.

    Defaults are uc2-base (XLM-R vocab, 514 positions, embedding LayerNorm
    eps 1e-5, pad token 1). The in-block and region-head LayerNorms use
    ``block_layer_norm_eps`` (1e-12, hardcoded in the reference model).

    ``dtype`` is the activation dtype ("bfloat16" on the card, "float32"
    for parity tests); parameters stay float32. ``use_pallas_attention``
    keeps the reference package's values: False/"xla" runs the eager
    PyTorch chain, True/"pallas" routes through the hand-written kernels
    (``ops/flash_attention.py``, ``ops/fused_block.py``) at the shapes the
    gates pick, "pallas-train" also keeps training attention on the
    training kernels at dropout 0, "fused-force" forces both fused blocks
    in every inference layer, "flash" runs the counterpart of jax's
    library TPU kernel (``ops/segment_flash.py``) at L >= 128 wherever
    attention has no dropout (inference, and training at attention
    dropout 0). ``remat`` ("none", "full", "dots") recomputes each layer
    of a training call in the backward; ``quant="int8"`` is the serving
    path of the four products of every layer (``ops/int8.py``; a training
    call under it raises). See ``models/encoder.py``.
    """

    vocab_size: int = 250002
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    block_layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    img_dim: int = IMG_DIM
    img_label_dim: int = IMG_LABEL_DIM
    # "xlmr": position ids from the pad mask; "bert": plain arange
    position_style: str = "xlmr"
    dtype: str = "bfloat16"
    use_pallas_attention: Any = True
    remat: str = "none"
    quant: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UC2Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json_file(cls, path: str) -> "UC2Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "UC2Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def parse_with_config(parser, argv: Optional[list] = None):
    """argparse with ``--config file.json``: the file's keys fill every flag
    not given on the command line (the CLI wins), as the reference's
    ``parse_with_config``. Keys starting with "_" (comments) are dropped."""
    args = parser.parse_args(argv)
    if getattr(args, "config", None):
        with open(args.config, "r", encoding="utf-8") as f:
            config_args = json.load(f)
        override_keys = {
            arg[2:].split("=")[0]
            for arg in (argv if argv is not None else sys.argv[1:])
            if arg.startswith("--")
        }
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    if hasattr(args, "conf_th") and hasattr(args, "num_bb"):
        for k in [k for k in vars(args) if k.startswith("_")]:
            delattr(args, k)
    return args
