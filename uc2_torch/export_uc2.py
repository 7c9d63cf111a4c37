"""Export a port checkpoint under the original UC2 key names (port of the
repository's scripts/export_torch.py).

    python -m uc2_torch.export_uc2 model_step_200000.pt out.pt

``SRC`` is a milestone of the port's drivers (its ``state_dict``: the
fused ``qkv`` keys); ``DST`` is a state dict of fp32 tensors that the
original UC2 code, and the drivers' ``--checkpoint``, load.
"""

from __future__ import annotations

import sys

import torch

from uc2_torch.models.convert import params_to_uc2_state_dict
from uc2_torch.pretrain import load_raw_checkpoint


def main(src: str, dst: str) -> int:
    sd = params_to_uc2_state_dict(load_raw_checkpoint(src))
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, dst)
    print(f"wrote {len(sd)} tensors to {dst}")
    return len(sd)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m uc2_torch.export_uc2 SRC.pt DST.pt")
    main(sys.argv[1], sys.argv[2])
