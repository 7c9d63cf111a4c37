"""Write a small synthetic multilingual demo corpus under data/demo/ (port
of the repository's scripts/make_demo_data.py; the same stores byte for
byte).

    python -m uc2_torch.make_demo_data [ROOT]

  ROOT/en    plain captions (the mlm, itm, mrfr, mrc and vmlm tasks)
  ROOT/pair  EN-DE translation pairs with word alignments (tlm)

Then: ``python -m uc2_torch.pretrain --config config/demo_pretrain.json``.
"""

from __future__ import annotations

import os
import sys

from uc2_torch.data.synth import synth_corpus


def main(root: str = "data/demo", n_imgs: int = 64):
    en = synth_corpus(os.path.join(root, "en"), n_imgs=n_imgs,
                      txt_per_img=2, seed=1)
    pair = synth_corpus(os.path.join(root, "pair"), n_imgs=n_imgs // 2,
                        txt_per_img=2, paired=True, seed=2)
    print("demo data written:")
    for name, paths in (("en", en), ("pair", pair)):
        for k, v in paths.items():
            print(f"  {name}.{k}: {v}")
    return {"en": en, "pair": pair}


if __name__ == "__main__":
    main(*sys.argv[1:2])
