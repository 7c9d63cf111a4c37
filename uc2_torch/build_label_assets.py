"""Precompute the label words' token ids, ``label_token_ids_{lang}.json``
under ``uc2_torch/assets/object_labels/`` (port of the repository's
scripts/build_label_assets.py).

    python -m uc2_torch.build_label_assets

Run it where an XLM-R tokenizer is installed (``transformers`` with the
vocabulary's files already on disk; nothing is downloaded). The files let
``LabelVocab`` take XLM-R's ids on machines without the tokenizer; without
a usable tokenizer the command exits non-zero and writes nothing.
"""

from __future__ import annotations

import json
import os
import sys

from uc2_torch.data.labels import ASSETS, LANGS, LabelVocab, try_xlmr_tokenizer


def main():
    tok = try_xlmr_tokenizer()
    if tok is None:
        sys.exit("XLM-R tokenizer unavailable (needs sentencepiece + "
                 "downloaded vocab); run elsewhere")
    vocab = LabelVocab(tokenize=tok)
    for lang in LANGS:
        path = os.path.join(ASSETS, f"label_token_ids_{lang}.json")
        with open(path, "w") as f:
            json.dump(vocab.token_ids[lang], f)
        print("wrote", path)


if __name__ == "__main__":
    main()
