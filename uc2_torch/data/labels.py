"""Label vocabulary: the 1601 detector classes as XLM-R token ids (a copy
of uc2_tpu/data/labels.py ``LabelVocab``, ``hash_tokenize`` and
``BACKGROUND_INDEX``, with the word lists copied to
``uc2_torch/assets/object_labels/``).

Token ids come, in this order, from a caller's tokenizer, an installed
XLM-R tokenizer whose files are already on the machine, precomputed
``label_token_ids_{lang}.json`` assets, or a deterministic hash of each
word. The repository ships no XLM-R files and no such assets, so without
a tokenizer the ids are the hash's: stable, but not XLM-R's (``source``
says which was used).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets", "object_labels")
LANGS = ("en", "cs", "de", "fr", "ja", "zh")
# index of the word 'background' in the English list: detector class 0
# maps to that row, as the original data code does
BACKGROUND_INDEX = 956


def label_words(lang: str = "en") -> List[str]:
    name = ("img_label_objects.txt" if lang == "en"
            else f"img_label_objects_{lang}.txt")
    with open(os.path.join(ASSETS, name), encoding="utf-8") as f:
        return [x.strip() for x in f.readlines()]


def try_xlmr_tokenizer() -> Optional[Callable[[str], List[int]]]:
    """The XLM-R tokenizer when ``transformers`` and its files are already
    installed (never downloaded); None otherwise, and None for a tokenizer
    that maps ordinary words to its unknown token (files without the
    vocabulary: one such install holds 5 tokens, and every label word then
    became one id). Ids come through the public ``convert_tokens_to_ids``
    (the reference calls the private ``_convert_token_to_id``, which newer
    ``transformers`` releases lack; where both exist they give the same
    ids)."""
    try:
        from transformers import XLMRobertaTokenizer
        tok = XLMRobertaTokenizer.from_pretrained("xlm-roberta-base",
                                                  local_files_only=True)

        def tokenize(w):
            return list(tok.convert_tokens_to_ids(tok.tokenize(w)))
        if tok.unk_token_id in tokenize("person") + tokenize("dog"):
            return None
        return tokenize
    except Exception:
        return None


def hash_tokenize(word: str, vocab_size: int = 250002,
                  reserved: int = 4) -> List[int]:
    """Deterministic stand-in tokenizer: 1-2 pseudo-subwords per word, ids
    in [reserved, vocab_size - 1)."""
    h = hashlib.sha256(word.encode("utf-8")).digest()
    n = 1 + (h[0] % 2)
    span = vocab_size - reserved - 1
    return [reserved + int.from_bytes(h[4 * i:4 * i + 4], "little") % span
            for i in range(n)]


class LabelVocab:
    """Per-language class -> token-id lists and the valid-token projection.

    token_ids[lang]: 1601 lists of token ids (index 0 = background);
    valid_ids: the sorted union of the English lists' ids (int32);
    label2token_valid: [1601, n_valid] 0/1 float32 in valid-token space;
    source: "tokenizer", "asset" or "hash".
    """

    def __init__(self, tokenize: Optional[Callable[[str], List[int]]] = None,
                 langs: Sequence[str] = LANGS,
                 words: Optional[Dict[str, List[str]]] = None):
        """``words`` replaces the 1600-word lists (lang -> words, no
        background entry)."""
        self.langs = tuple(langs) if words is None else tuple(words.keys())
        self.token_ids: Dict[str, List[List[int]]] = {}
        self.source = "tokenizer"
        if tokenize is None:
            tokenize = try_xlmr_tokenizer()
        if tokenize is None:
            if words is None and self._load_assets():
                self.source = "asset"
            else:
                self.source = "hash"
                tokenize = hash_tokenize
        if not self.token_ids:
            get_words = (words.__getitem__ if words is not None
                         else label_words)
            for lang in self.langs:
                words_l = get_words(lang)
                if lang == "en":
                    per_class = [tokenize(w)
                                 for w in ["background"] + list(words_l)]
                else:
                    # the translated lists have no background row; class 0
                    # resolves through class_token_ids
                    per_class = [tokenize("background")] + [
                        tokenize(w) for w in words_l]
                self.token_ids[lang] = per_class

        en = self.token_ids["en"]
        valid = sorted({t for ids in en for t in ids})
        self.valid_ids = np.asarray(valid, np.int32)
        pos = {t: i for i, t in enumerate(valid)}
        mat = np.zeros((len(en), len(valid)), np.float32)
        for c, ids in enumerate(en):
            for t in ids:
                mat[c, pos[t]] = 1.0
        self.label2token_valid = mat

    def _load_assets(self) -> bool:
        for lang in self.langs:
            path = os.path.join(ASSETS, f"label_token_ids_{lang}.json")
            if not os.path.exists(path):
                self.token_ids = {}
                return False
            with open(path) as f:
                self.token_ids[lang] = json.load(f)
        return True

    def class_token_ids(self, cls_index: int, lang: str = "en") -> List[int]:
        """Token ids of detector class ``cls_index``; class 0 (background)
        takes the row of the list's word at BACKGROUND_INDEX."""
        ids = self.token_ids[lang]
        if cls_index == 0:
            bg = BACKGROUND_INDEX + 1
            return ids[bg if bg < len(ids) else 0]
        return ids[cls_index]

    def project_soft_labels(self, soft_labels: np.ndarray) -> np.ndarray:
        """[*, 1601] detector distribution -> normalised [*, n_valid]
        distribution over label-word tokens."""
        p = soft_labels.astype(np.float32) @ self.label2token_valid
        s = p.sum(-1, keepdims=True)
        return p / np.maximum(s, 1e-12)
