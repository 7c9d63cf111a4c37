"""XLM-R tokenizer with fairseq's id layout, for M3P-format evaluation data
(port of uc2_tpu/utils/m3p_tokenizer.py).

Ids are shifted to fairseq's layout: <s> = 0, <pad> = 1, </s> = 2,
<unk> = 3, then the sentencepiece pieces offset by one (fairseq reserves a
slot), with <mask> the last id. The training paths read precomputed ids
from the stores, so this is an offline preparation tool.

Gating, as the reference's: with a sentencepiece model path the
``sentencepiece`` package is required (ImportError without it); without
a path, a ``transformers`` XLM-R tokenizer whose files are already
installed (never downloaded) is the fallback; with neither, ``tokenize``
and ``encode`` raise RuntimeError. The fallback's ids come through the
public ``convert_tokens_to_ids``.
"""

from __future__ import annotations

from typing import List, Optional


class M3PTokenizer:
    FAIRSEQ_OFFSET = 1

    def __init__(self, spm_path: Optional[str] = None,
                 vocab_size: int = 250002):
        self.vocab_size = vocab_size
        self.bos_id = 0
        self.pad_id = 1
        self.eos_id = 2
        self.unk_id = 3
        self.mask_id = vocab_size - 1
        self.sp = None
        self._hf = None
        if spm_path is not None:
            try:
                import sentencepiece as spm
            except ImportError as e:
                raise ImportError(
                    "sentencepiece is required for M3PTokenizer with a "
                    ".model path; precompute ids offline or install it"
                ) from e
            self.sp = spm.SentencePieceProcessor()
            self.sp.Load(spm_path)
        else:
            try:
                from transformers import XLMRobertaTokenizer
                self._hf = XLMRobertaTokenizer.from_pretrained(
                    "xlm-roberta-base", local_files_only=True)
            except Exception:
                self._hf = None

    def tokenize(self, text: str) -> List[str]:
        if self.sp is not None:
            return self.sp.EncodeAsPieces(text)
        if self._hf is not None:
            return self._hf.tokenize(text)
        raise RuntimeError("no tokenizer backend available")

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        if self.sp is not None:
            out = []
            for t in tokens:
                i = self.sp.PieceToId(t)
                out.append(self.unk_id if i == self.sp.unk_id()
                           else i + self.FAIRSEQ_OFFSET)
            return out
        if self._hf is not None:
            return list(self._hf.convert_tokens_to_ids(tokens))
        raise RuntimeError("no tokenizer backend available")

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special:
            return [self.bos_id] + ids + [self.eos_id]
        return ids
