"""VQA answer normalisation and the answer maps (a copy of
uc2_tpu/utils/vqa_answers.py).

The normalisation tables (contractions, number words, articles,
punctuation) are the public VQA evaluation constants. The pipeline strips
punctuation (keeping commas inside numbers), normalises digits and
articles, restores contractions, and scores an answer by the 10-choose-9
soft score (min(1, 0.3 x the annotators who gave it)).

The answer maps of multilingual VQA are copied byte for byte into
``uc2_torch/assets/ans2label/`` (``ans2label.json``,
``ans2label_ja.json``, ``ans2label_en_trans2_ja.json``,
``ans2label_ja_trans2_en.json``, ``ans2label_vg.json``);
``load_ans2label`` reads them there.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, List

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets", "ans2label")

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = {"a", "an", "the"}
_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_NUM = re.compile(r"(\d)(,)(\d)")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def get_score(occurrences: int) -> float:
    """VQA soft score: avg over 10-choose-9 annotator subsets →
    0/0.3/0.6/0.9/1.0 staircase."""
    if occurrences == 0:
        return 0.0
    if occurrences == 1:
        return 0.3
    if occurrences == 2:
        return 0.6
    if occurrences == 3:
        return 0.9
    return 1.0


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) \
                or (_COMMA_NUM.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(CONTRACTIONS.get(word, word))
    return " ".join(out)


def preprocess_answer(answer: str) -> str:
    answer = process_digit_article(process_punctuation(answer))
    return answer.replace(",", "")


def filter_answers(answers: Iterable[Dict], min_occurrence: int = 9
                   ) -> Dict[str, List]:
    """answer entries {'multiple_choice_answer', 'question_id'} → answers
    seen ≥ min_occurrence times (the original UC2 utils/vqa.py:129-149).
    """
    occurrence: Dict[str, set] = {}
    for entry in answers:
        ans = preprocess_answer(entry["multiple_choice_answer"])
        occurrence.setdefault(ans, set()).add(entry["question_id"])
    return {a: qs for a, qs in occurrence.items()
            if len(qs) >= min_occurrence}


def create_ans2label(occurrence: Dict[str, List], path: str = None
                     ) -> Dict[str, int]:
    ans2label = {a: i for i, a in enumerate(sorted(occurrence.keys()))}
    if path:
        with open(path, "w") as f:
            json.dump(ans2label, f)
    return ans2label


def compute_target(answers: List[Dict], ans2label: Dict[str, int]
                   ) -> Dict[str, List]:
    """Per-question soft target {labels, scores}
    (the original UC2 utils/vqa.py:168-200)."""
    counts = Counter(preprocess_answer(a["answer"]) for a in answers)
    labels, scores = [], []
    for ans, n in counts.items():
        if ans in ans2label:
            labels.append(ans2label[ans])
            scores.append(get_score(n))
    return {"labels": labels, "scores": scores}


def load_ans2label(name: str = "ans2label.json") -> Dict[str, int]:
    """Load a shipped answer map (the original UC2 misc/*.json)."""
    with open(os.path.join(ASSETS, name)) as f:
        return json.load(f)


# ---- visual entailment (the original UC2 utils/visual_entailment.py) ----
VE_ANS2LABEL = {"contradiction": 0, "entailment": 1, "neutral": 2}


def compute_target_ve(answers: List[str]) -> Dict[str, List]:
    """Soft target over the 3 VE classes: per-class annotator fraction
    (the original UC2 utils/visual_entailment.py:23-38)."""
    counts = Counter(answers)
    labels, scores = [], []
    for ans, n in counts.items():
        if ans in VE_ANS2LABEL:
            labels.append(VE_ANS2LABEL[ans])
            scores.append(n / len(answers))
    return {"labels": labels, "scores": scores}
