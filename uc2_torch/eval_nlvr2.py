"""NLVR2 accuracy and consistency of a prediction CSV (port of the
repository's scripts/eval_nlvr2.py, the official scorer's interface).

    python -m uc2_torch.eval_nlvr2 predictions.csv annotations.jsonl

``predictions.csv`` has rows ``identifier,true|false`` (what
``python -m uc2_torch.nlvr2 --pred_csv`` writes); ``annotations.jsonl`` has
one ``{"identifier": ..., "label": ...}`` object a line. Prints
``accuracy=...`` and ``consistency=...``; exits 1, listing up to 20 of
them, when an annotated identifier has no prediction.
"""

import csv
import json
import sys

from uc2_torch.evalu.itm_metrics import nlvr2_eval


def main(pred_csv: str, ann_jsonl: str):
    predictions = {}
    with open(pred_csv) as f:
        for row in csv.reader(f):
            if row:
                predictions[row[0]] = row[1].lower()
    labels = {}
    with open(ann_jsonl) as f:
        for line in f:
            if line.strip():
                ex = json.loads(line)
                labels[ex["identifier"]] = ex["label"].lower()
    missing = [k for k in labels if k not in predictions]
    if missing:
        print(f"Some predictions are missing! ({len(missing)})")
        for m in missing[:20]:
            print("Missing prediction for item", m)
        sys.exit(1)
    out = nlvr2_eval({k: predictions[k] for k in labels}, labels)
    print("accuracy=" + str(out["acc"]))
    print("consistency=" + str(out["consistency"]))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
