"""Visual-entailment finetuning (port of the repository's ve.py).

    python -m uc2_torch.ve --train_txt_db <txt_db> --train_img_db <img_db>
        [flags]

``python -m uc2_torch.vqa`` with three answers (contradiction,
entailment, neutral) and ``output/ve`` as the default output directory:
the same flags, ``--device`` included.
"""

from uc2_torch import vqa
from uc2_torch.config import parse_with_config
from uc2_torch.parallel.multihost import run_cli


def build_parser():
    p = vqa.build_parser()
    p.description = "UC2 visual-entailment finetuning (PyTorch/CUDA)"
    p.set_defaults(num_answer=3, output_dir="output/ve")
    return p


def main(opts):
    """``vqa.main`` with ``num_answer`` pinned to 3."""
    opts.num_answer = 3
    return vqa.main(opts)


if __name__ == "__main__":
    run_cli(main, parse_with_config(build_parser()))
