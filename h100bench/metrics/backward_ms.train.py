"""``forward_ms.train``, read the same way, of the port's span
``train.backward``."""

from functools import partial
from pathlib import Path

from h100bench.harness import load_reader

read = partial(load_reader(Path(__file__).with_name("forward_ms.train.py")),
               span="train.backward")
