"""Random streams of a training step and the eager dropout.

``F.dropout`` takes no generator, so the port draws its masks itself:
``torch.rand(..., generator=rng.device) >= rate`` on the tensor's device,
kept values divided by ``1 - rate`` as flax's ``nn.Dropout`` does. The
training attention kernels take a 32-bit seed per layer instead; those
seeds come from a separate CPU generator (``rng.host``), so drawing them
never reads a value back from the card.
"""

from __future__ import annotations

import torch

from uc2_torch import resolve_device


class DropoutRng:
    """The two generators of one training run, both from ``seed``:
    ``device`` draws masks on ``device`` (CUDA unless the caller asks for
    the CPU); ``host`` draws kernel seeds on the CPU."""

    def __init__(self, seed: int, device="cuda"):
        dev = resolve_device(device)
        self.device = torch.Generator(device=dev).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed + 0x9E3779B9)

    def get_state(self):
        """Both generators' states, for ``set_state``."""
        return self.device.get_state(), self.host.get_state()

    def set_state(self, state):
        self.device.set_state(state[0])
        self.host.set_state(state[1])

    def kernel_seed(self) -> int:
        """A seed in [0, 2^31 - 1), as the reference draws one per layer
        (uc2_tpu/ops/attention.py:114)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


def dropout(x, rate: float, rng):
    """x with each element dropped with probability ``rate`` and the rest
    divided by 1 - rate; x itself when ``rng`` is None or rate is 0."""
    if rng is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
