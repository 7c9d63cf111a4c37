"""What the drivers share: the port's config from a configuration file,
the benchmark's weights put into the port's model, the device's name and
peak memory."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from h100bench.frozen.generators import make_weights
from h100bench.reference.model import set_fp32_products


class ModelDriver:
    """Base of a driver of one entry of the port: ``setup``, ``window``,
    ``traced_slice``, ``free`` and ``check`` in that order (see
    ``harness.run_cell``)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.shapes = None
        self._t = time.perf_counter()

    def mark(self, what: str):
        """Print the seconds since the last mark (set-up's parts)."""
        now = time.perf_counter()
        print(f"h100bench: {what} {now - self._t:.3f} s", file=sys.stderr)
        self._t = now

    def port_config(self, **kw):
        """The port's ``UC2Config`` of the configuration file, with the
        traffic's ``port`` settings (its attention route) and ``kw``."""
        from uc2_torch.config import UC2Config
        return UC2Config.from_dict({**self.cfg, **self.traffic.get("port", {}),
                                    **kw})

    def load(self, model):
        """``model`` with the benchmark's weights (``weights``) in place of
        its own initialisation."""
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        w = self.weights()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(w[n])
        return model

    def weights(self) -> Dict[str, torch.Tensor]:
        """The run's fp32 weights, drawn again from the seed on the device:
        what the port was given, for the reference."""
        return make_weights(self.shapes, self.seed, self.device)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_reserved(self.device)) if self.cuda \
            else 0

    def device_info(self) -> Dict:
        if self.cuda:
            return {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(self.device),
                    "count": 1}
        return {"platform": "cpu", "kind": "cpu", "count": 1}

    def free(self):
        """Drop the port's state; the reference runs next, with fp32
        products (no TF32)."""
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        set_fp32_products()

    def faults(self) -> Dict:
        """Readings of planted faults the check must catch (calibration
        only)."""
        return {}
