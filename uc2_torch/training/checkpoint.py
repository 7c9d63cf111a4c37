"""Checkpoints and preemption-safe restore (port of
uc2_tpu/training/checkpoint.py).

* ``save_training_meta``: ``log/`` and ``ckpt/`` under the output
  directory and the run's flags in ``log/hps.json``.
* ``ModelSaver``: milestones ``ckpt/model_step_{N}.pt``, the name the
  original UC2 used; each holds the model's ``state_dict`` (the port's
  key names, fp32, on the CPU) written by ``torch.save``.
  ``AsyncModelSaver`` (``--async_ckpt``) copies the state to the host at
  once and writes it from a background thread; ``wait()`` joins it.
* ``TrainingRestorer``: every ``save_steps`` steps ``restore.ckpt`` (step,
  model, optimizer: the update count and AdamW's moments) with the
  previous one rotated to ``restore_backup.ckpt``, so a preemption during
  a write leaves one whole file; the hyperparameters of the first run in
  ``restore_hps.json``, checked on resume; the input stream's state
  (``MetaLoader.state_dict``) of process p in ``restore_stream_p{p}.json``,
  written before the model file and paired with it by ``global_step``.
  Across processes every process enters each save (a ZeRO-1 optimizer
  gathers its moments there) and writes its own stream file; only the
  writer (process 0) writes the rest.

Every file goes to a temporary name first and is renamed into place.
The reference's flax msgpack files are not read here.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


def host_copy(obj):
    """``obj`` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def save_file(path: str, obj: Any) -> None:
    """``torch.save`` to ``path`` through a temporary file and a rename."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_training_meta(output_dir: str, hps: Dict):
    """``log/`` and ``ckpt/`` under ``output_dir``, and ``log/hps.json``."""
    os.makedirs(os.path.join(output_dir, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "ckpt"), exist_ok=True)
    with open(os.path.join(output_dir, "log", "hps.json"), "w") as f:
        json.dump(hps, f, indent=2, default=str)


class ModelSaver:
    """Milestones: ``ckpt/model_step_{N}.pt``, the model's state dict."""

    def __init__(self, output_dir: str, prefix: str = "model_step"):
        self.dir = os.path.join(output_dir, "ckpt")
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = prefix

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step}.pt")

    def save(self, model: torch.nn.Module, step: int):
        save_file(self.path(step), host_copy(model.state_dict()))

    def wait(self):
        return


class AsyncModelSaver(ModelSaver):
    """``ModelSaver`` whose writes run in a background thread: ``save``
    copies the state to the host before it returns (later steps may change
    the parameters), one thread writes the copies in order, and ``wait``
    returns when every write is on disk (and raises the first error)."""

    def __init__(self, output_dir: str, prefix: str = "model_step"):
        super().__init__(output_dir, prefix)
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def save(self, model: torch.nn.Module, step: int):
        state = host_copy(model.state_dict())
        prev = self._threads[-1] if self._threads else None

        def write():
            if prev is not None:
                prev.join()
            try:
                save_file(self.path(step), state)
            except BaseException as e:   # raised again by wait()
                self._errors.append(e)

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._threads.append(t)

    def wait(self):
        for t in self._threads:
            t.join()
        self._threads.clear()
        if self._errors:
            raise self._errors[0]


class TrainingRestorer:
    """Preemption-safe restore with the two-file rotation and the check
    that the resumed run's hyperparameters are the first run's."""

    def __init__(self, output_dir: str, hps: Dict, save_steps: int = 200,
                 write: bool = True):
        """``write=False`` (every process but 0): the process enters each
        save, for the optimizer's gather, and writes its own stream file
        but nothing else."""
        from uc2_torch.parallel.multihost import process_index
        self.restore_path = os.path.join(output_dir, "restore.ckpt")
        self.backup_path = os.path.join(output_dir, "restore_backup.ckpt")
        self.hps_path = os.path.join(output_dir, "restore_hps.json")
        proc = process_index()
        self.stream_path = os.path.join(output_dir,
                                        f"restore_stream_p{proc}.json")
        self.stream_backup = os.path.join(
            output_dir, f"restore_stream_backup_p{proc}.json")
        self.save_steps = save_steps
        self.write = write
        self.hps = json.loads(json.dumps(hps, default=str))
        # seconds each save took (host copy and write)
        self.save_seconds: List[float] = []
        if os.path.exists(self.restore_path) or os.path.exists(
                self.backup_path):
            with open(self.hps_path) as f:
                saved = json.load(f)
            if saved != self.hps:
                changed = sorted(k for k in set(saved) | set(self.hps)
                                 if saved.get(k) != self.hps.get(k))
                raise ValueError(
                    f"hyperparameters changed across restore: {changed} "
                    f"(saved {saved}, now {self.hps})")
            self.restore_pending = True
        else:
            if write:
                os.makedirs(output_dir, exist_ok=True)
                with open(self.hps_path, "w") as f:
                    json.dump(self.hps, f)
            self.restore_pending = False

    def step(self, global_step: int, model, optimizer,
             stream: Any = None) -> None:
        if global_step % self.save_steps == 0:
            self.save(model, optimizer, global_step, stream)

    def save(self, model, optimizer, global_step: int, stream: Any = None):
        # the stream first: a preemption between the two writes leaves a
        # stream file whose global_step does not match the model file, and
        # restore_stream() then returns None (never a silent desync)
        t0 = time.perf_counter()
        if stream is not None:
            payload = json.dumps({"global_step": int(global_step),
                                  "meta": stream})
            tmp = self.stream_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            if os.path.exists(self.stream_path):
                os.replace(self.stream_path, self.stream_backup)
            os.replace(tmp, self.stream_path)
        opt_state = optimizer.state_dict()     # every process: a collective
        if not self.write:
            return
        state = {"global_step": int(global_step),
                 "model": host_copy(model.state_dict()),
                 "optimizer": host_copy(opt_state)}
        if os.path.exists(self.restore_path):
            os.replace(self.restore_path, self.backup_path)
        save_file(self.restore_path, state)
        self.save_seconds.append(time.perf_counter() - t0)

    def restore(self, model, optimizer) -> int:
        """Load the newest readable restore file into ``model`` and
        ``optimizer``; return its global step."""
        for path in (self.restore_path, self.backup_path):
            if not os.path.exists(path):
                continue
            try:
                state = torch.load(path, map_location="cpu",
                                   weights_only=True)
            except Exception:
                continue
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            return int(state["global_step"])
        raise FileNotFoundError("no restore checkpoint found")

    def restore_stream(self, expected_step: int) -> Optional[Any]:
        """The input stream's state saved with the model file of
        ``expected_step``; None if absent or from another step (a
        preemption between the two writes): the caller then replays the
        stream (``MetaLoader.fast_forward``)."""
        for path in (self.stream_path, self.stream_backup):
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    payload = json.load(f)
            except Exception:
                continue
            if int(payload.get("global_step", -1)) == int(expected_step):
                return payload["meta"]
        return None
