"""Task loaders, the task-mixing meta loader and the device prefetch (a copy
of uc2_tpu/data/loader.py's single-process part).

* ``TaskLoader``: one task's endless stream of collated batches (dataset,
  ``BucketBatcher``, collate), with ``next_stacked`` for accumulation
  windows and an exact ``state_dict`` round trip. Every draw is keyed on
  (seed, epoch, task name, batch count), so one seed gives the
  reference's bucket and batch schedule and the same batches bit for bit.
* ``deterministic_task_schedule`` and ``MetaLoader``: the task of each
  accumulation window is a pure function of (seed, window). Across
  processes (``sync_buckets``) each process draws from its own shard of
  the data, and every process must run the same shape each step: process
  0 draws first and publishes its batch's bucket through the process
  group's store, and the others draw a batch of that bucket (deferring
  the draws of other buckets).
* ``PrefetchLoader``: runs an iterator in a worker thread and places its
  batches on the device ahead of use (``device_put``: pinned host memory,
  ``non_blocking`` copies, fp16 region features upcast on the device).
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from uc2_torch.data.collate import BucketSpec
from uc2_torch.data.sampler import BucketBatcher


class TaskLoader:
    """One task's infinite batch stream: dataset + batcher + collate."""

    def __init__(self, name: str, dataset, buckets: Sequence[BucketSpec],
                 seed: int = 0, drop_last: bool = True, shuffle: bool = True):
        self.name = name
        self.dataset = dataset
        # the slot arrays are sized for this task's mask span
        if hasattr(dataset, "slot_budget"):
            buckets = [BucketSpec(b.txt_len, b.num_bb, b.batch_size,
                                  dataset.slot_budget(b.txt_len, b.num_bb))
                       for b in buckets]
        self.buckets = list(buckets)
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._epoch = -1
        self._iter = None
        self._draws = 0          # batches assembled in this epoch (rng key)
        self._iter_taken = 0     # draws taken from this epoch's iterator
        self._pending: List[Tuple[int, List[int]]] = []

    def _effective_dims(self) -> Tuple[List[int], List[int]]:
        ds = self.dataset
        txt_lens = [t + 2 for t in ds.txt_lens]  # + CLS/SEP
        num_bbs = [l - t for l, t in zip(ds.lens, ds.txt_lens)]
        return txt_lens, num_bbs

    def _new_epoch(self):
        self._epoch += 1
        # crc32, not hash(): str hashes differ between processes
        name_key = zlib.crc32(self.name.encode()) % (2 ** 31)
        rng = np.random.default_rng((self.seed, self._epoch, name_key))
        if hasattr(self.dataset, "new_epoch"):
            self.dataset.new_epoch(rng)
        txt_lens, num_bbs = self._effective_dims()
        batcher = BucketBatcher(txt_lens, num_bbs, self.buckets,
                                seed=self.seed + self._epoch,
                                shuffle=self.shuffle,
                                drop_last=self.drop_last)
        self._iter = batcher.epoch(self._epoch)
        self._iter_taken = 0

    def _draw(self) -> Tuple[int, List[int]]:
        if self._pending:
            return self._pending.pop(0)
        while True:
            if self._iter is None:
                self._new_epoch()
                self._draws = 0
            try:
                out = next(self._iter)
                self._iter_taken += 1
                return out
            except StopIteration:
                self._iter = None

    def _next_assignment(self, bucket: Optional[int] = None
                         ) -> Tuple[int, List[int]]:
        """The next (bucket, indices); with ``bucket``, the next draw of
        that bucket (a deferred one first), the draws of other buckets
        queued behind the pending ones."""
        if bucket is None:
            return self._draw()
        for k, (b, idx) in enumerate(self._pending):
            if b == bucket:
                return self._pending.pop(k)
        deferred = []
        epochs_seen = 0
        while True:
            if self._iter is None:
                epochs_seen += 1
                if epochs_seen >= 64:
                    raise RuntimeError(
                        f"bucket {bucket} never produced a full batch on "
                        f"this process's data shard: the bucket set and "
                        f"the shard do not fit lockstep training")
            b, idx = self._draw()
            if b == bucket:
                self._pending.extend(deferred)
                return b, idx
            deferred.append((b, idx))

    def next_batch(self, bucket: Optional[int] = None) -> Dict[str, Any]:
        bucket_idx, indices = self._next_assignment(bucket)
        return self._assemble(bucket_idx, indices)

    def skip_batch(self, bucket: Optional[int] = None) -> None:
        """Advance the stream exactly as ``next_batch`` would, without
        collating the batch."""
        self._next_assignment(bucket)
        self._draws += 1

    def _group(self, n: int, bucket: Optional[int] = None
               ) -> List[Tuple[int, List[int]]]:
        """n draws of the first draw's bucket (``bucket`` when given); the
        other draws are queued ahead of the pending ones."""
        first_b, first_idx = self._next_assignment(bucket)
        group = [(first_b, first_idx)]
        deferred = []
        epoch0 = self._epoch
        while len(group) < n:
            if self._epoch - epoch0 >= 64:
                raise RuntimeError(
                    f"bucket {first_b} produced fewer than n={n} same-shape "
                    f"batches across 64 epochs")
            b, idx = self._draw()
            # without drop_last a ragged tail of the same bucket is deferred
            if b == first_b and (self.drop_last
                                 or len(idx) == len(first_idx)):
                group.append((b, idx))
            else:
                deferred.append((b, idx))
        self._pending = deferred + self._pending
        return group

    def skip_stacked(self, n: int, bucket: Optional[int] = None) -> None:
        """``skip_batch``'s twin for ``next_stacked``."""
        group = self._group(n, bucket)   # may start an epoch (resets _draws)
        self._draws += len(group)

    def next_stacked(self, n: int, bucket: Optional[int] = None
                     ) -> Dict[str, Any]:
        """n same-bucket batches (of ``bucket`` when given) stacked along a
        new leading axis [n, B, ...], for accumulation over one shape;
        off-bucket draws are queued for later windows, so no example is
        dropped."""
        micro = [self._assemble(b, idx) for b, idx in self._group(n, bucket)]
        out: Dict[str, Any] = {}
        for k in micro[0]:
            if k in ("_bucket", "sample_size"):
                out[k] = micro[0][k]
            else:
                out[k] = np.stack([m[k] for m in micro])
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The stream state: the epoch, the cursor into its batch iterator,
        the assembly counter and the deferred draws."""
        return {
            "epoch": self._epoch,
            "draws": self._draws,
            "iter_taken": None if self._iter is None else self._iter_taken,
            "pending": [[int(b), [int(i) for i in idx]]
                        for b, idx in self._pending],
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore the state ``state_dict`` captured: replay the stored
        epoch (its dataset state too), then advance its iterator to the
        stored cursor."""
        self._pending = []
        self._iter = None
        epoch = int(sd["epoch"])
        if epoch >= 0:
            self._epoch = epoch - 1
            self._new_epoch()
            if sd["iter_taken"] is None:
                self._iter = None
            else:
                for _ in range(int(sd["iter_taken"])):
                    next(self._iter)
                self._iter_taken = int(sd["iter_taken"])
        else:
            self._epoch = -1
            self._iter_taken = 0
        self._draws = int(sd["draws"])
        self._pending = [(int(b), [int(i) for i in idx])
                         for b, idx in sd["pending"]]

    def one_epoch(self) -> Iterator[Dict[str, Any]]:
        """Every batch of exactly one fresh epoch (a validation sweep)."""
        self._pending.clear()
        self._iter = None
        self._new_epoch()
        self._draws = 0
        while True:
            try:
                b, idx = next(self._iter)
            except StopIteration:
                self._iter = None
                return
            yield self._assemble(b, idx)

    def _assemble(self, bucket_idx: int,
                  indices: List[int]) -> Dict[str, Any]:
        self._draws += 1
        rng = np.random.default_rng((self.seed, self._epoch, self._draws))
        if hasattr(self.dataset, "prefetch"):
            self.dataset.prefetch(indices)
        examples = []
        for i in indices:
            ex = self.dataset.get_example(i, rng)
            if isinstance(ex, list):  # grouped datasets
                examples.extend(ex)
            else:
                examples.append(ex)
        spec = self.buckets[bucket_idx]
        if len(examples) > spec.batch_size:
            spec = BucketSpec(spec.txt_len, spec.num_bb, len(examples),
                              spec.max_masked)
        batch = self.dataset.collate(examples, spec)
        batch["_bucket"] = bucket_idx
        if hasattr(self.dataset, "sample_size"):
            batch["sample_size"] = self.dataset.sample_size
        return batch


def deterministic_task_schedule(names: Sequence[str],
                                ratios: Sequence[float], seed: int
                                ) -> Callable[[int], str]:
    """window index -> task name, drawn from (seed, window) with the mix
    ratios."""
    p = np.asarray(ratios, np.float64)
    p = p / p.sum()
    names = list(names)

    def pick(window: int) -> str:
        rng = np.random.default_rng((seed, window))
        return names[int(rng.choice(len(names), p=p))]

    return pick


class MetaLoader:
    """Infinite (task_name, batch) stream with mix-ratio task sampling;
    ``accum_steps`` consecutive batches come from one task (one task per
    optimizer step), stacked into one [accum_steps, B, ...] batch with
    ``stack_microbatches``. ``sync_buckets``: every process of the group
    takes process 0's bucket each draw (the module's docstring)."""

    def __init__(self, loaders: Dict[str, TaskLoader],
                 ratios: Optional[Dict[str, float]] = None,
                 accum_steps: int = 1, seed: int = 0,
                 stack_microbatches: bool = False,
                 sync_buckets: bool = False):
        if not loaders:
            raise ValueError("MetaLoader needs at least one task loader")
        self.loaders = loaders
        names = list(loaders.keys())
        r = [1.0 if ratios is None else ratios.get(n, 1.0) for n in names]
        self._pick = deterministic_task_schedule(names, r, seed)
        self.accum_steps = accum_steps
        self.stack = stack_microbatches and accum_steps > 1
        self.step = 0
        # stream states of recent meta-steps, written by the consuming
        # thread (a PrefetchLoader worker runs ahead) and read at
        # checkpoint time through snapshot_for
        self._snap_lock = threading.Lock()
        self._snapshots: Dict[int, Dict[str, Any]] = {}
        self._snap_keep = 128
        self.sync_buckets = sync_buckets
        self._stop = threading.Event()
        if sync_buckets:
            # a key namespace of this run, agreed by one broadcast here (on
            # the main thread, before any prefetch): a resumed run's
            # counter starts again and must not read the last run's keys
            import uuid
            from uc2_torch.parallel import multihost as MH
            self.kv_ns = MH.broadcast_object(
                uuid.uuid4().hex[:12] if MH.process_index() == 0 else None)
        self._snapshot()

    def __iter__(self):
        return self

    def stop(self) -> None:
        """Give up a draw that waits for process 0's bucket (the consumer
        is gone: process 0 may never publish it)."""
        self._stop.set()

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step,
                "loaders": {n: ld.state_dict()
                            for n, ld in self.loaders.items()}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for n, ld in self.loaders.items():
            ld.load_state_dict(sd["loaders"][n])
        self.step = int(sd["step"])
        with self._snap_lock:
            self._snapshots.clear()
        self._snapshot()

    def _snapshot(self) -> None:
        sd = self.state_dict()
        with self._snap_lock:
            self._snapshots[self.step] = sd
            while len(self._snapshots) > self._snap_keep:
                del self._snapshots[min(self._snapshots)]

    def snapshot_for(self, meta_step: int) -> Optional[Dict[str, Any]]:
        """Stream state at the start of batch-step ``meta_step``; None if
        the consuming thread has not passed it or the ring dropped it."""
        with self._snap_lock:
            return self._snapshots.get(meta_step)

    def _synced_batch(self, loader: TaskLoader, step: int) -> Dict[str, Any]:
        """The draw of meta-step ``step`` in process 0's bucket: a request
        to the store, not a collective, so it may run on a prefetch
        thread."""
        from uc2_torch.parallel import multihost as MH
        n = self.accum_steps if self.stack else None
        key = f"uc2/bucket/{self.kv_ns}/{step}"
        if MH.process_index() == 0:
            batch = loader.next_stacked(n) if n else loader.next_batch()
            MH.kv_broadcast_object(key, int(batch["_bucket"]))
            # retire the key written 256 draws ago (the keys step by the
            # stride; readers trail by the prefetch depth at most)
            stride = self.accum_steps if self.stack else 1
            if step >= 256 * stride:
                MH.kv_delete(f"uc2/bucket/{self.kv_ns}/"
                             f"{step - 256 * stride}")
            return batch
        b = MH.kv_broadcast_object(key, stop=self._stop)
        return (loader.next_stacked(n, bucket=b) if n
                else loader.next_batch(bucket=b))

    def __next__(self) -> Tuple[str, Dict[str, Any]]:
        name = self._pick(self.step // self.accum_steps)
        loader = self.loaders[name]
        if self.sync_buckets:
            step = self.step
            self.step += self.accum_steps if self.stack else 1
            batch = self._synced_batch(loader, step)
        elif self.stack:
            self.step += self.accum_steps
            batch = loader.next_stacked(self.accum_steps)
        else:
            self.step += 1
            batch = loader.next_batch()
        self._snapshot()
        return name, batch

    def fast_forward(self, n_optimizer_steps: int) -> None:
        """Replay the stream to where an uninterrupted run would be after
        ``n_optimizer_steps`` optimizer steps, without assembling
        batches. One process only: under ``sync_buckets`` the stream
        depends on process 0's draws at run time."""
        if self.sync_buckets:
            raise RuntimeError("fast_forward replays one process's stream "
                               "only; under sync_buckets the input stream "
                               "restarts instead")
        target = n_optimizer_steps * self.accum_steps
        while self.step < target:
            loader = self.loaders[self._pick(self.step // self.accum_steps)]
            if self.stack:
                self.step += self.accum_steps
                loader.skip_stacked(self.accum_steps)
            else:
                self.step += 1
                loader.skip_batch()
        self._snapshot()


def task_batch_to_device(device) -> Callable[[Tuple[str, Dict]], Tuple]:
    """``device_put`` for a ``PrefetchLoader`` over a ``MetaLoader``:
    (task, batch) -> (task, the batch's arrays as tensors on ``device``).
    On a CUDA device each array goes through pinned host memory with a
    ``non_blocking`` copy on the current stream; fp16 arrays (the region
    features, stored fp16) are upcast to fp32 on the device. ``_bucket``
    and ``sample_size`` are dropped."""
    dev = torch.device(device)

    def put(item):
        name, batch = item
        out = {}
        for k, a in batch.items():
            if k in ("_bucket", "sample_size"):
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            else:
                t = t.to(dev)
            out[k] = t.float() if t.dtype == torch.float16 else t
        return name, out
    return put


class PrefetchLoader:
    """Wraps an iterator, running it in a worker thread with a small queue
    and (optionally) placing its items on the device ahead of use."""

    def __init__(self, it: Iterator, depth: int = 2,
                 device_put: Optional[Callable[[Any], Any]] = None):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.device_put = device_put
        self._done = object()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        # a bounded put that gives way to close()
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    break
                if self.device_put is not None:
                    item = self.device_put(item)
                if not self._put(item):
                    break
        except Exception as e:  # raised to the consumer
            self._put(e)
        self._put(self._done)

    def close(self):
        """Stop the worker thread (and a wait of the iterator's, through
        its ``stop``) and drop the buffered items."""
        self._stop.set()
        if hasattr(self.it, "stop"):
            self.it.stop()
        while self.thread.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
