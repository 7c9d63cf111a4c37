"""Process-level collectives (port of uc2_tpu/parallel/multihost.py).

One process drives one GPU. ``maybe_initialize`` starts the process group
from the drivers' ``--coordinator_address/--num_processes/--process_id``
flags, or from the environment where a flag is not given
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
``torchrun`` sets them): rank 0 serves a ``torch.distributed.TCPStore`` at
the coordinator's address, every process joins it, sets its CUDA device
(``process_id % device_count``) and only then creates the group over that
store, so that NCCL's object collectives find their device.

* ``all_gather_object``, ``broadcast_object`` and ``sum_across_hosts`` are
  collectives of the group: every process calls them in the same order,
  from the main thread.
* ``kv_broadcast_object`` and ``kv_delete`` are requests to the store over
  a connection of their own, never a collective, so a prefetch thread may
  call them while the main thread runs the step: the order of the group's
  collectives stays the same on every process.

Without a group (one process, no flags) each of these is the identity.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import threading
import time
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_KV = {"store": None, "lock": threading.Lock(), "addr": None}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _resolve(coordinator_address, num_processes, process_id):
    """The flags, with the environment filling what they leave out."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    return coordinator_address, num_processes, process_id


def _device_key(device) -> str:
    """This process's card: host name and the GPU's UUID."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    uid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uid if uid is not None else device}"


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = 600.0) -> bool:
    """Start the process group when a coordinator is configured (by flag
    or environment); return whether one runs. ``backend`` None takes
    NCCL on CUDA and gloo on the CPU (the counterpart of the platform
    choice JAX makes, as ``device`` is). Called again in a process that already
    has a group (a second driver run), it checks that the world and rank
    agree and keeps the group. NCCL on a CPU device, or two NCCL ranks on
    one GPU, raise at start: ``--dist_backend gloo`` is the way to run
    them."""
    addr, world, rank = _resolve(coordinator_address, num_processes,
                                 process_id)
    if addr is None:
        if world not in (None, 1) or rank not in (None, 0):
            raise ValueError(
                f"uc2_torch: --num_processes={world} --process_id={rank} "
                f"need --coordinator_address (host:port of process 0)")
        return False
    if world is None or rank is None:
        raise ValueError("uc2_torch: --coordinator_address needs "
                         "--num_processes and --process_id")
    if not 0 <= rank < world:
        raise ValueError(f"uc2_torch: --process_id {rank} is not in "
                         f"[0, {world})")
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank) or \
                dist.get_backend() != backend:
            raise RuntimeError(
                f"uc2_torch: a process group of world "
                f"{dist.get_world_size()}, rank {dist.get_rank()}, backend "
                f"{dist.get_backend()} already runs here, not world {world}, "
                f"rank {rank}, backend {backend}")
        return True
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("uc2_torch: --dist_backend nccl needs CUDA; pass "
                         "--dist_backend gloo to train on the CPU")
    host, port = addr.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    # under torchrun the agent already serves the store at MASTER_PORT
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(host, int(port), world_size=world,
                          is_master=rank == 0 and not agent,
                          timeout=timeout, wait_for_workers=False)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        if backend == "nccl":
            # NCCL refuses two ranks on one card, and only when the first
            # collective runs; name the way out before that
            store.set(f"uc2/card/{rank}", _device_key(dev))
            keys = [store.get(f"uc2/card/{r}").decode()
                    for r in range(world)]
            # process 0 serves the store: it waits until every process
            # has read the keys, so that each can name the way out
            store.set(f"uc2/card/read/{rank}", "1")
            if rank == 0:
                store.wait([f"uc2/card/read/{r}" for r in range(world)])
            if len(set(keys)) < world:
                raise RuntimeError(
                    f"uc2_torch: {world} NCCL ranks share "
                    f"{world - len(set(keys)) + 1} GPU(s) ({keys}); NCCL "
                    f"needs one GPU a rank: pass --dist_backend gloo to "
                    f"run several ranks on one GPU")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _KV["addr"] = (host, store.port, timeout)
    return True


def shutdown() -> None:
    """Destroy the process group, the grid's groups (``mesh.init_grid``)
    and the store connection of the kv functions; nothing without one."""
    from uc2_torch.parallel.mesh import reset_grid
    reset_grid()
    if is_initialized():
        dist.destroy_process_group()
    with _KV["lock"]:
        _KV["store"] = None
        _KV["addr"] = None


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def all_gather_object(obj: Any) -> List[Any]:
    """A picklable object from every process, in rank order (the
    reference's ``all_gather_list``)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """``root``'s picklable object on every process (the reference's
    ``any_broadcast``)."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def sum_across_hosts(value: float) -> float:
    """A scalar summed over the processes."""
    return float(sum(all_gather_object(float(value))))


def _kv_store():
    """The kv functions' own connection to the group's store (its requests
    never wait behind the group's own use of the store)."""
    with _KV["lock"]:
        if _KV["store"] is None:
            if _KV["addr"] is None:
                raise RuntimeError("uc2_torch: the process group was not "
                                   "started by maybe_initialize")
            host, port, timeout = _KV["addr"]
            _KV["store"] = dist.TCPStore(host, port, is_master=False,
                                         timeout=timeout,
                                         wait_for_workers=False)
        return _KV["store"]


class Cancelled(RuntimeError):
    """A ``kv_broadcast_object`` wait given up because its ``stop`` was
    set."""


def kv_broadcast_object(key: str, obj: Any = None, root: int = 0,
                        timeout_ms: int = 600_000,
                        stop: Optional[threading.Event] = None) -> Any:
    """``root``'s small picklable object under ``key`` (unique a
    broadcast) through the store: ``root`` sets it, the others wait for it
    (raising ``Cancelled`` once ``stop`` is set: a prefetch thread that is
    closed may wait for a key that ``root`` will never write). A request
    to the store, not a collective, so it is safe on a prefetch thread."""
    if process_count() == 1:
        return obj
    store = _kv_store()
    if process_index() == root:
        store.set(key, pickle.dumps(obj))
        return obj
    deadline = time.monotonic() + timeout_ms / 1e3
    while not store.check([key]):
        if stop is not None and stop.is_set():
            raise Cancelled(f"gave up waiting for {key}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {key} from process {root} in "
                               f"{timeout_ms} ms")
        time.sleep(0.002)
    return pickle.loads(store.get(key))


def kv_delete(key: str) -> None:
    """Delete ``key`` from the store (a missing key is fine): producers of
    per-step keys retire old ones, since the store lives as long as the
    job."""
    if process_count() == 1 or _KV["addr"] is None:
        return
    _kv_store().delete_key(key)


def add_dist_flags(p) -> None:
    """The multi-host flags of every driver."""
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0's store")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend (default: nccl on "
                        "cuda, gloo on cpu)")


def start_distributed(opts, dev):
    """Join the process group that a driver's multi-host flags (or the
    environment) describe, over ``--dist_backend``, and lay it out as
    ``--n_model`` model groups (``mesh.init_grid``); returns (is_main,
    multi): whether this is process 0 and whether there are several."""
    from uc2_torch.parallel.mesh import init_grid
    maybe_initialize(opts.coordinator_address, opts.num_processes,
                     opts.process_id, backend=opts.dist_backend, device=dev)
    init_grid(getattr(opts, "n_model", 1))
    return process_index() == 0, process_count() > 1


def check_restore_agrees(restore_pending: bool) -> None:
    """Across processes a resume is all or none: every process must see
    the restore file (a shared output directory). Every process gathers
    every process's answer, so all of them raise together."""
    seen = all_gather_object(bool(restore_pending))
    if len(set(seen)) > 1:
        raise RuntimeError(
            f"restore.ckpt is visible to processes "
            f"{[r for r, v in enumerate(seen) if v]} only: a multi-process "
            f"resume needs --output_dir on a shared filesystem")


def run_cli(main_fn, opts):
    """``main_fn(opts)`` as a command runs it: the process group it starts
    is destroyed at the end."""
    try:
        return main_fn(opts)
    finally:
        shutdown()
