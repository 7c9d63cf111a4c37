"""Helpers of the distributed port tests: spawned processes that meet at a
store this process serves, with a time limit, and the pretraining flags
both drivers' two-process runs share. Imports nothing of JAX, so that the
port's spawned processes may import it.

No test picks a port and frees it for a process to bind later: in that
window another test's process may take it. The port's processes join a
``TCPStore`` that ``spawn`` serves on a port the OS chose for it
(``STORE``); a process that serves a port itself (the reference's JAX
coordinator) binds one that ``spawn`` holds with ``SO_REUSEPORT`` until
the processes exit (``COORDINATOR``); a group of one in the test's own
process binds port 0."""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
# seconds the other processes may run on after one has failed
GRACE = 20
# arguments of ``spawn`` that it replaces by an address (host:port)
STORE = "<store>"
COORDINATOR = "<coordinator>"


def _held_port():
    """A socket bound to a port the OS chose, with ``SO_REUSEPORT``: no
    other socket takes the port while it is held, but a server that also
    sets the option (gRPC's, as JAX's coordinator does) may bind it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    return s


def _verdict(rc, why):
    """The kind of a process's failure, or None if it succeeded."""
    if why:
        return why
    if rc > 0:
        return f"exit code {rc}"
    if rc < 0:
        return f"killed by signal {-rc} ({signal.Signals(-rc).name})"
    return None


def spawn(script, args, n, tmp_path, timeout=TIMEOUT):
    """Run ``script`` as processes 0..n-1 (``script rank *args``) with the
    repository on the path and no JAX platform settings, and return their
    output. An argument ``STORE`` becomes the address of a store that this
    process serves until they exit, and the processes get
    ``TORCHELASTIC_USE_AGENT_STORE=True``, so that process 0 joins it as
    the others do; ``COORDINATOR`` becomes a held port (``_held_port``).
    The group has ``timeout`` seconds; once a process fails, the others
    are stopped ``GRACE`` seconds later. A failure names each process's
    kind of failure (time limit, exit code or signal) and its output."""
    work = tempfile.mkdtemp(prefix="spawn", dir=tmp_path)
    path = os.path.join(work, "worker.py")
    with open(path, "w") as f:
        f.write(script)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    store = held = None
    if STORE in args:
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False)
        env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    if COORDINATOR in args:
        held = _held_port()
    args = [f"127.0.0.1:{store.port}" if a == STORE else
            f"127.0.0.1:{held.getsockname()[1]}" if a == COORDINATOR
            else str(a) for a in args]
    logs = [open(os.path.join(work, f"out{r}.txt"), "w+b") for r in range(n)]
    procs, why = [], [None] * n
    start = time.monotonic()
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, path, str(r)] + args, env=env, cwd=ROOT,
                stdout=logs[r], stderr=subprocess.STDOUT))
        failed_at = None
        while None in (rcs := [p.poll() for p in procs]):
            now = time.monotonic()
            first = next((r for r, rc in enumerate(rcs) if rc), None)
            if first is not None and failed_at is None:
                failed_at = now
            if now - start > timeout:
                stop = f"time limit: still running after {timeout} s"
            elif failed_at is not None and now - failed_at > GRACE:
                stop = (f"stopped: still running {GRACE} s after process "
                        f"{first} failed")
            else:
                time.sleep(0.2)
                continue
            for r, p in enumerate(procs):
                if p.poll() is None:
                    why[r] = stop
                    p.kill()
                    p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if held is not None:
            held.close()
        store = None
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read().decode(errors="replace"))
        f.close()
    seconds = time.monotonic() - start
    failed = [f"process {r} of {n} failed ({kind}; the group ran "
              f"{seconds:.1f} s):\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if (kind := _verdict(p.returncode, why[r]))]
    assert not failed, "\n".join(failed)
    return outs


def pretrain_argv(meta, out):
    """tests/test_multihost_2proc.py's pretraining flags with ``--zero1``,
    from a UC2 checkpoint."""
    return [
        "--model_config", meta["model_config"], "--output_dir", out,
        "--train_datasets", json.dumps([
            {"name": "s", "language": "en", "db": [meta["txt_db"]],
             "img": [meta["img_db"]], "tasks": ["mlm", "itm"],
             "mix_ratio": [1, 1]}]),
        "--max_txt_len", "20", "--max_bb", "12", "--min_bb", "4",
        "--train_batch_size", "256", "--num_train_steps", "2",
        "--warmup_steps", "1", "--valid_steps", "0", "--save_steps", "2",
        "--log_steps", "1", "--dtype", "float32", "--seed", "0",
        "--zero1", "--checkpoint", meta["ckpt"]]
