"""Helpers of the distributed port tests: a free local port, spawned
processes with a time limit, and the pretraining flags both drivers'
two-process runs share. Imports nothing of JAX, so that the port's
spawned processes may import it."""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(script, args, n, tmp_path, timeout=TIMEOUT):
    """Run ``script`` as processes 0..n-1 (``script rank *args``) with the
    repository on the path and no JAX platform settings; each is killed at
    ``timeout`` seconds, so a hang fails the test. Returns their output."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, str(path), str(r)]
                              + [str(a) for a in args], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"process {r} failed (rc {p.returncode}):\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
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
