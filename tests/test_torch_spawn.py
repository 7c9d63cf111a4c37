"""tests/torch_dist_util.py's ``spawn``: gloo groups of two and four
processes meet at the store it serves and all-reduce, a port it holds
for a server of the processes' own takes that server's bind and no other,
and a failed group names each process's kind of failure."""

import socket

import pytest

from tests import torch_dist_util as U

ALL_REDUCE = r'''
import sys, torch
from uc2_torch.parallel import multihost as MH
rank, addr, world = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
assert MH.maybe_initialize(addr, world, rank, device="cpu")
x = torch.tensor([float(rank + 1)])
torch.distributed.all_reduce(x)
assert x.item() == world * (world + 1) / 2, x
MH.shutdown()
print("sum", x.item())
'''


@pytest.mark.parametrize("world", [2, 4])
def test_a_group_meets_at_the_served_store(tmp_path, world):
    outs = U.spawn(ALL_REDUCE, [U.STORE, world], world, tmp_path, timeout=60)
    assert all(f"sum {world * (world + 1) / 2}" in o for o in outs)


SERVE = r'''
import socket, sys
host, port = sys.argv[2].rsplit(":", 1)
s = socket.socket()
s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
s.bind((host, int(port)))
s.listen()
print("bound", port)
'''


def test_a_held_port_takes_its_servers_bind_only(tmp_path):
    """The port that ``COORDINATOR`` names is held: a server that sets
    ``SO_REUSEPORT`` binds it, a plain socket does not."""
    outs = U.spawn(SERVE, [U.COORDINATOR], 1, tmp_path, timeout=30)
    assert "bound" in outs[0]
    held = U._held_port()
    try:
        with pytest.raises(OSError), socket.socket() as s:
            s.bind(("127.0.0.1", held.getsockname()[1]))
    finally:
        held.close()


FAIL = r'''
import os, signal, sys, time
rank, how = int(sys.argv[1]), sys.argv[2]
print("started", rank, flush=True)
if how == "exit" and rank == 1:
    sys.exit(3)
if how == "signal" and rank == 1:
    os.kill(os.getpid(), signal.SIGKILL)
time.sleep(60)
'''


@pytest.mark.parametrize("how, kinds", [
    ("exit", ["exit code 3", "stopped: still running 1 s after process 1"]),
    ("signal", ["killed by signal 9 (SIGKILL)",
                "stopped: still running 1 s after process 1"]),
    ("sleep", ["time limit: still running after 3 s"] * 2)])
def test_a_failure_names_its_kind(tmp_path, monkeypatch, how, kinds):
    """A process that exits 3 or is killed by a signal, and processes that
    outlive the time limit, each give a message that names the kind; the
    others are stopped ``GRACE`` seconds after the first failure."""
    monkeypatch.setattr(U, "GRACE", 1)
    with pytest.raises(AssertionError) as e:
        U.spawn(FAIL, [how], 2, tmp_path, timeout=3 if how == "sleep" else 30)
    msg = str(e.value)
    for r, kind in zip((1, 0), kinds):
        assert f"process {r} of 2 failed ({kind}" in msg, msg
    assert "started 0" in msg and "started 1" in msg
