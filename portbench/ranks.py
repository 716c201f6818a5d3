"""Cells on more than one card: one process a card, started here.

The program's row-sharded path runs one rank a process (NCCL refuses
two ranks on one card), so a cell whose ``chips`` is more than one is
run by ``launch``: it starts ``chips`` copies of a script with
``--rank r``, each with the variables ``torch.distributed``'s ``env://``
reads (``MASTER_ADDR`` on localhost, a free ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so rank r takes card r, and
``PORTBENCH_STORE_PORT``, the port of the harness's own store
(``Group``). It relays what every rank writes to standard error, keeps
what rank 0 writes to standard output, and ends every rank
when one fails or the deadline passes: a rank left waiting in a
collective on a peer that is gone never reaches the group's timeout.
Every rank also ends with the launcher (``PR_SET_PDEATHSIG``).

``Group`` is a rank's handle on that store: the window's last epoch,
which rank 0 publishes (``harness._RankWindow``); what each rank read
about itself once the window has closed; and a flag that a rank has
freed its state. Nothing of it runs on the device.
"""

from __future__ import annotations

import ctypes
import datetime
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["launch", "Group", "STOP_KEY"]

STOP_KEY = "portbench/stop"  # /<n>: the n-th window of this launch
_GRACE_S = 5.0
_POLL_S = 0.1


def _free_ports(k: int) -> List[int]:
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _die_with_parent() -> None:
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _relay(stream, rank: int, keep: Optional[List[str]]) -> None:
    """Copy a rank's lines to this process's standard error; with
    ``keep``, keep them instead (rank 0's standard output)."""
    for line in iter(stream.readline, ""):
        if keep is not None:
            keep.append(line)
        else:
            sys.stderr.write(f"[rank {rank}] {line}")
            sys.stderr.flush()
    stream.close()


def _end(procs: Sequence[subprocess.Popen]) -> None:
    """SIGTERM to every rank still running, SIGKILL after a grace."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    t = time.monotonic()
    for p in procs:
        try:
            p.wait(timeout=max(0.1, _GRACE_S - (time.monotonic() - t)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(script: Path, argv: Sequence[str], world: int, *,
           deadline_s: float) -> Tuple[int, List[str]]:
    """Run ``world`` ranks of ``script argv --rank r``; returns (0, the
    lines rank 0 wrote to standard output) when every rank exits with 0,
    else (1, []) once every rank has ended: as soon as one fails, or when
    ``deadline_s`` has passed."""
    master, store = _free_ports(2)
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                PORTBENCH_STORE_PORT=str(store))
    procs: List[subprocess.Popen] = []

    def on_signal(signum, _frame):
        _end(procs)
        sys.exit(128 + signum)

    previous = signal.signal(signal.SIGTERM, on_signal)
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv, "--rank", str(r)],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                preexec_fn=_die_with_parent))
        out: List[str] = []
        threads = [threading.Thread(target=_relay, args=(p.stderr, r, None))
                   for r, p in enumerate(procs)]
        threads += [threading.Thread(target=_relay, args=(
            p.stdout, r, out if r == 0 else None))
            for r, p in enumerate(procs)]
        for t in threads:
            t.start()
        end = time.monotonic() + deadline_s
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is None and None not in codes:
                break
            if failed is None and time.monotonic() > end:
                failed = "deadline"
            time.sleep(_POLL_S)
        _end(procs)
        for t in threads:
            t.join()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if failed is not None:
        what = (f"rank {failed} exited with {procs[failed].returncode}"
                if failed != "deadline" else
                f"the ranks ran past {deadline_s:.0f} s")
        print(f"portbench: {what}; every rank ended", file=sys.stderr)
        return 1, []
    return 0, out


class Group:
    """A rank's place in a launch and the harness's store: rank 0 holds
    it, the others connect (``PORTBENCH_STORE_PORT``)."""

    def __init__(self, rank: int, world: int, *, timeout_s: float = 600.0):
        from torch.distributed import TCPStore
        self.rank, self.world = rank, world
        self._windows = 0
        self.store = TCPStore(
            "127.0.0.1", int(os.environ["PORTBENCH_STORE_PORT"]), world,
            is_master=rank == 0, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=timeout_s))

    def window_key(self) -> str:
        """The key of the next window's last epoch: every rank opens its
        windows in the same order."""
        self._windows += 1
        return f"{STOP_KEY}/{self._windows}"

    def post(self, what: Dict) -> None:
        """What this rank read about itself, for rank 0."""
        self.store.set(f"portbench/rank/{self.rank}", pickle.dumps(what))

    def collect(self) -> List[Dict]:
        """Rank 0: what every other rank posted, in rank order."""
        return [pickle.loads(self.store.get(f"portbench/rank/{r}"))
                for r in range(1, self.world)]

    def freed(self) -> None:
        """This rank has freed the program's state."""
        self.store.set(f"portbench/freed/{self.rank}", b"1")

    def wait_freed(self) -> None:
        """Rank 0: wait until every other rank has freed its state."""
        self.store.wait([f"portbench/freed/{r}"
                         for r in range(1, self.world)])
