"""Spawn a gloo world of ranks for a module fixture, one world at a time
across pytest's workers, and make a world that fails say why.

Each rank runs ``fn(rank, world, where, *args)`` in a spawned process
whose stderr goes to ``where/rank<r>.log``, with ``faulthandler`` on, so a
rank that dies of a signal leaves its Python stack there.  When the world
fails (a rank exits non-zero or the deadline passes) the error names each
rank's exit code and the tail of its log.

Worlds run one at a time: :func:`run_world` holds an ``fcntl`` lock in a
directory that every xdist worker of the session shares (the parent of
the worker's base temp directory), so no two worlds' ranks, whose gloo
collectives run in lockstep, compete for the cores; the deadline counts
from when the lock is held.  Beside the lock, ``gloo_worlds.log`` gets a
line per world: its name, the seconds it waited for the lock and the
seconds it ran.
"""
import contextlib
import faulthandler
import fcntl
import multiprocessing.connection
import os
import sys
import time
from pathlib import Path

import torch.multiprocessing as mp

TAIL_BYTES = 3000


class WorldFailed(RuntimeError):
    pass


def _rank_main(rank, fn, world, where, args):
    log = open(Path(where) / f"rank{rank}.log", "w", buffering=1)
    os.dup2(log.fileno(), 2)
    sys.stderr = log
    faulthandler.enable(log, all_threads=True)
    fn(rank, world, where, *args)


def shared_dir(tmp_path_factory):
    """A directory every xdist worker of this pytest session shares."""
    return tmp_path_factory.getbasetemp().parent


@contextlib.contextmanager
def one_world_at_a_time(lock_dir):
    with open(Path(lock_dir) / "gloo_world.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _tail(path):
    try:
        data = Path(path).read_bytes()
    except OSError:
        return "(no log)"
    return data[-TAIL_BYTES:].decode(errors="replace")


def report(where, procs, why):
    lines = [why]
    for r, p in enumerate(procs):
        lines.append(f"--- rank {r}: exit code {p.exitcode}, log tail:")
        lines.append(_tail(Path(where) / f"rank{r}.log"))
    return "\n".join(lines)


def run_world(fn, world, where, timeout_s, lock_dir, args=(), name=""):
    """Run ``fn`` on ``world`` spawned ranks over ``where`` once this
    process holds the lock in ``lock_dir``, and wait for all of them;
    raise :class:`WorldFailed` with every rank's exit code and log tail if
    one fails or ``timeout_s`` passes after the lock was taken."""
    t0 = time.monotonic()
    with one_world_at_a_time(lock_dir):
        waited = time.monotonic() - t0
        ran = _run(fn, world, where, timeout_s, args)
    with open(Path(lock_dir) / "gloo_worlds.log", "a") as f:
        f.write(f"{name or where}: waited {waited:.1f} s, ran {ran:.1f} s\n")


def _run(fn, world, where, timeout_s, args):
    ctx = mp.start_processes(_rank_main, args=(fn, world, str(where), tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    why = None
    try:
        while not all(p.exitcode is not None for p in ctx.processes):
            left = deadline - time.monotonic()
            if left <= 0:
                why = f"the gloo world took over {timeout_s} s"
                break
            bad = [r for r, p in enumerate(ctx.processes)
                   if p.exitcode is not None and p.exitcode != 0]
            if bad:
                why = f"rank {bad[0]} exited with code {ctx.processes[bad[0]].exitcode}"
                time.sleep(2)      # let the other ranks' logs catch up
                break
            live = [p.sentinel for p in ctx.processes if p.exitcode is None]
            multiprocessing.connection.wait(live, timeout=min(left, 1.0))
        if why is None:
            bad = [r for r, p in enumerate(ctx.processes) if p.exitcode != 0]
            if bad:
                why = f"rank {bad[0]} exited with code {ctx.processes[bad[0]].exitcode}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    if why is not None:
        raise WorldFailed(report(where, ctx.processes, why))
    return time.monotonic() - t0
