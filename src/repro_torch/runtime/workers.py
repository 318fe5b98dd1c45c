"""Horizontal scale-out: a process-based worker pool over a shared spool
(the port of the reference package's ``runtime/workers.py``; one CUDA
context, on one card, a worker process).

One sweep job's flat-index space is split into contiguous chunk-range
*leases* recorded on a board file in the spool.  Worker processes
(``python -m repro_torch.runtime.workers --spool DIR [--device cuda]``)
claim leases under an ``fcntl.flock`` critical section, run the ordinary
:func:`repro_torch.core.stream.stream_grid` machinery over their range
(``flat_range=``) on their one device, and persist the range's exact
reductions as a JSON *part*; the coordinator
(:class:`repro_torch.core.service.SweepService` or any
:class:`JobHandle` holder) folds the parts into one result with
:func:`repro_torch.core.stream.merge_results` — bitwise-identical to a
single-process run, because the fold reuses the device-count-
independent carry contract of :func:`repro_torch.core.backend.
merge_device_carries`.

Lease state machine (all transitions under the board flock)::

    free ──claim──▶ leased ──complete──▶ done
      ▲               │ heartbeat stale (ttl) ──▶ reclaimed by claim
      │               │                           (attempt += 1)
      └────fail───────┘        attempt > max_attempts ──▶ failed

A worker heartbeats its lease every ``ttl / 3`` seconds; a worker that
dies (crash, SIGKILL, OOM) simply stops heartbeating and the lease is
*reclaimed* by the next claimer, which resumes from the lease's own
checkpoint directory — the per-range carry snapshot written by
``stream_grid``'s ordinary checkpoint machinery — so no finished chunk
is recomputed.  A stolen lease is also safe the other way: the old
owner notices the steal on its next heartbeat and aborts
cooperatively, and even a straggler that completes anyway writes a
byte-identical part (execution is deterministic and part writes are
atomic renames), so "done" always wins.

Spool layout (per job, keyed by the plan's content signature)::

    <spool>/jobs/<sig24>/job.json      request + pinned chunk geometry
                         board.json    lease table (atomic rewrites)
                         board.lock    flock serializing mutations
                         parts/part-<i>.json   exact range reductions
                         ckpt/<i>/     per-lease resume snapshots
                         cancel        cooperative-cancel flag file

``dispatch_job`` is idempotent by signature: re-dispatching an existing
job (service restart, duplicate submit) reattaches to the same board,
leases, parts and checkpoints — the recovery path *is* the normal path.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "DEFAULT_TTL_S",
    "DEFAULT_MAX_ATTEMPTS",
    "LeaseBoard",
    "JobHandle",
    "WorkerPool",
    "dispatch_job",
    "run_lease",
    "worker_loop",
    "main",
]

DEFAULT_TTL_S = 10.0
DEFAULT_POLL_S = 0.2
#: A lease is abandoned as ``failed`` once claimed this many times
#: without completing — the brake on crash-looping jobs.
DEFAULT_MAX_ATTEMPTS = 4
BOARD_VERSION = 1


# Heavy imports (torch via core.stream / core.service) stay lazy so the
# runtime package can export this module without paying them, and so
# the service <-> workers imports never cycle at module load.

def _stream():
    from ..core import stream as ST
    return ST


def _one_device(device):
    """The one device a plan is pinned to (raises for ``"cuda"`` without
    a card, as every entry point does)."""
    from ..core import sweep as SW
    return SW.resolve_device(device)


def _service():
    from ..core import service as SV
    return SV


def _write_json(path: str, obj) -> None:
    """Crash-safe JSON write: temp file + fsync + atomic rename, so
    readers (which read board/part files without the lock) only ever
    see complete documents."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class LeaseBoard:
    """The shared lease table of one job directory.

    Mutations (:meth:`claim` / :meth:`heartbeat` / :meth:`complete` /
    :meth:`fail`) run under ``flock(board.lock)`` and rewrite
    ``board.json`` atomically; reads (:meth:`poll`) are lock-free —
    the atomic rename guarantees a consistent document.  The board is
    process-shared state: every worker and the coordinator hold their
    own :class:`LeaseBoard` over the same directory.
    """

    def __init__(self, job_dir: str):
        self.job_dir = str(job_dir)
        self.job_path = os.path.join(self.job_dir, "job.json")
        self.board_path = os.path.join(self.job_dir, "board.json")
        self.lock_path = os.path.join(self.job_dir, "board.lock")
        self.cancel_path = os.path.join(self.job_dir, "cancel")
        self.parts_dir = os.path.join(self.job_dir, "parts")
        self._job: Optional[dict] = None

    # -- paths ----------------------------------------------------------

    def part_path(self, i: int) -> str:
        return os.path.join(self.parts_dir, f"part-{int(i)}.json")

    def ckpt_dir(self, i: int) -> str:
        return os.path.join(self.job_dir, "ckpt", str(int(i)))

    # -- documents ------------------------------------------------------

    def job(self) -> dict:
        if self._job is None:
            with open(self.job_path) as f:
                self._job = json.load(f)
        return self._job

    def read(self) -> dict:
        with open(self.board_path) as f:
            return json.load(f)

    def _write(self, board: dict) -> None:
        _write_json(self.board_path, board)

    @contextlib.contextmanager
    def _lock(self):
        with open(self.lock_path, "a+") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    # -- cancel flag ----------------------------------------------------

    def cancel(self) -> None:
        with open(self.cancel_path, "w"):
            pass

    def cancelled(self) -> bool:
        return os.path.exists(self.cancel_path)

    def clear_cancel(self) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.cancel_path)

    # -- lease transitions ----------------------------------------------

    def claim(self, wid: str, ttl: float) -> Optional[dict]:
        """Claim the lowest-index claimable lease for worker ``wid``.

        Claimable: ``free``, or ``leased`` with a heartbeat older than
        ``ttl`` seconds (the owner is presumed dead and the lease is
        *reclaimed*).  Each claim increments the lease's ``attempt``
        counter; a lease that would exceed the job's ``max_attempts``
        is marked ``failed`` instead of reissued.  Returns a copy of
        the claimed lease record, or ``None`` when nothing is
        claimable.
        """
        now = time.time()
        max_att = int(self.job().get("max_attempts", DEFAULT_MAX_ATTEMPTS))
        with self._lock():
            board = self.read()
            pick = None
            dirty = False
            for ls in board["leases"]:
                stale = (ls["state"] == "leased"
                         and now - float(ls["hb"]) > float(ttl))
                if ls["state"] != "free" and not stale:
                    continue
                if int(ls["attempt"]) >= max_att:
                    ls["state"] = "failed"
                    ls["error"] = (ls.get("error")
                                   or f"gave up after {ls['attempt']} "
                                      f"attempts")
                    dirty = True
                    continue
                pick = ls
                break
            if pick is not None:
                pick.update(state="leased", owner=os.getpid(), wid=str(wid),
                            hb=now, attempt=int(pick["attempt"]) + 1)
            if pick is not None or dirty:
                self._write(board)
            return dict(pick) if pick is not None else None

    def heartbeat(self, i: int, wid: str, frac: float = 0.0) -> bool:
        """Refresh lease ``i``'s heartbeat (and progress fraction).
        Returns ``False`` when the lease is no longer this worker's —
        stolen after a stale heartbeat, completed by a straggler race,
        or failed — which is the worker's cue to abort its range."""
        with self._lock():
            board = self.read()
            ls = board["leases"][int(i)]
            if ls["state"] != "leased" or ls["wid"] != str(wid):
                return False
            ls["hb"] = time.time()
            ls["frac"] = float(frac)
            self._write(board)
            return True

    def complete(self, i: int, wid: str, result_json: Mapping) -> None:
        """Persist lease ``i``'s exact range reductions and mark it
        ``done``.  The part file lands (atomically) *before* the state
        flips, so a ``done`` lease always has a readable part.  Done
        wins even over a steal: execution is deterministic, so a
        straggler's part is byte-identical to the thief's."""
        _write_json(self.part_path(i), dict(result_json))
        with self._lock():
            board = self.read()
            ls = board["leases"][int(i)]
            ls.update(state="done", frac=1.0, error=None)
            self._write(board)

    def fail(self, i: int, wid: str, error: str) -> None:
        """Release lease ``i`` after an execution error: back to
        ``free`` for another attempt, or ``failed`` once the attempt
        budget is spent.  No-op when the lease was stolen meanwhile."""
        max_att = int(self.job().get("max_attempts", DEFAULT_MAX_ATTEMPTS))
        with self._lock():
            board = self.read()
            ls = board["leases"][int(i)]
            if ls["state"] != "leased" or ls["wid"] != str(wid):
                return
            ls.update(
                state=("failed" if int(ls["attempt"]) >= max_att
                       else "free"),
                owner=None, wid=None, error=str(error)[:500])
            self._write(board)

    # -- coordinator reads ----------------------------------------------

    def poll(self) -> dict:
        """Lock-free job summary: overall ``fraction`` (done spans plus
        in-flight per-lease progress), ``done`` (every lease done),
        terminal ``failed`` lease records, per-state counts, and the
        raw lease list."""
        board = self.read()
        n_total = int(board["n_total"])
        folded = 0.0
        states: dict = {}
        failed = []
        done = True
        for ls in board["leases"]:
            states[ls["state"]] = states.get(ls["state"], 0) + 1
            span = int(ls["stop"]) - int(ls["start"])
            if ls["state"] == "done":
                folded += span
            elif ls["state"] == "leased":
                folded += span * float(ls.get("frac") or 0.0)
            if ls["state"] == "failed":
                failed.append(dict(ls))
            if ls["state"] != "done":
                done = False
        return {"done": done,
                "failed": failed,
                "fraction": (folded / n_total if n_total else 1.0),
                "states": states,
                "leases": board["leases"]}


# ---------------------------------------------------------------------------
# Dispatch + coordinator handle
# ---------------------------------------------------------------------------


def dispatch_job(spool: str, request, *, plan=None,
                 n_leases: Optional[int] = None,
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 checkpoint_every_steps: Optional[int] = None,
                 prefetch: Optional[int] = None,
                 device="cuda") -> "JobHandle":
    """Materialize (or reattach to) one job's lease board in ``spool``.

    ``request`` is a :class:`repro_torch.core.service.SweepRequest` (it
    must be JSON-able — workers rebuild the plan from the journaled
    request); without ``plan`` its plan is built as one shard on
    ``device``.  Lease boundaries are aligned to the plan's single-device
    dispatch
    quantum ``chunk * scan`` so every interior range stop satisfies
    :func:`~repro_torch.core.stream.stream_grid`'s ``flat_range`` alignment
    contract.  Idempotent by plan signature: an existing job directory
    (crashed coordinator, duplicate submit) is reused as-is — leases,
    parts and checkpoints intact — after clearing any stale cancel
    flag.  ``n_leases`` bounds reclaim granularity (default: up to 8,
    never more than the step count).
    """
    SV, ST = _service(), _stream()
    req = request.normalized()
    if plan is None:
        dev = _one_device(device)
        plan = ST.plan_stream(**SV.plan_kwargs(req), device=dev,
                              devices=(dev,))
    sig = plan.signature
    jobs_root = os.path.join(str(spool), "jobs")
    job_dir = os.path.join(jobs_root, sig[:24])
    os.makedirs(jobs_root, exist_ok=True)
    with open(os.path.join(jobs_root, ".dispatch.lock"), "a+") as lf:
        fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        try:
            board = LeaseBoard(job_dir)
            if os.path.exists(board.job_path):
                if board.job()["signature"] != sig:
                    raise RuntimeError(
                        f"job dir {job_dir} holds signature "
                        f"{board.job()['signature']}, expected {sig}")
                board.clear_cancel()
                return JobHandle(job_dir, plan=plan)
            os.makedirs(board.parts_dir, exist_ok=True)
            q = int(plan.chunk) * int(plan.scan)
            steps = math.ceil(plan.n_total / q)
            want = 8 if n_leases is None else int(n_leases)
            n = max(1, min(want, steps))
            leases = []
            for i in range(n):
                lo = (i * steps) // n * q
                hi = min(((i + 1) * steps) // n * q, plan.n_total)
                leases.append({"i": i, "start": lo, "stop": hi,
                               "state": "free", "owner": None, "wid": None,
                               "hb": 0.0, "attempt": 0, "frac": 0.0,
                               "error": None})
            board._write({"version": BOARD_VERSION, "signature": sig,
                          "n_total": int(plan.n_total), "quantum": q,
                          "leases": leases})
            with open(board.lock_path, "a+"):
                pass
            # job.json lands last: its presence marks a fully-built job.
            _write_json(board.job_path, {
                "version": BOARD_VERSION, "signature": sig,
                "request": req.to_json(), "n_total": int(plan.n_total),
                "chunk": int(plan.chunk), "scan": int(plan.scan),
                "n_leases": n, "max_attempts": int(max_attempts),
                "checkpoint_every_steps": checkpoint_every_steps,
                "prefetch": prefetch, "created": time.time()})
            return JobHandle(job_dir, plan=plan)
        finally:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)


class JobHandle:
    """Coordinator-side view of one dispatched job: progress polling,
    synthesized progress snapshots (running front folded from finished
    parts — same shape as the in-process executor's snapshots), cancel,
    and the final exact fold."""

    def __init__(self, job_dir: str, plan=None):
        self.board = LeaseBoard(job_dir)
        self.job_dir = str(job_dir)
        self.plan = plan
        job = self.board.job()
        self.signature = job["signature"]
        self.n_total = int(job["n_total"])
        req = _service().SweepRequest.from_json(job["request"])
        self.objectives = tuple(req.objectives)
        self._sign = np.array([-1.0 if o in req.maximize else 1.0
                               for o in self.objectives])
        self._front_v = np.zeros((0, len(self.objectives)))
        self._front_i = np.zeros((0,), np.int64)
        self._folded: set = set()
        self._parts: dict = {}

    def poll(self) -> dict:
        return self.board.poll()

    def cancel(self) -> None:
        self.board.cancel()

    def _part(self, i: int):
        if i not in self._parts:
            with open(self.board.part_path(i)) as f:
                self._parts[i] = _stream().result_from_json(json.load(f))
        return self._parts[i]

    def snapshot(self, st: Optional[Mapping] = None) -> dict:
        """Progress snapshot in the executor's
        :func:`~repro_torch.core.stream._progress_snapshot` format, with the
        running front folded (exactly) from every finished part so far.
        Mid-run ``best`` can only be pessimistic; the final result goes
        through :meth:`result` and is exact."""
        ST = _stream()
        st = self.poll() if st is None else st
        for ls in st["leases"]:
            if ls["state"] == "done" and ls["i"] not in self._folded:
                try:
                    part = self._part(int(ls["i"]))
                except (FileNotFoundError, json.JSONDecodeError):
                    continue        # part rename racing the state flip
                self._front_v, self._front_i = ST._merge_into_front(
                    self._front_v, self._front_i,
                    np.asarray(part.front_values, np.float64).reshape(
                        -1, len(self.objectives)),
                    np.asarray(part.front_indices, np.int64), self._sign)
                self._folded.add(ls["i"])
        folded = int(round(float(st["fraction"]) * self.n_total))
        return ST._progress_snapshot(folded, self.n_total, self._front_v,
                                     self._front_i, self.objectives,
                                     self._sign)

    def result(self):
        """Fold every part into one bitwise-exact
        :class:`~repro_torch.core.stream.StreamResult` (raises until the
        whole board is ``done``)."""
        st = self.poll()
        if not st["done"]:
            raise RuntimeError(
                f"job {self.signature[:12]} incomplete: {st['states']}")
        parts = [self._part(int(ls["i"])) for ls in st["leases"]]
        return _stream().merge_results(parts)


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def _plan_for_job(job: Mapping, cache: dict, device="cuda"):
    """Rebuild (and cache by signature) the job's plan inside a worker.

    Chunk geometry is pinned from ``job.json`` — not re-derived from
    the request — and the worker always runs on its one ``device`` (one
    shard), so the per-step dispatch quantum equals the lease alignment
    quantum regardless of the coordinator's device pool.  The rebuilt
    plan's signature must equal the job's (the checkpoint key and merge
    precondition); geometry or backend divergence fails loudly."""
    sig = job["signature"]
    if sig in cache:
        return cache[sig]
    SV, ST = _service(), _stream()
    dev = _one_device(device)
    req = SV.SweepRequest.from_json(job["request"])
    kw = SV.plan_kwargs(req)
    kw.update(chunk_size=int(job["chunk"]), scan_chunks=int(job["scan"]),
              device=dev, devices=(dev,))
    plan = ST.plan_stream(**kw)
    if plan.signature != sig:
        raise RuntimeError(
            f"worker rebuilt plan signature {plan.signature[:12]} != job "
            f"{sig[:12]} (got chunk={plan.chunk} scan={plan.scan}, job "
            f"pinned chunk={job['chunk']} scan={job['scan']})")
    cache[sig] = plan
    return plan


def run_lease(board: LeaseBoard, lease: Mapping, wid: str,
              ttl: float, cache: Optional[dict] = None,
              device="cuda") -> bool:
    """Execute one claimed lease on ``device``: heartbeat on a side
    thread (``ttl/3`` cadence, steal/cancel detection feeding
    ``should_stop``), stream the leased flat range with per-lease
    checkpointing (a reclaim resumes from the last carry snapshot), then
    persist the part.  Any failure (a kernel library that does not build
    or launch, a plan whose signature differs) fails the lease.  Returns
    ``True`` only when the lease completed."""
    ST = _stream()
    job = board.job()
    i = int(lease["i"])
    cache = {} if cache is None else cache
    frac = [0.0]
    halt = threading.Event()
    done = threading.Event()

    def _beat():
        while not done.wait(max(0.05, float(ttl) / 3.0)):
            if not board.heartbeat(i, wid, frac[0]) or board.cancelled():
                halt.set()
                return

    beater = threading.Thread(target=_beat, daemon=True)
    beater.start()
    try:
        kw: dict = {}
        if job.get("checkpoint_every_steps") is not None:
            kw["checkpoint_every_steps"] = int(job["checkpoint_every_steps"])
        if job.get("prefetch") is not None:
            kw["prefetch"] = int(job["prefetch"])
        plan = _plan_for_job(job, cache, device)
        res = ST.stream_grid(
            plan=plan,
            flat_range=(int(lease["start"]), int(lease["stop"])),
            checkpoint_dir=board.ckpt_dir(i),
            should_stop=halt.is_set,
            on_progress=lambda f: frac.__setitem__(0, float(f)),
            **kw)
    except Exception as e:
        done.set()
        beater.join(timeout=1.0)
        board.fail(i, wid, f"{type(e).__name__}: {e}")
        return False
    done.set()
    beater.join(timeout=1.0)
    if res.partial:
        return False        # stolen or cancelled: checkpoint keeps progress
    board.complete(i, wid, ST.result_to_json(res))
    return True


def _job_dirs(jobs_root: str) -> list:
    """Fully-dispatched job directories, oldest first (FIFO service)."""
    try:
        names = os.listdir(jobs_root)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        p = os.path.join(jobs_root, n)
        try:
            out.append((os.path.getmtime(os.path.join(p, "job.json")), p))
        except OSError:
            continue
    return [p for _, p in sorted(out)]


def worker_loop(spool: str, wid: Optional[str] = None,
                ttl: float = DEFAULT_TTL_S,
                poll_s: float = DEFAULT_POLL_S,
                once: bool = False, device="cuda") -> int:
    """The worker main loop: scan the spool's jobs oldest-first, claim
    the next lease, run it on ``device``, repeat.  With ``once=True``
    the loop exits (status 0) as soon as no lease is claimable — the
    batch-drain mode the tests and benchmarks use.  The loop also exits
    when the spool directory disappears (coordinator torn down)."""
    device = _one_device(device)
    wid = wid or f"w{os.getpid()}"
    cache: dict = {}
    jobs_root = os.path.join(str(spool), "jobs")
    while True:
        claimed = None
        for job_dir in _job_dirs(jobs_root):
            board = LeaseBoard(job_dir)
            if board.cancelled():
                continue
            try:
                lease = board.claim(wid, ttl)
            except (OSError, json.JSONDecodeError, KeyError):
                continue
            if lease is not None:
                claimed = (board, lease)
                break
        if claimed is None:
            if once:
                return 0
            if not os.path.isdir(str(spool)):
                return 1
            time.sleep(poll_s)
            continue
        run_lease(claimed[0], claimed[1], wid, ttl, cache, device)


# ---------------------------------------------------------------------------
# Pool manager (coordinator side)
# ---------------------------------------------------------------------------


def _visible_cards() -> list:
    """The cards this process may hand to its workers: its own
    ``CUDA_VISIBLE_DEVICES`` entries, else every card it sees."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env:
        return [c.strip() for c in env.split(",") if c.strip()]
    import torch
    return [str(j) for j in range(torch.cuda.device_count())]


class WorkerPool:
    """Spawn and supervise ``n`` worker subprocesses over one spool.

    Each child runs on one device, so its dispatch quantum matches the
    lease alignment: on a CUDA ``device`` worker ``i`` sees only card
    ``i % count`` of the cards this process sees (its
    ``CUDA_VISIBLE_DEVICES``) and runs on it as ``--device cuda``, one
    CUDA context a worker (on one card every worker shares card 0); on
    the CPU it gets ``--device cpu``.  Each logs to
    ``<spool>/workers/w<i>.log``.  :meth:`ensure` respawns dead workers
    (unless ``respawn=False``); :meth:`stop` drains the pool (SIGTERM,
    then SIGKILL stragglers).  Killing a worker mid-lease is safe by
    construction — that is the lease-reclaim path.
    """

    def __init__(self, spool: str, n: int, ttl_s: float = DEFAULT_TTL_S,
                 poll_s: float = 0.1, respawn: bool = True,
                 device="cuda"):
        self.device = _one_device(device)
        self.spool = str(spool)
        self.n = int(n)
        self.ttl_s = float(ttl_s)
        self.poll_s = float(poll_s)
        self.respawn = bool(respawn)
        self._log_dir = os.path.join(self.spool, "workers")
        os.makedirs(self._log_dir, exist_ok=True)
        self._procs: list = [None] * self.n
        self._stopped = False
        for i in range(self.n):
            self._spawn(i)

    def _spawn(self, i: int) -> None:
        env = dict(os.environ)
        if self.device.type == "cuda":
            cards = _visible_cards()
            env["CUDA_VISIBLE_DEVICES"] = cards[i % len(cards)]
        src = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pp = env.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        with open(os.path.join(self._log_dir, f"w{i}.log"), "ab") as log:
            self._procs[i] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.runtime.workers",
                 "--spool", self.spool,
                 "--wid", f"w{i}.{os.getpid()}",
                 "--ttl", str(self.ttl_s),
                 "--poll", str(self.poll_s),
                 "--device", self.device.type],
                env=env, stdin=subprocess.DEVNULL,
                stdout=log, stderr=subprocess.STDOUT)

    def pids(self) -> list:
        return [p.pid for p in self._procs if p is not None]

    def alive(self) -> int:
        return sum(1 for p in self._procs
                   if p is not None and p.poll() is None)

    def ensure(self) -> int:
        """Respawn any dead worker (when ``respawn``); returns the live
        count afterwards."""
        if not self._stopped and self.respawn:
            for i, p in enumerate(self._procs):
                if p is None or p.poll() is not None:
                    self._spawn(i)
        return self.alive()

    def stop(self, timeout: float = 10.0) -> None:
        self._stopped = True
        for p in self._procs:
            if p is not None and p.poll() is None:
                with contextlib.suppress(OSError):
                    p.terminate()
        deadline = time.time() + timeout
        for p in self._procs:
            if p is None:
                continue
            with contextlib.suppress(Exception):
                p.wait(timeout=max(0.0, deadline - time.time()))
            if p.poll() is None:
                with contextlib.suppress(OSError):
                    p.kill()
                with contextlib.suppress(Exception):
                    p.wait(timeout=5.0)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.workers",
        description="Sweep worker: claim chunk-range leases from a "
                    "shared spool and stream them.")
    ap.add_argument("--spool", required=True,
                    help="spool directory shared with the coordinator")
    ap.add_argument("--wid", default=None,
                    help="worker id recorded on claimed leases "
                         "(default: w<pid>)")
    ap.add_argument("--ttl", type=float, default=DEFAULT_TTL_S,
                    help="lease heartbeat time-to-live in seconds "
                         f"(default {DEFAULT_TTL_S:g})")
    ap.add_argument("--poll", type=float, default=DEFAULT_POLL_S,
                    help="idle poll interval in seconds "
                         f"(default {DEFAULT_POLL_S:g})")
    ap.add_argument("--once", action="store_true",
                    help="exit when no lease is claimable (batch drain)")
    ap.add_argument("--device", default="cuda",
                    help="device the leases run on (default cuda: card 0 "
                         "of the visible cards; 'cpu' runs the plain "
                         "PyTorch path)")
    a = ap.parse_args(argv)
    return worker_loop(a.spool, wid=a.wid, ttl=a.ttl, poll_s=a.poll,
                       once=a.once, device=a.device)


if __name__ == "__main__":
    raise SystemExit(main())
