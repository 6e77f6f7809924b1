"""Run a function on several ranks spawned on this machine.

:func:`run_ranks` starts ``world_size`` processes with the ``spawn`` start
method, joins them into one process group on a fresh ``FileStore`` under a
temporary directory (no port to collide with other runs), calls the same
function on every rank and returns each rank's result. If a rank raises,
dies, or the group outlives ``timeout``, every rank is killed and the call
raises: nothing waits on a hung group.

The function is sent to the ranks by its import path, so it must live in an
importable module; a rank imports ``torch`` and this package only. Results
travel back pickled: return numpy arrays or plain Python values, not CUDA
tensors.

Under ``torchrun``, call :func:`.mesh.multihost_initialize` in each process
instead; this launcher is for several ranks from one caller (the tests run
gloo ranks on the CPU, ``chip_smoke.py`` gloo ranks that share one card).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import default_backend, multihost_initialize

_GRACE = 5.0  # seconds a rank may exit cleanly before its result arrives


def _rank_main(call_path: str, rank: int, world_size: int, backend: str,
               device: str, store_path: str, results,
               timeout: float) -> None:
    """One rank: join the group, run the pickled ``fn(*args)``, report,
    leave."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            # Ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        store = dist.FileStore(store_path, world_size)
        multihost_initialize(device=device, backend=backend, store=store,
                             rank=rank, world_size=world_size,
                             timeout=timeout)
        out = fn(*args)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *, backend: Optional[str] = None,
              device="cuda", timeout: float = 300.0,
              args: tuple = ()) -> List[Any]:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    spawned process in one group.

    ``backend`` defaults to the device's (:func:`.mesh.default_backend`):
    NCCL for ``"cuda"``, one rank per card, and gloo for ``"cpu"``; gloo
    with ``"cuda"`` puts every rank on ``cuda:{rank % cards}``, several to
    a card. On a CUDA device the kernels are built here first, so the ranks
    load one library instead of each compiling it. Raises ``RuntimeError``
    if a rank fails or dies, ``TimeoutError`` after ``timeout`` seconds;
    either way every rank is stopped first.
    """
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        from ..kernels import _build

        _build.library()
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ssw-ranks-")
    # The call goes through a file, not the start pipe: a rank that dies
    # while starting up then cannot leave the parent blocked on a write.
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(call_path, r, world_size, backend, str(device),
              os.path.join(tmp, "store"), results, timeout))
        for r in range(world_size)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        quiet_since: dict = {}
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks ran past {timeout} s; ranks "
                    f"{sorted(set(range(world_size)) - set(out))} had not "
                    "finished")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in out or p.exitcode is None:
                        continue
                    quiet_since.setdefault(r, now)
                    if p.exitcode != 0 or now - quiet_since[r] > _GRACE:
                        raise RuntimeError(
                            f"rank {r} exited with code {p.exitcode} and "
                            "no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
