"""Process-group set-up and cross-process sums of metrics.

Counterpart of coocc_tpu/parallel/distributed.py (reference
tools/dist_train.sh's NCCL environment, collect_results_cpu): where JAX
wires every host into one mesh with `jax.distributed.initialize`, the port
runs one process per device and joins them with
`torch.distributed.init_process_group`. The backend is the caller's:
"nccl" between cards, "gloo" on the CPU, or between ranks that share one
card (NCCL refuses two ranks on one device); it is never chosen after a
failure.
"""
from __future__ import annotations

import importlib
import os
import pickle
import sys
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def init_method(coordinator: str) -> str:
    """A coordinator "host:port" (JAX's form) -> "tcp://host:port"; a URL
    (tcp://..., file://..., env://) as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join this process to the run's process group when it has more than
    one process; -> True when it did, False in one process (as JAX's).

    Arguments left out are read from the environment: JAX's names
    (JAX_COORDINATOR, NUM_PROCESSES, PROCESS_ID), then torchrun's
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). `backend` ("nccl" or
    "gloo") must be given when there is more than one process."""
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE") or 1
    if num_processes <= 1:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}: nccl between cards, gloo on the CPU "
                         "or for ranks that share a card")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if process_id is None:
        raise ValueError("no process id: give process_id, or set PROCESS_ID "
                         "or RANK")
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        raise ValueError("no coordinator: give host:port, or set "
                         "JAX_COORDINATOR or MASTER_ADDR and MASTER_PORT")
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=num_processes, rank=process_id)
    return True


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK where it is set, else the rank (one host)."""
    r = _env_int("LOCAL_RANK")
    if r is not None:
        return r
    return dist.get_rank() if dist.is_initialized() else 0


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def group_mean_(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group's ranks and divided by their count, in
    place (lax.pmean: psum, then / n). -> t."""
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


def allgather_metrics(local_hist, group=None, device=None):
    """A per-process confusion matrix (an integer numpy array or tensor)
    summed over the group's processes (the reference's all_reduce(SUM) of
    metric tensors, apis/test.py:242-243), in the type it came in; the
    identity in one process. A numpy array crosses on `device` (the rank's
    card under NCCL)."""
    if world_size(group) == 1:
        return local_hist
    if isinstance(local_hist, torch.Tensor):
        out = local_hist.clone()
        dist.all_reduce(out, group=group)
        return out
    t = torch.from_numpy(np.ascontiguousarray(local_hist)).to(
        device or "cpu")
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               rundir: str, args: tuple):
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend, init_method=f"file://{rundir}/store",
                            world_size=world, rank=rank)
    try:
        result = fn(*args)
        path = os.path.join(rundir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: str,
                args: tuple = ()) -> List:
    """fn(*args) in `world` new processes of this host (spawned), one a
    rank, joined in one process group of `backend` through a file store in
    a new temporary directory (no port to pick); LOCAL_RANK is each one's
    rank. Waits for every process; one that raises ends the others and
    raises here. -> each rank's return value (pickled by the rank), in rank
    order. fn must be importable by name (a module's top-level function)."""
    import torch.multiprocessing as mp
    main = sys.modules["__main__"]
    if fn.__module__ == "__main__" and getattr(main, "__spec__", None):
        # a CLI run with `python -m pkg.mod`: a spawned process does not
        # run the __main__ of a package again, so fn goes by the module's
        # import name
        fn = getattr(importlib.import_module(main.__spec__.name),
                     fn.__name__)
    with tempfile.TemporaryDirectory(prefix="coocc_dist_") as rundir:
        mp.spawn(_rank_main, args=(fn, world, backend, rundir, args),
                 nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(os.path.join(rundir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def launch(fn: Callable, args: tuple, devices: int, backend: str,
           coordinator: Optional[str] = None,
           num_processes: Optional[int] = None,
           process_id: Optional[int] = None) -> None:
    """A CLI's work fn(*args): in `devices` processes spawned on this host
    when devices > 1 (spawn_ranks); else in this process, as one rank of
    a run across hosts where num_processes (or NUM_PROCESSES, WORLD_SIZE)
    is above 1 (init_distributed), or alone."""
    if devices > 1:
        if (num_processes or _env_int("NUM_PROCESSES", "WORLD_SIZE")
                or 1) > 1:
            raise ValueError("--devices N starts the ranks of one host; a "
                             "run across hosts starts one process a rank")
        spawn_ranks(fn, devices, backend, args)
        return
    joined = init_distributed(coordinator, num_processes, process_id,
                              backend)
    try:
        fn(*args)
    finally:
        if joined:
            dist.destroy_process_group()
