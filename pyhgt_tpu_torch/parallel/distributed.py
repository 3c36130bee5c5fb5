"""Multi-process bootstrap.

Counterpart of :mod:`pyhgt_tpu.parallel.distributed`. The JAX wrapper
reads a coordinator address from the environment and starts
``jax.distributed``; here every rank is one process driving one device,
and :func:`initialize` reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and starts ``torch.distributed``. In a single process it
starts nothing.

The backend is always the caller's choice: ``nccl`` (the default on a GPU)
or ``gloo`` (the CPU's, and the only one that lets several ranks share one
card: NCCL refuses two ranks on one device). Nothing here picks another
backend, or the CPU, without being asked.

:func:`spawn` runs a function in a world of worker processes started here
(``torch.multiprocessing``, spawn), each with its process group already
made, and returns what each rank returned; the tests and the smoke run use
it where ``torchrun`` would be a subprocess too many.
"""

from __future__ import annotations

import os
import socket
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def local_device(device=None, local_rank: Optional[int] = None
                 ) -> torch.device:
    """The device of the rank with ``local_rank`` (default: ``LOCAL_RANK``):
    ``cuda:<local_rank % device_count>`` unless ``device`` asks for the
    CPU. Without a GPU and without that request it raises."""
    from pyhgt_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def check_backend(backend: str, device: torch.device,
                  local_world: int) -> None:
    """Raise on a backend that cannot serve ``local_world`` ranks on this
    host's ``device`` type."""
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend {backend!r} not in {BACKENDS}")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; pass "
                         "--dist_backend gloo to run on the CPU")
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(
            f"nccl cannot put {local_world} ranks on {cards} card(s) of "
            "this host (NCCL refuses two ranks on one device); pass "
            "--dist_backend gloo to share the card(s)")


def initialize(backend: Optional[str] = None, device=None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> dict:
    """Start ``torch.distributed`` when the environment (or the arguments)
    describe a world of more than one process, and place this rank on its
    device (:func:`local_device`). ``backend`` defaults to ``nccl`` on a
    GPU and ``gloo`` on the CPU; the rendezvous is torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``.

    Returns the JAX wrapper's summary (``process_index``,
    ``process_count``, ``local_devices``: the devices this process drives,
    always 1; ``global_devices``: one per rank) and ``device`` and
    ``backend`` (None in a single process)."""
    world = world_size if world_size is not None else _env_int(
        "WORLD_SIZE", 1)
    me = rank if rank is not None else _env_int("RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    dev = local_device(device, _env_int("LOCAL_RANK", me % local_world))
    used = None
    if world > 1:
        used = backend or ("nccl" if dev.type == "cuda" else "gloo")
        check_backend(used, dev, local_world)
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                used, init_method="env://", world_size=world, rank=me)
    return {"process_index": me, "process_count": world,
            "local_devices": 1, "global_devices": world, "device": dev,
            "backend": used}


def world() -> tuple:
    """``(rank, world_size)`` of this process (``(0, 1)`` outside a
    process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, world_size, port, backend, threads, fn, args, results):
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world_size, rank=rank)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent raises it with the rank's trace
        results.put((rank, False, traceback.format_exc()))


# how long spawn waits for a rank's answer
SPAWN_TIMEOUT_S = 600.0


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          threads: int = 1) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one ``backend`` process group over localhost, and return the
    ranks' return values in rank order (they must pickle). ``fn`` must be
    importable by name (a module-level function). A rank that raises makes
    this raise with its traceback; every process is joined or killed
    before this returns."""
    import queue as _queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned,
                         args=(r, world_size, port, backend, threads, fn,
                               args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world_size):
            try:
                rank, ok, value = results.get(timeout=SPAWN_TIMEOUT_S)
            except _queue.Empty:
                raise TimeoutError(
                    f"spawn: no answer from a rank within {SPAWN_TIMEOUT_S} "
                    f"s; got ranks {sorted(out)}") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a spawned rank failed\n" + "\n".join(errors))
    return [out[r] for r in range(world_size)]
