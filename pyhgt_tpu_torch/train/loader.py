"""Async sampler→device prefetch pipeline.

Counterpart of :mod:`pyhgt_tpu.train.loader`. Replaces the reference's
double-buffered ``mp.Pool`` (submit the next epoch's sampling jobs, then
train on the previous epoch's results, ``OAG/train_paper_field.py:141-153,
214-231``) with a thread-pool producer, a bounded queue and a one-deep
device prefetch:

- N worker threads run the (numpy/C++) sampler; each job gets a fresh
  32-bit seed from ``default_rng(seed)``, as the reference's ``randint()``
  per-job seeding (``pyHGT/utils.py:42-43``);
- on a CUDA device, the worker pins its item's arrays (page-locked host
  memory: an asynchronous copy needs it), and the consumer issues the
  host-to-device copies on a side stream and moves on; the stream that
  reads the item waits on the copy's event, so a step never waits on PCIe
  unless the copy is not done (the reference pays a ``.to(device)`` on the
  critical path every batch, ``train_paper_field.py:242-243``);
- ``repeat`` re-yields each sampled batch k times (``--repeat``,
  ``train_paper_field.py:57-58,240``).

An item is any nest of dataclasses, tuples, lists and dicts whose leaves
are numpy arrays or CPU tensors (other leaves pass through unchanged).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from pyhgt_tpu_torch import resolve_device


def map_arrays(fn, obj):
    """``obj`` with ``fn`` applied to every numpy array and tensor leaf,
    through dataclasses (their init fields), tuples, lists and dicts."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_arrays(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_arrays(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: map_arrays(fn, v) for k, v in obj.items()}
    return obj


def _pinned(a):
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    return t.pin_memory()


class PrefetchLoader:
    """Continuous batch producer with device prefetch.

    ``sample_fn(rng: np.random.Generator) -> item`` produces one host batch
    (e.g. task sampling + ``pad_sample`` + the host sort). Iterating the
    loader yields the items on ``device`` (default ``cuda``; raises without
    one): on the CPU unchanged, on a GPU with every array leaf a tensor on
    the device.
    """

    def __init__(
        self,
        sample_fn: Callable[[np.random.Generator], object],
        n_workers: int = 4,
        queue_size: int = 8,
        repeat: int = 1,
        seed: Optional[int] = None,
        device=None,
        stack: int = 1,
        collate: Optional[Callable] = None,
    ) -> None:
        """``stack > 1`` (``collate``) is the JAX package's data- and
        pipeline-parallel feed, which is not ported yet: it raises."""
        if stack > 1 or collate is not None:
            raise NotImplementedError(
                "stack > 1 / collate (the dp and pp feeds) is not ported yet")
        self.sample_fn = sample_fn
        self.n_workers = n_workers
        self.repeat = repeat
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._host_q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._failed = threading.Event()
        self._seed_rng = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(n_workers)
        ]
        self._started = False
        # (copy-done event, pinned host item): each pinned item is held
        # until its copy has finished on the device
        self._inflight: "collections.deque" = collections.deque()
        self._stream = (torch.cuda.Stream(self.device) if self._pin
                        else None)

    # -- producer side ------------------------------------------------------
    def _next_seed(self) -> int:
        # fresh 32-bit seed per job — decorrelated workers, reproducible
        # stream given the loader seed (cf. pyHGT/utils.py:42-43)
        with self._seed_lock:
            return int(self._seed_rng.integers(0, 2**31 - 1))

    def _worker(self) -> None:
        while not self._stop.is_set():
            rng = np.random.default_rng(self._next_seed())
            try:
                batch = self.sample_fn(rng)
                if self._pin:
                    batch = map_arrays(_pinned, batch)
            except Exception as e:  # fail fast, surface in consumer
                self._failed.set()  # __iter__ raises instead of blocking
                self._host_q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._host_q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self) -> "PrefetchLoader":
        if not self._started:
            for t in self._threads:
                t.start()
            self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        # drain so producer threads blocked on put() can exit
        try:
            while True:
                self._host_q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- consumer side ------------------------------------------------------
    def _get_host_item(self):
        # don't block forever on an empty queue once a worker has died:
        # surviving workers may be unable to refill it fast enough, and
        # with 0 survivors nothing ever will
        while True:
            try:
                item = self._host_q.get(timeout=1.0)
                break
            except queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "all PrefetchLoader workers have exited"
                        + (
                            " after a sample_fn failure"
                            if self._failed.is_set() else ""
                        )
                    ) from None
        if isinstance(item, Exception):
            raise item
        return item

    def _to_device(self, pinned):
        """Start the item's copies on the side stream; returns the device
        item and the event that marks them done."""
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        with torch.cuda.stream(self._stream):
            dev = map_arrays(
                lambda t: t.to(self.device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._inflight.append((done, pinned))
        return dev, done

    def _ready(self, dev, done):
        """Make the consumer's stream wait for the copies, and tell the
        allocator that the consumer's stream uses the tensors (they were
        allocated on the side stream)."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        map_arrays(lambda t: t.record_stream(consumer), dev)
        return dev

    def __iter__(self) -> Iterator:
        self.start()
        pending = None  # one-deep device prefetch pipeline
        while True:
            item = self._get_host_item()
            if self._pin:
                item = self._to_device(item)
            for _ in range(self.repeat):
                if pending is not None:
                    yield (self._ready(*pending) if self._pin
                           else pending)
                pending = item

    def take(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]
