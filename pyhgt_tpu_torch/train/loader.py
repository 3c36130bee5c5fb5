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
  ``train_paper_field.py:57-58,240``);
- ``stack`` collects that many items per yielded one (``collate``), the
  pipeline's microbatches;
- ``group``: the ranks of a process group train on the same items (a graph
  group's shards of one batch, a pipe group's microbatches). The group's
  rank ``src`` alone samples; each item goes from it to the others (all of
  it, or under ``split`` each rank its own part), and ``local`` makes
  what a rank received into what its step reads. The loader's threads
  finish items in no fixed order, so sampling on every rank of the group
  would train the ranks on different batches.

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
        group=None,
        src: int = 0,
        split: Optional[Callable] = None,
        local: Optional[Callable] = None,
    ) -> None:
        """``stack`` host items make each yielded item, combined by
        ``collate(items)`` when it is given (also for ``stack == 1``: a
        pipeline of one microbatch) and else, when ``stack > 1``, listed;
        one item without ``collate`` passes unchanged. With a
        process ``group``, the global rank ``src`` produces the items and
        sends them to the group: ``split(item)`` (on ``src``) gives one
        part per rank of the group, in group order, each rank receiving
        its own; without it every rank receives the whole item. ``local``
        (every rank) maps the received item to the one yielded. The other
        ranks start no sampling threads."""
        import torch.distributed as dist

        self.sample_fn = sample_fn
        self.repeat = repeat
        self.device = resolve_device(device)
        self.stack = stack
        self.collate = collate
        self.group, self.src = group, src
        self.split, self.local = split, local
        self._is_src = group is None or dist.get_rank() == src
        self.n_workers = n_workers if self._is_src else 0
        self._pin = self.device.type == "cuda"
        # items that travel between ranks, or change here, pin after that
        self._late_pin = self._pin and (group is not None
                                        or local is not None)
        self._host_q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._failed = threading.Event()
        self._seed_rng = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.n_workers)
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
                if self._pin and not self._late_pin:
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

    def _next_host_item(self):
        """The next item of this rank: ``stack`` host items collated, sent
        over the group when there is one (a failure on ``src`` travels the
        same way, so every rank raises), then ``local``."""
        import torch.distributed as dist

        item = None
        if self._is_src:
            try:
                if self.stack > 1 or self.collate is not None:
                    item = (self.collate or list)(
                        [self._get_host_item() for _ in range(self.stack)])
                else:
                    item = self._get_host_item()
            except Exception as e:  # noqa: BLE001 - re-raised below
                if self.group is None:
                    raise
                item = e
        if self.group is not None:
            if self.split is not None:
                parts = None
                if self._is_src:
                    parts = ([item] * dist.get_world_size(self.group)
                             if isinstance(item, Exception)
                             else self.split(item))
                box = [None]
                dist.scatter_object_list(box, parts, src=self.src,
                                         group=self.group)
            else:
                box = [item]
                dist.broadcast_object_list(box, src=self.src,
                                           group=self.group)
            item = box[0]
            if isinstance(item, Exception):
                raise item
        if self.local is not None:
            item = self.local(item)
        if self._late_pin:
            item = map_arrays(_pinned, item)
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
            item = self._next_host_item()
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
