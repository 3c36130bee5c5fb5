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
- where a consumer on the device holds :class:`InputSlots` (a CUDA-graphed
  train step, which reads its inputs at fixed addresses), the copies land
  in those slots instead of in fresh memory;
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
import weakref
from typing import Callable, Iterator, List, Optional

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


def array_leaves(obj) -> list:
    """The numpy array and tensor leaves of ``obj``, in the order
    :func:`map_arrays` visits them."""
    leaves = []

    def keep(a):
        leaves.append(a)
        return a

    map_arrays(keep, obj)
    return leaves


# each device's input slots, held weakly: they live as long as the consumer
# that owns them. A loader finds them here because its callers build it
# without knowing the step that will read its items.
_SLOTS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class InputSlots:
    """Two places on a device where a consumer wants its items: a
    CUDA-graphed train step, whose graphs read their inputs at the
    addresses they were captured on
    (:class:`~pyhgt_tpu_torch.train.graph_step.GraphedStep`).

    Once made, a consumer's slots serve every :class:`PrefetchLoader`
    iterated on their device. The first two items of one layout (the shapes and
    dtypes of their array leaves) that such a loader copies to the device
    become the slots; each later item of that layout is copied into the
    slot the loader's pending item does not hold. So the card holds no
    more copies of an item than the loader's one-deep prefetch holds
    anyway, and a consumer of such a loader must not read an item after
    it has asked for the one after it. Items of another layout are copied
    to fresh memory, as without slots."""

    COUNT = 2

    def __init__(self, device):
        self.device = _indexed(device)
        self.layout = None
        self.leaves: List[list] = []    # per slot, its device tensors
        self.ptrs: List[frozenset] = []  # per slot, their addresses
        self.written: list = []         # per slot, the end of its last copy
        _SLOTS[self.device] = self

    @staticmethod
    def on(device) -> Optional["InputSlots"]:
        """The slots a consumer holds on ``device``, or None."""
        return _SLOTS.get(_indexed(device))

    def index(self, tensors) -> Optional[int]:
        """The slot every one of ``tensors`` is a leaf of, or None."""
        ptrs = [t.data_ptr() for t in tensors]
        for k, held in enumerate(self.ptrs):
            if all(p in held for p in ptrs):
                return k
        return None

    def free(self, layout, busy: Optional[int]) -> Optional[int]:
        """The slot an item of ``layout`` is copied into when the slot
        ``busy`` (the loader's pending item) must stay as it is; None when
        the item goes to fresh memory (another layout, or the slots are
        not all made yet)."""
        if layout != self.layout or len(self.leaves) < self.COUNT:
            return None
        return next(k for k in range(self.COUNT) if k != busy)

    def adopt(self, layout, dev) -> Optional[int]:
        """Make the device item ``dev`` (an item of ``layout`` just copied
        to fresh memory) a slot, if the slots are not all made and
        ``layout`` is theirs (or the first); returns its slot or None."""
        if (len(self.leaves) >= self.COUNT
                or self.layout not in (None, layout)):
            return None
        self.layout = layout
        leaves = array_leaves(dev)
        self.leaves.append(leaves)
        self.ptrs.append(frozenset(t.data_ptr() for t in leaves))
        self.written.append(None)
        return len(self.leaves) - 1


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _layout(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


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

    def _to_device(self, pinned, busy=None, slots=None):
        """Start the item's copies on the side stream; returns the device
        item, the event that marks them done, the slot of ``slots`` that
        holds it (or None) and whether it is in fresh memory. ``busy`` is
        the slot of the pending item, which must stay as it is."""
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        k = None
        if slots is not None:
            layout = _layout(array_leaves(pinned))
            k = slots.free(layout, busy)
        fresh = k is None
        if not fresh:
            # the slot's last reader is queued on the consumer's stream,
            # and its last copy on this or another loader's: wait for both
            read = torch.cuda.Event()
            read.record(torch.cuda.current_stream(self.device))
            self._stream.wait_event(read)
            if slots.written[k] is not None:
                self._stream.wait_event(slots.written[k])
        with torch.cuda.stream(self._stream):
            if fresh:
                dev = map_arrays(
                    lambda t: t.to(self.device, non_blocking=True), pinned)
                if slots is not None:
                    k = slots.adopt(layout, dev)
            else:
                into = iter(slots.leaves[k])
                dev = map_arrays(
                    lambda t: next(into).copy_(t, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        if k is not None:
            slots.written[k] = done
        self._inflight.append((done, pinned))
        return dev, done, k, fresh

    def _ready(self, dev, done, k, fresh):
        """Make the consumer's stream wait for the copies, and tell the
        allocator that the consumer's stream uses the tensors of a fresh
        allocation (they were allocated on the side stream)."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        if fresh:
            map_arrays(lambda t: t.record_stream(consumer), dev)
        return dev

    def __iter__(self) -> Iterator:
        return self._items(InputSlots.on(self.device) if self._pin else None)

    def _items(self, slots) -> Iterator:
        """The yielded items; on the device's ``slots`` where given."""
        self.start()
        pending = None  # one-deep device prefetch pipeline
        while True:
            item = self._next_host_item()
            if self._pin:
                item = self._to_device(
                    item, pending[2] if pending is not None else None, slots)
            for _ in range(self.repeat):
                if pending is not None:
                    yield (self._ready(*pending) if self._pin
                           else pending)
                pending = item

    def take(self, n: int):
        """The next ``n`` items, each in memory of its own (never in
        :class:`InputSlots`: the caller holds them all)."""
        it = self._items(None)
        return [next(it) for _ in range(n)]
