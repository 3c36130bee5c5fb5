"""The port's ``PrefetchLoader``: the JAX loader's item order (one worker,
the same seed, ``repeat``), its failure modes (a worker's exception in the
consumer, "all workers exited" instead of a hang, ``stop()`` with the queue
full), and, on a card, pinned non-blocking copies that arrive equal to the
host items."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.train.loader import InputSlots, PrefetchLoader


def sample_fn(rng):
    """A deterministic item of the job's generator."""
    return {"ids": rng.integers(0, 1000, size=7),
            "x": rng.random((3, 4)).astype(np.float32)}


@pytest.mark.parametrize("repeat", [1, 2])
def test_item_order_matches_jax(repeat):
    """One worker, the same seed: the port's host items (device="cpu")
    are the JAX loader's, item for item, each ``repeat`` times."""
    pytest.importorskip("jax")
    from pyhgt_tpu.train.loader import PrefetchLoader as JaxLoader

    with JaxLoader(sample_fn, n_workers=1, repeat=repeat, seed=5) as jl:
        want = jl.take(6)
    with PrefetchLoader(sample_fn, n_workers=1, repeat=repeat, seed=5,
                        device="cpu") as pl:
        got = pl.take(6)
    for g, w in zip(got, want):
        for k in ("ids", "x"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    if repeat == 2:
        assert all(got[i] is got[i + 1] for i in (0, 2, 4))
        assert not np.array_equal(got[0]["ids"], got[2]["ids"])


def test_worker_error_surfaces_then_all_workers_exited():
    """A worker's exception is raised in the consumer; asking again, with
    every worker gone, raises instead of waiting forever."""
    calls = []

    def failing(rng):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("bad sample")
        return sample_fn(rng)

    with PrefetchLoader(failing, n_workers=1, seed=0, device="cpu") as pl:
        with pytest.raises(ValueError, match="bad sample"):
            pl.take(5)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="all PrefetchLoader workers "
                           "have exited after a sample_fn failure"):
            pl.take(1)
        assert time.monotonic() - t0 < 10


def test_stop_returns_with_the_queue_full():
    pl = PrefetchLoader(sample_fn, n_workers=2, queue_size=2, seed=0,
                        device="cpu").start()
    t0 = time.monotonic()
    while not pl._host_q.full():
        assert time.monotonic() - t0 < 10
        time.sleep(0.01)
    pl.stop()
    assert time.monotonic() - t0 < 10
    for t in pl._threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_stack_is_not_ported():
    """``stack`` / ``collate`` (the pipeline's feed) are ported now: with
    the JAX loader's default collate (a stack of each leaf on a new leading
    axis) the port yields the JAX loader's stacked items; by default it
    yields the list of the items."""
    pytest.importorskip("jax")
    from pyhgt_tpu.train.loader import PrefetchLoader as JaxLoader

    def stack(items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    with JaxLoader(sample_fn, n_workers=1, stack=2, seed=5) as jl:
        want = jl.take(3)
    with PrefetchLoader(sample_fn, n_workers=1, stack=2, collate=stack,
                        seed=5, device="cpu") as pl:
        got = pl.take(3)
    for g, w in zip(got, want):
        for k in ("ids", "x"):
            assert g[k].shape[0] == 2
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    with PrefetchLoader(sample_fn, n_workers=1, stack=2, seed=5,
                        device="cpu") as pl:
        (items,) = pl.take(1)
    assert isinstance(items, list) and len(items) == 2
    np.testing.assert_array_equal(items[1]["ids"], got[0]["ids"][1])


@dataclasses.dataclass
class _Batch:
    feat: np.ndarray
    idx: np.ndarray
    n: int


@pytest.mark.cuda
def test_cuda_pinned_copies_equal_host_items():
    """Items copied on the loader's side stream while the consumer's
    stream is busy: each arrives on the card equal to the host item made
    from the same job seed (pinned memory kept alive, the consumer's
    stream waiting on the copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def big(rng):
        return _Batch(rng.random((512, 1024)).astype(np.float32),
                      rng.integers(0, 2**31 - 1, size=1 << 18), 7)

    seeds = np.random.default_rng(9)
    want = [big(np.random.default_rng(int(seeds.integers(0, 2**31 - 1))))
            for _ in range(6)]
    a = torch.randn(2048, 2048, device="cuda")
    with PrefetchLoader(big, n_workers=1, seed=9, device="cuda") as pl:
        it = iter(pl)
        for w in want:
            for _ in range(4):
                a = a @ a / 2048  # keep the consumer's stream busy
            item = next(it)
            assert item.feat.is_cuda and item.idx.is_cuda and item.n == 7
            torch.testing.assert_close(item.feat.cpu(), torch.from_numpy(w.feat),
                                       rtol=0, atol=0)
            assert torch.equal(item.idx.cpu(), torch.from_numpy(w.idx))


def test_input_slots_take_items_in_turn():
    """The first two items of one layout become the slots; each later one
    goes to the slot the pending item does not hold; another layout, or
    slots not yet made, go to fresh memory; a slot is found by the
    addresses of its leaves."""
    slots = InputSlots("cpu")
    layout = ((3, 4), torch.float32), ((7,), torch.int64)
    other = ((3, 5), torch.float32), ((7,), torch.int64)

    def item():
        return {"x": torch.zeros(3, 4),
                "ids": torch.zeros(7, dtype=torch.long)}

    assert slots.free(layout, None) is None
    a, b = item(), item()
    assert slots.adopt(layout, a) == 0
    assert slots.free(layout, 0) is None
    assert slots.adopt(other, item()) is None
    assert slots.adopt(layout, b) == 1
    assert slots.adopt(layout, item()) is None
    assert slots.free(layout, 0) == 1 and slots.free(layout, 1) == 0
    assert slots.free(layout, None) in (0, 1)
    assert slots.free(other, 0) is None
    assert slots.index([a["ids"], a["x"]]) == 0
    assert slots.index([b["x"]]) == 1
    assert slots.index([a["x"], b["ids"]]) is None
    assert InputSlots.on("cpu") is slots
    del slots
    assert InputSlots.on("cpu") is None


@pytest.mark.cuda
def test_cuda_items_land_in_input_slots():
    """With input slots held on the card, the loader's items alternate
    between two fixed places and still arrive equal to their host items
    while the consumer's stream is busy; ``take`` keeps its items apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def big(rng):
        return _Batch(rng.random((512, 1024)).astype(np.float32),
                      rng.integers(0, 2**31 - 1, size=1 << 18), 7)

    seeds = np.random.default_rng(9)
    want = [big(np.random.default_rng(int(seeds.integers(0, 2**31 - 1))))
            for _ in range(8)]
    slots = InputSlots("cuda")
    a = torch.randn(2048, 2048, device="cuda")
    places = []
    with PrefetchLoader(big, n_workers=1, seed=9, device="cuda") as pl:
        it = iter(pl)
        for w in want:
            for _ in range(4):
                a = a @ a / 2048  # keep the consumer's stream busy
            item = next(it)
            places.append(slots.index([item.feat, item.idx]))
            assert torch.equal(item.feat.cpu(), torch.from_numpy(w.feat))
            assert torch.equal(item.idx.cpu(), torch.from_numpy(w.idx))
    assert places == [0, 1] * 4
    with PrefetchLoader(big, n_workers=1, seed=9, device="cuda") as pl:
        got = pl.take(3)
    assert all(slots.index([g.feat]) is None for g in got)
    assert len({g.feat.data_ptr() for g in got}) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.feat.cpu(), torch.from_numpy(w.feat))
