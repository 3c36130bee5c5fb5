"""The calibrated node cap at HGSampling's own bound.

``experiments.engine.make_layout`` sizes a calibrated layout's node cap at
1.5x the largest per-type count of four draws, but never above
``round_up(batch_size + depth * width, 128)`` (``schema.sampler_node_bound``)
when the task seeds at most ``batch_size`` nodes of a type: the sampler
inserts the seeds, then each depth round at most ``width`` nodes of a type,
so the rows beyond that bound are always empty. On the ogbn-mag proxy at
scale 0.002 with batches of 32 papers, depth 2 and width 48 the paper type
reaches the bound (128) and the calibrated cap asks for 256, so the bound
binds. ``sampling.batch.pad_counts`` counts the node rows ``pad_sample``
truncates, which must stay 0 at the capped layout.
"""

import dataclasses

import numpy as np
import pytest

from pyhgt_tpu_torch.config import PRESETS
from pyhgt_tpu_torch.datasets import mag_proxy
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.graph.schema import sampler_node_bound
from pyhgt_tpu_torch.sampling.batch import pad_counts, pad_sample
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask

SHAPE = dict(batch_size=32, sample_depth=2, sample_width=48)
BOUND = 128     # round_up(32 + 2 * 48, 128)


def _cfg(**kw):
    return dataclasses.replace(PRESETS["ogbn_mag"], **SHAPE, **kw)


@pytest.fixture(scope="module")
def graph():
    return mag_proxy.build(0.002)


class _Draws:
    """The sampler's ``sample_raw`` seeded from ``rng`` (as the benchmark
    seeds its calibration), counting the calls."""

    def __init__(self, sampler, rng):
        self.schema, self._sampler, self._rng = sampler.schema, sampler, rng
        self.calls = 0

    def sample_raw(self, seeds):
        self.calls += 1
        return self._sampler.sample_raw(
            seeds, rng=np.random.default_rng(self._rng.integers(2**31)))


def _seeds_fn(graph, batch_size, rng, counter=None):
    years = np.asarray(graph.aux["years"]).reshape(-1)

    def fn():
        if counter is not None:
            counter.append(1)
        pick = rng.choice(len(years), batch_size, replace=False)
        return {"paper": np.stack([pick, years[pick]], axis=1)}
    return fn


def _layout(graph, cfg, seed=0, seeds_bounded=True, counter=None):
    draws = _Draws(engine.make_sampler(cfg, graph), np.random.default_rng(seed))
    layout = engine.make_layout(
        cfg, graph, sampler=draws,
        seeds_fn=_seeds_fn(graph, cfg.batch_size,
                           np.random.default_rng(seed + 7), counter),
        seeds_bounded=seeds_bounded)
    return layout, draws


def test_bound_formula():
    assert sampler_node_bound(**dict(zip(
        ("num_seeds", "depth", "width"), SHAPE.values()))) == BOUND
    # the ogbn-mag and OAG recipes
    assert sampler_node_bound(128, 6, 520) == 3328
    assert sampler_node_bound(256, 6, 128) == 1024


def test_calibrated_cap_is_capped_at_the_bound(graph):
    layout, _ = _layout(graph, _cfg())
    pad = layout.pad
    assert (pad.node_bound, pad.node_calibrated) == (BOUND, 256)
    assert layout.node_cap == min(pad.node_calibrated, pad.node_bound) == BOUND
    # the self-loop blocks shrink with the cap
    assert [b.cap for b in layout.blocks if b.meta.rel == "self"] == [
        BOUND] * layout.num_types


def test_calibration_draws_unchanged(graph):
    """Four draws and four seed picks, as before, and the same edge caps
    as the uncapped calibration (the JAX package's, which the port's was a
    copy of) on the same seeds."""
    jschema = pytest.importorskip("pyhgt_tpu.graph.schema")
    picks = []
    layout, draws = _layout(graph, _cfg(), seed=3, counter=picks)
    assert (draws.calls, len(picks)) == (4, 4)
    old_draws = _Draws(engine.make_sampler(_cfg(), graph),
                       np.random.default_rng(3))
    old = jschema.PadSpec.calibrate(
        old_draws, _seeds_fn(graph, 32, np.random.default_rng(10)))
    assert (layout.pad.default_edge_cap, layout.pad.edge_caps) == (
        old.default_edge_cap, old.edge_caps)
    assert layout.pad.node_calibrated == old.node_cap == 256


def test_user_node_cap_wins(graph):
    layout, _ = _layout(graph, _cfg(node_cap=384))
    assert layout.node_cap == 384
    assert (layout.pad.node_bound, layout.pad.node_calibrated) == (BOUND, 256)


def test_unbounded_seeds_keep_the_calibrated_cap(graph):
    layout, _ = _layout(graph, _cfg(), seeds_bounded=False)
    assert layout.pad.node_bound is None
    assert layout.node_cap == layout.pad.node_calibrated == 256


def test_link_task_keeps_the_calibrated_cap():
    """The link task seeds whole name groups of authors, which its config
    does not bound: its layout keeps the calibrated cap."""
    from test_torch_parallel_runs import METAS, toy_graph

    cfg = dataclasses.replace(
        PRESETS["author_disambiguation"], n_hid=32, n_heads=4, n_layers=2,
        sample_depth=2, sample_width=8, batch_size=8, native_sampler=False)
    task, _, _ = engine.link_setup(cfg, toy_graph(), None,
                                   METAS["first_meta"], METAS["write_meta"],
                                   8, log=lambda s: None)
    pad = task.layout.pad
    assert pad.node_bound is None
    assert pad.node_cap == pad.node_calibrated


def test_no_batch_passes_the_bound(graph):
    """200 batches on varied seeds: every type's sampled count is at most
    the bound, and padding them at the capped layout truncates no row."""
    cfg = _cfg()
    layout, _ = _layout(graph, cfg)
    assert layout.node_cap == BOUND
    sampler = engine.make_sampler(cfg, graph)
    task = OgbnNodeTask(graph=graph, sampler=sampler, layout=layout,
                        batch_size=cfg.batch_size)
    before = pad_counts.read()
    most = 0
    for seed in range(200):
        rng = np.random.default_rng(1000 + seed)
        raw = sampler.sample_raw(
            _seeds_fn(graph, cfg.batch_size, rng)(), rng=rng)
        most = max(most, *(len(v) for v in raw.node_ids.values()))
        pad_sample(raw, layout, {})
    task.sample(np.arange(cfg.batch_size), np.random.default_rng(0))
    batches, rows, cut = (a - b for a, b in zip(pad_counts.read(), before))
    assert most == BOUND        # the paper type fills its bound
    assert (batches, cut) == (201, 0)
    assert rows > 0


def test_truncation_is_counted(graph):
    """A cap below the sampled counts truncates, and the counter says so."""
    cfg = _cfg()
    layout, _ = _layout(graph, _cfg(node_cap=64))
    sampler = engine.make_sampler(cfg, graph)
    rng = np.random.default_rng(5)
    raw = sampler.sample_raw(_seeds_fn(graph, cfg.batch_size, rng)(), rng=rng)
    want = sum(max(len(v) - 64, 0) for v in raw.node_ids.values())
    before = pad_counts.read()
    pad_sample(raw, layout, {})
    after = pad_counts.read()
    assert want > 0
    assert (after[0] - before[0], after[2] - before[2]) == (1, want)


def test_runner_logs_the_cap(graph, tmp_path):
    """``run_ogbn``'s ``layout:`` line gives the cap, the bound and the
    calibrated value, and its closing line the truncated rows (none)."""
    cfg = _cfg(n_hid=32, n_heads=4, n_layers=1, n_batch=1, repeat=1,
               n_epoch=1, n_pool=1, vr_num=1, model_dir=str(tmp_path))
    logs = []
    engine.run_ogbn(cfg, graph, log=logs.append, max_eval_nodes=32,
                    device="cpu")
    lines = [m for m in logs if m.startswith("layout:")]
    assert lines[0].startswith(
        f"layout: node cap {BOUND} (sampler bound {BOUND}, calibrated 256)")
    assert lines[-1].startswith("layout: 0 node rows truncated in ")
