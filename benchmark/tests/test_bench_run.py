"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line's shape, ``correct`` against the plain
reference, and ``correct`` false with the timed path broken underneath:
a step that leaves its state unchanged, half of the batch left out with
the mean taken over the rest, an answer (a sampled edge) altered where
it is produced, and the node products at TF32 (below the float32 that the
configurations state). Cells of one chip exchange nothing between
chips."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.fixtures import (  # noqa: F401 (fixtures)
    _few_threads,
    tiny_bench,
    write_tiny_bench,
)

CELLS = ("hgt-ogbn-mag.train", "hgt-oag-field.train")


def _run(bench, cell, capsys, trace=0, mutate=None, seed=3_000_000_007):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "1", "--trace", str(trace)], require_cuda=False,
                  bench_path=bench, mutate=mutate)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_bench, cell, capsys):
    line, err = _run(tiny_bench, cell, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_targets_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert all(m["value"] > 0 for k, m in line["metrics"].items()
               if k != "peak_mem_gib")      # no device memory on the CPU
    for name, c in line["checks"].items():
        assert f"check {name}:" in err and c["value"] <= c["limit"]
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_line(tiny_bench, capsys):
    line, _ = _run(tiny_bench, CELLS[0], capsys, trace=1)
    assert {"loader_wait_ms", "train_mfu"} <= set(line["metrics"])
    # no device on the CPU: no busy time, no kernels, no roofline
    assert "live_partials_pair_roofline" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_reference_holds_the_f32_port_tightly(tmp_path, capsys):
    """Without the bf16 edge stage the port and the plain reference
    compute the same float32 numbers, up to summation order."""
    bench = write_tiny_bench(tmp_path, edge_bf16=False)
    line, _ = _run(bench, CELLS[0], capsys)
    checks = line["checks"]
    assert checks["batch_mismatch"]["value"] == 0
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_norm_gap"]["value"] < 1e-4


def _frozen(sut):
    loss_fn = sut.task.make_loss_fn(sut.model, sut.em.to(sut.device))

    def step(gen, *args):
        return loss_fn(gen, *args).detach()

    sut.step = step


def _half_batch(sut):
    args = sut.step_args

    def half(item):
        a = list(args(item))
        mask = a[4].clone()
        live = mask.nonzero()[:, 0]
        mask[live[len(live) // 2:]] = False
        a[4] = mask
        return tuple(a)

    sut.step_args = half


def _altered_edge(sut):
    sample_raw = sut.recorder.sampler.sample_raw

    def altered(seeds, **kw):
        raw = sample_raw(seeds, **kw)
        meta = max(raw.edges, key=lambda m: len(raw.edges[m][0]))
        tgt, src = raw.edges[meta]
        n_src = len(raw.node_ids[meta[1]])
        src = src.copy()
        src[0] = (src[0] + 1) % n_src
        raw.edges[meta] = (tgt, src)
        return raw

    sut.recorder.sampler.sample_raw = altered


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _altered_edge],
                         ids=["state_unchanged", "half_batch",
                              "altered_edge"])
def test_fault_is_not_correct(tiny_bench, fault, capsys):
    line, _ = _run(tiny_bench, CELLS[0], capsys, mutate=fault)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_node_products_are_not_correct(tiny_bench, cell, capsys,
                                            monkeypatch):
    """The input adapter's products with both inputs rounded to TF32, as
    the card computes them with TF32 switched on."""
    from benchmark.reference.hgt import tf32
    from pyhgt_tpu_torch.models import model as model_mod

    plain = model_mod.typed_linear
    monkeypatch.setattr(model_mod, "typed_linear",
                        lambda x, w, b=None: plain(tf32(x), tf32(w), b))
    line, _ = _run(tiny_bench, cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["input_gap"]["value"] \
        > line["checks"]["input_gap"]["limit"]


def test_no_card_no_result(tiny_bench, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                  bench_path=tiny_bench)
    out, _ = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
