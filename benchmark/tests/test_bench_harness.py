"""The benchmark's harness on the CPU: what it finds by name, its
arithmetic against hand counts, the shape of its result line, and
``correct`` against the plain reference on tiny configurations, with and
without faults planted in the timed path."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import flops, kernel_bytes, peaks, roofline, run, spec, trace
from benchmark.spec import HERE, ROOT
from benchmark.tests.fixtures import _few_threads, tiny_bench  # noqa: F401

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# ------------------------------------------------------------ found by name
@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(w):
    cell = spec.load_cell(w)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")


@pytest.mark.parametrize("change", ["conv_not_modelled", "unread_traffic"])
def test_cell_the_harness_cannot_run_raises(change, tmp_path, monkeypatch):
    """A configuration that its reference does not model, and a traffic
    mix with a parameter that nothing reads, are refused on loading."""
    from benchmark.tests.fixtures import write_tiny_bench

    over = dict(conv_name="gat") if change == "conv_not_modelled" else {}
    bench = write_tiny_bench(tmp_path, **over)
    if change == "unread_traffic":
        (tmp_path / "traffic").mkdir()
        mix = json.loads((HERE / "traffic" / "train-sampled.json")
                         .read_text())
        (tmp_path / "traffic" / "train-sampled.json").write_text(
            json.dumps(dict(mix, loop="closed")))
        monkeypatch.setattr(spec, "HERE", tmp_path)
    with pytest.raises(ValueError):
        spec.load_cell("hgt-ogbn-mag.train", bench)


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


# ------------------------------------------------------------ arithmetic
def test_partials_bytes_by_hand():
    # 2 tensors of [256, 128] bf16 over 2 tiles of 128, 3 blocks of 8 rows
    aux = SimpleNamespace(loc=torch.zeros(2, 128), num_blocks=3, w=8)
    want = 2 * 256 * 128 * 2 + 2 * 128 * 4 + 2 * 4 + 2 * 24 * 128 * 4
    assert kernel_bytes.partials_bytes(256, 128, 2, aux, 2) == want
    want_sm = 256 * 8 * 4 + 2 * 128 * 4 + 2 * 4 + 2 * 24 * 8 * 4
    assert kernel_bytes.softmax_partials_bytes(256, 8, aux) == want_sm


def test_flops_by_hand():
    # one type of 10 nodes, one self block of 10 edges, D 8, 2 heads
    got = flops.train_step_flops({"a": 10}, [("a", "a", 10)], d_in=4,
                                 n_hid=8, n_heads=2, n_layers=1,
                                 head_rows=10, n_classes=3)
    adapt = 2 * 10 * 4 * 8
    layer = (4 * 2 * 10 * 8 * 8 + 2 * 240 * 8 * 8 + 2 * 2 * 240 * 8 * 8
             + 2 * 2 * (10 + 240) * 8 * 4)
    head = 2 * 10 * 8 * 3
    assert got["node"] == 3 * (adapt + layer + head) - adapt
    assert got["edge"] == 3 * 2 * 2 * 10 * 8


class _Ev(SimpleNamespace):
    pass


def _prof(events, t0=1_000_000):
    from torch.autograd import DeviceType

    out = [_Ev(name=name, device_type=DeviceType.CUDA,
               time_range=SimpleNamespace(start=a, end=b))
           for name, a, b in events]
    results = SimpleNamespace(trace_start_ns=lambda: t0)
    return SimpleNamespace(events=lambda: out,
                           profiler=SimpleNamespace(kineto_results=results))


def test_busy_share_and_gaps_by_hand():
    # device events in microseconds after the trace's start; host spans
    # and the window in nanoseconds on the same clock
    t0 = 1_000_000
    prof = _prof([("k1", 10, 20), ("k2", 15, 40), ("Memcpy HtoD", 50, 55),
                  ("k1", 95, 120)], t0)
    ns = lambda us: t0 + us * 1000      # noqa: E731
    spans = [("bench.step", ns(0), ns(30)),
             ("bench.loader_next", ns(60), ns(90))]
    s = trace.summarize(prof, (ns(0), ns(100)), spans)
    assert s["span_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 5 + 5) * 1e-6)
    assert sorted(n for n, _ in s["kernels"]) == ["k1", "k1", "k2"]
    assert s["idle_gaps"][0] == ["bench.loader_next", pytest.approx(40e-6)]
    assert s["idle_gaps"][1][0] == "bench.step"


def test_roofline_share_and_kernel_names():
    assert roofline.is_pair_walk("void walk_kernel<__nv_bfloat16, 0, 2>(x)")
    assert not roofline.is_pair_walk("void walk_kernel<__nv_bfloat16, 0, 1>(x)")
    assert roofline.is_softmax("void softmax_partials_kernel(float const*)")
    t = dict(counts=[dict(pair_launches=8, pair_bytes=3.35e9)],
             launches=dict(pair=8),
             kernels=[("void walk_kernel<float, 1, 2>()", 2e-3),
                      ("void walk_kernel<float, 0, 1>()", 5e-3)])
    got = roofline.share(t, "pair", roofline.is_pair_walk)
    assert got == pytest.approx(100.0 * (3.35e9 / peaks.HBM_BYTES_PER_S) / 2e-3)
    t["launches"] = dict(pair=7)          # the program launched otherwise
    assert roofline.share(t, "pair", roofline.is_pair_walk) is None


# ------------------------------------------------------------ imports
def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("pyhgt_tpu_torch",
                                               *run.FORBIDDEN), (path, m)


def test_harness_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.session, "
            "benchmark.calibrate; from benchmark.run import forbidden_modules;"
            " print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"
    sys.modules.setdefault("pyhgt_tpu_fake_for_test", object())
    assert "pyhgt_tpu_fake_for_test" not in run.forbidden_modules()


# ------------------------------------------------------------ layouts
def test_one_seed_one_layout(tiny_bench):
    from benchmark import system

    cfg = spec.load_cell("hgt-ogbn-mag.train", tiny_bench).config
    dev = torch.device("cpu")
    graph = system.make_graph(cfg)
    a = system.build(cfg, 5, dev, graph=graph).layout
    b = system.build(cfg, 5, dev, graph=graph).layout
    assert a.pad == b.pad and a.num_edges == b.num_edges
