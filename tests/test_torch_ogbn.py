"""The port's ogbn-mag product path against the JAX package's: ``run_ogbn``
(calibrated layout, the producer's items, the epoch loop, validation, the
VR test evaluation), resume, ``evaluate_ogbn`` and the CLI tasks
``ogbn_mag`` and ``eval_ogbn_mag``.

Both packages start from the same weights with no knob of their own: JAX
``run_ogbn`` with ``n_epoch=0`` returns its initial state, which is saved
as the JAX ``latest`` checkpoint and, through
``convert.checkpoint_from_flax``, as the port's; both runs then resume
from it. Dropout is 0 (the frameworks cannot draw the same masks), one
loader worker fixes the item order, and the numpy sampler runs on both
sides. The graph and the configuration are ``tests/test_torch_serving.py``'s
toy graph and ``tiny_cfg`` (f32, no kernel flags).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.convert import checkpoint_from_flax
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.experiments.engine import evaluate_ogbn, run_ogbn
from pyhgt_tpu_torch.graph import container
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from test_torch_sampler import _same, _same_sorted
from test_torch_serving import (
    FLAGS, tiny_cfg, toy_graph, write_port_checkpoint,
)

# f32 on both sides: the per-epoch train loss (the tolerance of
# tests/test_torch_train_step.py)
LOSS_TOL = 1e-4
# card (bf16 edge stage, kernels) against the CPU's plain path
CUDA_TOL = 3e-2
RUN = dict(dropout=0.0, n_pool=1, native_sampler=False, n_epoch=1,
           n_batch=2, repeat=1, task_name="ogbn_toy")


def _record(monkeypatch, module, name, sink):
    """Wrap ``module.name`` so that every value it returns lands in
    ``sink`` (for a producer factory: every item it produces)."""
    inner = getattr(module, name)
    if name == "_make_producer":
        def wrapped(*a, **k):
            fn = inner(*a, **k)

            def produce(rng):
                item = fn(rng)
                sink.append(item)
                return item
            return produce
    else:
        def wrapped(*a, **k):
            out = inner(*a, **k)
            sink.append(out)
            return out
    monkeypatch.setattr(module, name, wrapped)


def _record_accuracy(monkeypatch, cls, sink):
    """Record ``(accuracy, live rows)`` of every ``cls.accuracy`` call."""
    inner = cls.accuracy

    def acc(logp, labels, mask):
        out = inner(logp, labels, mask)
        sink.append((out, int(np.asarray(mask).sum())))
        return out
    monkeypatch.setattr(cls, "accuracy", staticmethod(acc))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One toy ``run_ogbn`` of each package from the same initial
    weights, with what each computed on the way."""
    jax = pytest.importorskip("jax")
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments import engine as jengine
    from pyhgt_tpu.graph import container as jax_container
    from pyhgt_tpu.tasks.ogbn import OgbnNodeTask as JaxTask
    from pyhgt_tpu.train.checkpoint import save_checkpoint as jax_save

    tmp = tmp_path_factory.mktemp("ogbn")
    jgraph = toy_graph(jax_container)
    jgraph.save_dir(str(tmp / "graph"))
    graph = CSRGraph.load_dir(str(tmp / "graph"))
    jcfg = tiny_cfg(JaxConfig, model_dir=str(tmp / "jax"), **RUN)
    cfg = tiny_cfg(ExperimentConfig, model_dir=str(tmp / "port"), **RUN)
    latest = "ogbn_toy_hgt_latest"
    init = jengine.run_ogbn(jcfg.replace(n_epoch=0), jgraph,
                            log=lambda s: None, max_eval_nodes=8)["state"]
    jax_save(str(tmp / "jax" / latest), init)
    checkpoint_from_flax(jax.tree_util.tree_map(np.asarray, init.params),
                         str(tmp / "init"))
    shutil.copytree(tmp / "init", tmp / "port" / latest)

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for side, mod, task_cls in (("jax", jengine, JaxTask),
                                    ("port", engine, OgbnNodeTask)):
            seen[side] = {"layouts": [], "items": [], "accs": []}
            _record(mp, mod, "make_layout", seen[side]["layouts"])
            _record(mp, mod, "_make_producer", seen[side]["items"])
            _record_accuracy(mp, task_cls, seen[side]["accs"])
        jout = jengine.run_ogbn(jcfg, jgraph, log=lambda s: None,
                                resume=True)
        logs = []
        out = run_ogbn(cfg, graph, log=logs.append, resume=True,
                       device="cpu")
    return dict(cfg=cfg, graph=graph, jout=jout, out=out, logs=logs,
                seen=seen, tmp=tmp)


def test_layouts_equal(runs):
    (jl,), (pl,) = runs["seen"]["jax"]["layouts"], runs["seen"]["port"]["layouts"]
    assert (pl.pad.node_cap, pl.pad.default_edge_cap, pl.pad.edge_caps) == (
        jl.pad.node_cap, jl.pad.default_edge_cap, jl.pad.edge_caps)
    assert [dataclasses.astuple(b) for b in pl.blocks] == [
        dataclasses.astuple(b) for b in jl.blocks]
    assert pl.num_edges == jl.num_edges


def test_producer_items_bit_equal(runs):
    """Item by item (one worker: the per-job seeds come in the same
    order), every array of the task batch and of its SortedEdges, and the
    host counts."""
    jitems = list(runs["seen"]["jax"]["items"])
    pitems = list(runs["seen"]["port"]["items"])
    n = min(len(jitems), len(pitems))
    assert n >= runs["cfg"].n_batch
    for i, (p, j) in enumerate(zip(pitems[:n], jitems[:n])):
        for f in dataclasses.fields(p.tb.sub):
            _same(getattr(p.tb.sub, f.name), getattr(j.tb.sub, f.name),
                  f"item {i} sub.{f.name}")
        for name in ("labels", "label_mask", "target_ids"):
            _same(getattr(p.tb, name), getattr(j.tb, name), f"item {i} {name}")
        _same_sorted(p.se, j.se, f"item {i} se.")
        assert (p.n_edges, p.overflow) == (j.n_edges, j.overflow)


def test_epoch_loss_and_valid_accuracy_match(runs):
    """The train loss within 1e-4; each validation batch's accuracy within
    one flipped prediction of its live rows."""
    (h,), (jh,) = runs["out"]["history"], runs["jout"]["history"]
    assert h["epoch"] == jh["epoch"] == 0
    assert abs(h["loss"] - jh["loss"]) <= LOSS_TOL
    assert (h["edges"], h["edges_dropped"]) == (jh["edges"],
                                                jh["edges_dropped"])
    paccs, jaccs = runs["seen"]["port"]["accs"], runs["seen"]["jax"]["accs"]
    assert len(paccs) == len(jaccs) == 4
    for (pa, pn), (ja, jn) in zip(paccs, jaccs):
        assert pn == jn
        assert abs(pa - ja) * max(pn, 1) <= 1 + 1e-9
    assert abs(h["valid_acc"] - jh["valid_acc"]) <= max(
        1 / (4 * max(n, 1)) for _, n in paccs) + 1e-9
    assert h["step_ms"] is not None and h["wait_ms"] >= 0


def test_vr_test_stats_match(runs):
    """VR and sequential accuracy, the counts and the VR curve: the same
    nodes evaluated, at most one flipped prediction out of ``n_eval``."""
    t, jt = runs["out"]["test"], runs["jout"]["test"]
    assert set(jt) <= set(t)
    assert (t["n_eval"], t["n_eval_seq"]) == (jt["n_eval"], jt["n_eval_seq"])
    assert t["n_eval"] > 0
    assert abs(t["acc"] - jt["acc"]) * t["n_eval"] <= 1 + 1e-9
    assert abs(t["seq_acc"] - jt["seq_acc"]) * t["n_eval_seq"] <= 1 + 1e-9
    assert len(t["vr_curve"]) == len(jt["vr_curve"]) == runs["cfg"].vr_num
    assert abs(t["vr_curve"][0] - jt["vr_curve"][0]) * t["n_eval_seq"] <= 1 + 1e-9
    assert abs(t["vr_curve"][-1] - jt["vr_curve"][-1]) * t["n_eval"] <= 1 + 1e-9


def test_resume_and_checkpoints(runs):
    """The run resumed at epoch 0 and wrote the best and latest
    checkpoints and the metrics jsonl; resuming with more epochs picks up
    after the last one trained (as JAX ``test_engine_resume_midway``);
    ``evaluate_ogbn`` reads the best checkpoint."""
    cfg, tmp = runs["cfg"], runs["tmp"]
    assert any("resumed" in s and "epoch 0" in s for s in runs["logs"])
    for name in ("ogbn_toy_hgt", "ogbn_toy_hgt_latest"):
        assert (tmp / "port" / name / "state.pt").exists()
    lines = (tmp / "port" / "ogbn_toy_metrics.jsonl").read_text().splitlines()
    assert [l.split('"event": "')[1].split('"')[0] for l in lines] == [
        "epoch", "test"]
    logs = []
    out = run_ogbn(cfg.replace(n_epoch=3), runs["graph"], log=logs.append,
                   resume=True, device="cpu", max_eval_nodes=8)
    assert any("resumed" in s and "epoch 1" in s for s in logs)
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    res = evaluate_ogbn(cfg, runs["graph"], str(tmp / "port" / "ogbn_toy_hgt"),
                        eval_mode="sequential", max_eval_nodes=8,
                        log=lambda s: None, device="cpu")
    assert 0.0 <= res["acc"] <= 1.0 and res["n_eval"] > 0


def test_cli_trains_and_evaluates(tmp_path, monkeypatch, capsys):
    """``run ogbn_mag`` on a graph pickle trains and writes its checkpoints
    and jsonl; ``--plot`` without matplotlib says so after the run;
    ``eval_ogbn_mag --ckpt`` reads the best checkpoint back."""
    from pyhgt_tpu_torch import run

    g = toy_graph(container)
    g.save(str(tmp_path / "toy.pk"))
    flags = ["--data", str(tmp_path / "toy.pk"), "--device", "cpu",
             "--model_dir", str(tmp_path / "m"), "--task_name", "cli_toy",
             "--n_hid", "128", "--n_heads", "4", "--n_layers", "2",
             "--sample_depth", "2", "--sample_width", "8",
             "--batch_size", "8", "--node_cap", "64", "--no-native_sampler",
             "--n_batch", "2", "--repeat", "1", "--n_pool", "2",
             "--n_epoch", "1", "--vr_num", "1"]
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert run.main(["ogbn_mag", *flags, "--plot"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0: loss" in out and "test acc (variance_reduce)" in out
    assert "plot: not written, matplotlib is not installed" in out
    for name in ("cli_toy_hgt", "cli_toy_hgt_latest"):
        assert (tmp_path / "m" / name / "state.pt").exists()
    assert (tmp_path / "m" / "cli_toy_metrics.jsonl").exists()
    assert run.main(["eval_ogbn_mag", *flags, "--ckpt",
                     str(tmp_path / "m" / "cli_toy_hgt"),
                     "--task_type", "sequential"]) == 0
    assert "test acc (sequential)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--ckpt required"):
        run.main(["eval_ogbn_mag", *flags])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["ogbn_mag", *flags[:2]])


@pytest.mark.cuda
def test_cuda_run_matches_cpu(tmp_path):
    """A toy ``run_ogbn`` on the card under the slice's kernel flags
    against the same run on the CPU, both resumed from the same seeded
    weights, dropout 0: every epoch's loss within the bf16 edge stage's
    3e-2. Needs no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = toy_graph(container)
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = tiny_cfg(ExperimentConfig, model_dir=str(tmp_path / device),
                       **dict(RUN, n_epoch=2), **FLAGS)
        write_port_checkpoint(cfg, graph,
                              str(tmp_path / device / "ogbn_toy_hgt_latest"))
        out = run_ogbn(cfg, graph, log=lambda s: None, resume=True,
                       device=device, max_eval_nodes=8)
        losses[device] = [h["loss"] for h in out["history"]]
    assert len(losses["cuda"]) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=CUDA_TOL, atol=CUDA_TOL)


@pytest.mark.parametrize("module", ["experiment", "plot"])
def test_plot_history(tmp_path, monkeypatch, module):
    """Both plot helpers write a PNG; without matplotlib
    ``utils.experiment`` raises ImportError (``run --plot`` reports it) and
    ``utils.plot`` returns None."""
    import importlib
    import sys

    pytest.importorskip("matplotlib")
    mod = importlib.import_module(f"pyhgt_tpu_torch.utils.{module}")
    hist = [dict(epoch=i, loss=2.0 - 0.1 * i, valid_acc=0.1 + 0.05 * i)
            for i in range(3)]
    png = str(tmp_path / "curves.png")
    assert mod.plot_history(hist, png) == png
    assert (tmp_path / "curves.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    if module == "plot":
        assert mod.plot_history(hist, png) is None
    else:
        with pytest.raises(ImportError):
            mod.plot_history(hist, png)


def test_log_and_experiment_helpers(tmp_path, capsys):
    """``MetricsLogger`` appends stamped JSON lines; ``throughput`` counts
    each edge once per layer; ``debug_nans`` scopes autograd's anomaly
    mode; ``get_n_params``, ``args_print`` and ``randint``."""
    import json

    from pyhgt_tpu_torch.train.log import MetricsLogger, debug_nans, throughput
    from pyhgt_tpu_torch.utils.experiment import args_print, get_n_params, randint

    path = tmp_path / "sub" / "m.jsonl"
    with MetricsLogger(str(path), echo=True) as m:
        m.log("epoch", loss=np.float32(1.5), epoch=0)
        m.log("test", acc=0.25)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(x["event"], "t" in x) for x in lines] == [("epoch", True),
                                                       ("test", True)]
    assert lines[0]["loss"] == 1.5 and capsys.readouterr().out.count("\n") == 2
    assert throughput(1000, 4, 0.5) == {"edges_per_s": 8000.0,
                                        "step_ms": 500.0}
    was = torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    assert torch.is_anomaly_enabled() == was
    assert get_n_params(torch.nn.Linear(3, 2)) == 8
    args_print({"n_hid": 64, "dropout": 0.2})
    assert "n_hid    64" in capsys.readouterr().out
    assert 0 <= randint() < 2**31 - 1
