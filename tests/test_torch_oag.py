"""The port's OAG node-classification path (paper-field / paper-venue)
against the JAX package's: the OAG proxy graph and ``feature_oag``, the
time-split pairs, ``NodeClassificationTask.sample``, the ranking metrics,
the seeds-head forward, ``run_node_classification`` and the CLI tasks
``paper_field`` and ``paper_venue``.

The graph is ``tests/conftest.py``'s toy graph (``make_toy_graph(60, 30,
5, seed=2)``, which names its authors), written by the JAX package
(``save_dir``) and read by the port. The configuration is tiny (n_hid 32,
4 heads, 2 layers, depth 2, width 8, batch 8, f32, no kernel flags),
dropout 0 (the frameworks cannot draw the same masks), one loader worker
(the item order is fixed) and the numpy sampler on both sides. Both
runners start from the same weights with no knob of their own: the port's
seeded initial weights, carried into the flax layout by
``convert.named_to_flax``, are saved as both packages' ``latest``, and
both runs resume from it (so the JAX runner's own initialisation only
builds the tree's shapes: ``shape_only_init``).
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.convert import named_to_flax
from pyhgt_tpu_torch.datasets import features, oag_proxy
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.tasks.base import build_time_split_pairs, subsample_pairs
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.train import metrics
from pyhgt_tpu_torch.train.checkpoint import save_checkpoint
from pyhgt_tpu_torch.train.step import TrainState
from test_torch_ogbn import CUDA_TOL, LOSS_TOL, _record
from test_torch_sampler import _same, _same_graph, _same_sorted
from test_torch_serving import FLAGS

ROOT = Path(__file__).resolve().parents[1]
# the toy graph's label relation (each paper has one venue) and its reverse
LABEL = ("venue", "paper", "PV_in")
# f32 forward of the same weights: the packages sum in other orders
FWD_TOL = 1e-4
# the toy graph's input width (its 'emb' columns)
IN_DIM = 16


def n_classes(graph):
    """The label relation's candidates: venues with a paper."""
    return int((np.diff(graph.adj[LABEL].indptr) > 0).sum())


def small_cfg(cls, **kw):
    base = dict(
        n_hid=32, n_heads=4, n_layers=2, sample_depth=2, sample_width=8,
        batch_size=8, n_batch=2, repeat=1, n_pool=1, n_epoch=1,
        node_cap=64, edge_cap=128, native_sampler=False, max_lr=1e-2,
        dropout=0.0,
    )
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy graph as the JAX package built it, as the port reads it
    from the JAX package's ``save_dir``, and that directory."""
    pytest.importorskip("jax")
    from tests.conftest import make_toy_graph

    jgraph = make_toy_graph(n_paper=60, n_author=30, n_venue=5,
                            seed=2).freeze()
    path = tmp_path_factory.mktemp("toy") / "graph"
    jgraph.save_dir(str(path))
    return jgraph, CSRGraph.load_dir(str(path)), path


def record_metrics(mp, module, sink):
    """Record ``(ndcg, mrr, query rows)`` of every ``ranking_metrics`` call
    of ``module`` (validation first, then the test batches)."""
    inner = module.ranking_metrics

    def wrapped(scores, rel):
        out = inner(scores, rel)
        sink.append((*out, len(scores)))
        return out
    mp.setattr(module, "ranking_metrics", wrapped)


def shape_only_init(mp, model_cls):
    """Replace the flax ``model_cls.init`` by one that builds the parameter
    tree's shapes alone (zeros, by ``jax.eval_shape``). Every caller here
    restores each parameter from a checkpoint right after, so the JAX
    package's own random initialisation, eager and ~10 s of op compiles
    on the CPU, never reaches a compared number."""
    import jax

    inner = model_cls.init

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda k: inner(self, k, *args, **kw), rngs)
        return jax.tree_util.tree_map(
            lambda a: jax.numpy.zeros(a.shape, a.dtype), shapes)
    mp.setattr(model_cls, "init", init)


def jax_apply(model, params, *args, **kw):
    """``model.apply(params, *args, **kw)`` under ``jax.jit`` (one compile
    in place of eager op-by-op ones); the arguments other than ``params``
    are closed over."""
    import jax

    return jax.jit(lambda p: model.apply(p, *args, **kw))(params)


def run_both(jengine, jrun, run, jcfg, cfg, jgraph, graph, model, **kw):
    """Both runners resumed from ``model``'s weights (the port's, seeded),
    saved as each package's ``latest`` with a fresh optimizer, with the
    layouts, the producer items and the ranking-metric calls recorded on
    each side."""
    import jax
    from pyhgt_tpu.train.checkpoint import save_checkpoint as jax_save
    from pyhgt_tpu.train.step import TrainState as JaxState

    latest = f"{cfg.task_name}_{cfg.conv_name}_latest"
    steps = cfg.n_batch * cfg.repeat
    params = jax.tree_util.tree_map(
        jax.numpy.asarray, named_to_flax(dict(model.named_parameters())))
    jax_save(str(Path(jcfg.model_dir) / latest),
             JaxState.create(params, jengine.make_tx(jcfg, params, steps)))
    save_checkpoint(str(Path(cfg.model_dir) / latest), TrainState(
        model, engine.make_tx(cfg, model.named_parameters(), steps)))
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        shape_only_init(mp, jengine.NodeClassifierModel)
        shape_only_init(mp, jengine.LinkMatcherModel)
        for side, mod in (("jax", jengine), ("port", engine)):
            seen[side] = {"layouts": [], "items": [], "metrics": []}
            _record(mp, mod, "make_layout", seen[side]["layouts"])
            _record(mp, mod, "_make_producer", seen[side]["items"])
            record_metrics(mp, mod, seen[side]["metrics"])
        jout = jrun(jcfg, jgraph, log=lambda s: None, resume=True, **kw)
        logs = []
        out = run(cfg, graph, log=logs.append, resume=True, device="cpu",
                  **kw)
    return dict(params=params, jout=jout, out=out, logs=logs, seen=seen)


@pytest.fixture(scope="module")
def runs(toy, tmp_path_factory):
    """One paper-field-style ``run_node_classification`` of each package
    (KL over the multi-hot venue labels) from the same seeded weights."""
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments import engine as jengine

    jgraph, graph, _ = toy
    tmp = tmp_path_factory.mktemp("nc")
    jcfg = small_cfg(JaxConfig, model_dir=str(tmp / "jax"),
                     task_name="pf_toy")
    cfg = small_cfg(ExperimentConfig, model_dir=str(tmp / "port"),
                    task_name="pf_toy")
    model = engine.node_classifier(
        cfg, engine.make_layout(cfg, graph), IN_DIM, n_classes(graph),
        head_mode="seeds")
    res = run_both(jengine, jengine.run_node_classification,
                   engine.run_node_classification, jcfg, cfg, jgraph, graph,
                   model, label_meta=LABEL, multi_label=True)
    return dict(res, model=model, cfg=cfg, jcfg=jcfg, tmp=tmp)


def check_layouts(seen):
    (jl,), (pl,) = seen["jax"]["layouts"], seen["port"]["layouts"]
    assert (pl.pad.node_cap, pl.pad.default_edge_cap, pl.pad.edge_caps) == (
        jl.pad.node_cap, jl.pad.default_edge_cap, jl.pad.edge_caps)
    assert [dataclasses.astuple(b) for b in pl.blocks] == [
        dataclasses.astuple(b) for b in jl.blocks]


def check_items(seen, n_min, fields):
    """Item by item (one worker: the per-job seeds come in the same
    order): every array of the task batch (``fields`` beside ``sub``) and
    of its SortedEdges, and the host counts."""
    jitems, pitems = seen["jax"]["items"], seen["port"]["items"]
    n = min(len(jitems), len(pitems))
    assert n >= n_min
    for i, (p, j) in enumerate(zip(pitems[:n], jitems[:n])):
        for f in dataclasses.fields(p.tb.sub):
            _same(getattr(p.tb.sub, f.name), getattr(j.tb.sub, f.name),
                  f"item {i} sub.{f.name}")
        for name in fields:
            _same(getattr(p.tb, name), getattr(j.tb, name), f"item {i} {name}")
        _same_sorted(p.se, j.se, f"item {i} se.")
        assert (p.n_edges, p.overflow) == (j.n_edges, j.overflow)


def check_metrics(seen):
    """The validation batch's and the 10 test batches' NDCG and MRR, call
    by call: the same query rows, each within one query's worth."""
    pm, jm = seen["port"]["metrics"], seen["jax"]["metrics"]
    assert len(pm) == len(jm) == 11
    for (pn, pr, pq), (jn, jr, jq) in zip(pm, jm):
        assert pq == jq > 0
        assert abs(pn - jn) * pq <= 1 + 1e-9
        assert abs(pr - jr) * pq <= 1 + 1e-9


def test_proxy_and_features_match_example():
    """The proxy copy equals ``examples/oag_scale_proxy.py``'s ``build`` at
    scale 0.001 array for array; ``feature_oag`` (zeros path for papers,
    ``node_emb`` for authors), ``feature_mag``, ``oag_in_dim`` and
    ``texts_oag`` equal the JAX package's on it, bit for bit."""
    pytest.importorskip("jax")
    from pyhgt_tpu.datasets import features as jfeatures

    spec = importlib.util.spec_from_file_location(
        "oag_scale_proxy", ROOT / "examples" / "oag_scale_proxy.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    j = example.build(0.001, seed=3)
    g = oag_proxy.build(0.001, seed=3)
    _same_graph(g, j)
    ids = np.array([0, 5, 3, 15, 5])
    for t in g.schema.node_types:
        for name in ("feature_oag", "feature_mag"):
            _same(getattr(features, name)(g, t, ids),
                  getattr(jfeatures, name)(j, t, ids), f"{name} {t}")
    assert features.feature_oag(g, "paper", ids).shape == (
        5, features.oag_in_dim(g)) == (5, 529)
    assert features.oag_in_dim(g) == jfeatures.oag_in_dim(j)
    for graph in (g, j):
        graph.features["paper"]["title"] = np.array(
            [f"title {i}" for i in range(g.num_nodes["paper"])])

    class Sample:
        node_ids = {"paper": np.array([4, 1])}
    _same(features.texts_oag(g, Sample), jfeatures.texts_oag(j, Sample),
          "titles")
    assert features.texts_oag(g, Sample).tolist() == ["title 4", "title 1"]
    assert features.texts_oag(g, Sample, text_type="author").size == 0


def test_time_split_pairs_bit_equal(toy):
    """``build_time_split_pairs`` over the OAG split, then
    ``subsample_pairs`` at fractions 1 and 0.5: the same dicts, in the same
    order."""
    from pyhgt_tpu.experiments.engine import OAG_SPLITS as JSPLITS
    from pyhgt_tpu.tasks.base import build_time_split_pairs as jpairs
    from pyhgt_tpu.tasks.base import subsample_pairs as jsub

    jgraph, graph, _ = toy
    rev = ("paper", "venue", "rev_PV_in")
    got = build_time_split_pairs(graph, rev, engine.OAG_SPLITS)
    want = jpairs(jgraph, rev, JSPLITS)
    assert list(got) == list(want) == ["train", "valid", "test"]
    for k in got:
        assert list(got[k].items()) == list(want[k].items()) and got[k]
        for fraction in (1.0, 0.5):
            sub = subsample_pairs(got[k], fraction, 43)
            assert list(sub.items()) == list(
                jsub(want[k], fraction, 43).items())
            assert len(sub) == (len(got[k]) if fraction == 1.0
                                else int(len(got[k]) * fraction))


def test_node_task_sample_bit_equal(toy):
    """``NodeClassificationTask.sample`` under equal generators, with
    multi-hot (KL) and class-index (NLL) labels: the padded batch, the
    labels (normalised multi-hot rows or class indices), the label mask
    and the target ids, with the leakage masks applied."""
    from pyhgt_tpu.experiments import engine as jengine
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.tasks.node_classification import (
        NodeClassificationTask as JaxTask,
    )

    jgraph, graph, _ = toy
    for multi_label in (True, False):
        tasks = []
        for mod, task_cls, cfg, g in (
                (jengine, JaxTask, small_cfg(JaxConfig), jgraph),
                (engine, NodeClassificationTask, small_cfg(ExperimentConfig),
                 graph)):
            tasks.append(task_cls(
                graph=g, sampler=mod.make_sampler(cfg, g),
                layout=mod.make_layout(cfg, g), target_type="paper",
                label_meta=LABEL, batch_size=8, multi_label=multi_label))
        jtask, task = tasks
        _same(task.cand_list, jtask.cand_list, "cand_list")
        assert task.rev_label_meta == jtask.rev_label_meta
        pairs = build_time_split_pairs(graph, task.rev_label_meta,
                                       engine.OAG_SPLITS)["train"]
        for seed in (0, 1):
            tb = task.sample(pairs, engine.OAG_SPLITS["train"],
                             np.random.default_rng(seed))
            jtb = jtask.sample(pairs, jengine.OAG_SPLITS["train"],
                               np.random.default_rng(seed))
            for f in dataclasses.fields(tb.sub):
                _same(getattr(tb.sub, f.name), getattr(jtb.sub, f.name),
                      f.name)
            for name in ("labels", "label_mask", "target_ids"):
                _same(getattr(tb, name), getattr(jtb, name), name)
        if multi_label:
            live = tb.labels[tb.label_mask]
            np.testing.assert_allclose(live.sum(1), 1.0, rtol=1e-6)
        else:
            assert tb.labels.dtype == np.int32


def test_ranking_metrics_match():
    """``ranking_metrics`` and its parts against the JAX package's on
    random graded and binary relevance, within 1e-12."""
    from pyhgt_tpu.train import metrics as jmetrics

    r = np.random.default_rng(7)
    scores = r.normal(size=(16, 12))
    for rel in (r.integers(0, 3, size=(16, 12)).astype(np.float64),
                (r.random((16, 12)) < 0.2).astype(np.float64)):
        np.testing.assert_allclose(metrics.ranking_metrics(scores, rel),
                                   jmetrics.ranking_metrics(scores, rel),
                                   rtol=1e-12, atol=1e-12)
        for row in rel:
            assert abs(metrics.ndcg_at_k(row, 5)
                       - jmetrics.ndcg_at_k(row, 5)) <= 1e-12
            assert metrics.dcg_at_k(row, 12) == jmetrics.dcg_at_k(row, 12)
        assert metrics.mean_reciprocal_rank(rel) == \
            jmetrics.mean_reciprocal_rank(rel)
    assert metrics.ndcg_at_k(np.zeros(4), 4) == 0.0


def test_seeds_head_forward_matches_jax(toy, runs):
    """The runs' initial weights in the JAX package's seeds-head
    ``NodeClassifierModel`` and in the port's: the log-probs of a
    validation batch's seed rows agree within 1e-4 (f32); the port's head
    reads the seed rows of ``representations``."""
    from pyhgt_tpu.experiments import engine as jengine
    from pyhgt_tpu.models import NodeClassifierModel as JaxModel
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
    from pyhgt_tpu.sampling.sorted_batch import sort_batch as jsort
    from pyhgt_tpu.tasks.node_classification import (
        NodeClassificationTask as JaxTask,
    )
    from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
    from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch

    jgraph, graph, _ = toy
    jcfg, cfg = runs["jcfg"], runs["cfg"]
    jl = jengine.make_layout(jcfg, jgraph)
    jem = JaxMeta.from_layout(jl)
    jtask = JaxTask(graph=jgraph, sampler=jengine.make_sampler(jcfg, jgraph),
                    layout=jl, target_type="paper", label_meta=LABEL,
                    batch_size=8)
    pairs = build_time_split_pairs(graph, jtask.rev_label_meta,
                                   engine.OAG_SPLITS)["valid"]
    jtb = jtask.sample(pairs, jengine.OAG_SPLITS["valid"],
                       np.random.default_rng(4))
    jmodel = JaxModel(gnn_kwargs=jengine.gnn_kwargs(jcfg, jl, IN_DIM),
                      n_classes=jtask.n_classes, target_type_id=0,
                      head_mode="seeds", n_seed=8)
    want = np.asarray(jax_apply(jmodel, runs["params"], *jtb.batch_args,
                                jem, se=jsort(jtb.sub, jl, jem)))
    layout = engine.make_layout(cfg, graph)
    em = EdgeStaticMeta.from_layout(layout)
    model = engine.node_classifier(cfg, layout, IN_DIM, jtask.n_classes,
                                   head_mode="seeds")
    sub = jtb.sub
    args = (torch.as_tensor(np.asarray(sub.node_feat)),
            torch.as_tensor(np.asarray(sub.node_mask)),
            sort_batch(sub, layout, em, with_backward=False).to(
                torch.device("cpu")), em)
    got = engine.make_eval_step(model)(*args).numpy()
    assert got.shape == want.shape == (8, jtask.n_classes)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # the head reads the first batch_size rows of the paper block of
    # ``representations`` (seeds first)
    with torch.inference_mode():
        reps = model.representations(*args)
        assert tuple(reps.shape) == (layout.num_types, layout.node_cap,
                                     cfg.n_hid)
        np.testing.assert_array_equal(model.clf(reps[0, :8]).numpy(), got)


def test_node_classification_layouts_and_items_equal(runs):
    check_layouts(runs["seen"])
    check_items(runs["seen"], runs["cfg"].n_batch,
                ("labels", "label_mask", "target_ids"))


def test_node_classification_loss_and_metrics_match(runs):
    """The epoch's train loss within 1e-4; validation and test NDCG/MRR
    batch by batch within one query's worth; the JAX history's keys, and
    the port's step timing beside them."""
    (h,), (jh,) = runs["out"]["history"], runs["jout"]["history"]
    assert h["epoch"] == jh["epoch"] == 0
    assert set(jh) <= set(h)
    assert abs(h["loss"] - jh["loss"]) <= LOSS_TOL
    assert (h["edges"], h["edges_dropped"]) == (jh["edges"],
                                                jh["edges_dropped"])
    check_metrics(runs["seen"])
    n_test = runs["seen"]["port"]["metrics"][1][2]
    for key in ("test_ndcg", "test_mrr"):
        assert abs(runs["out"][key] - runs["jout"][key]) * n_test <= 1 + 1e-9
    assert h["step_ms"] is not None and h["wait_ms"] >= 0


def test_node_classification_resume_and_checkpoints(runs, toy):
    """The run resumed at epoch 0 and wrote the best and latest
    checkpoints and the metrics jsonl; resuming with more epochs trains
    only the epochs after the last one."""
    cfg, tmp = runs["cfg"], runs["tmp"]
    assert any("resumed" in s and "epoch 0" in s for s in runs["logs"])
    for name in ("pf_toy_hgt", "pf_toy_hgt_latest"):
        assert (tmp / "port" / name / "state.pt").exists()
    lines = (tmp / "port" / "pf_toy_metrics.jsonl").read_text().splitlines()
    assert [l.split('"event": "')[1].split('"')[0] for l in lines] == [
        "epoch", "test"]
    logs = []
    out = engine.run_node_classification(
        cfg.replace(n_epoch=2), toy[1], label_meta=LABEL, log=logs.append,
        resume=True, device="cpu")
    assert any("resumed" in s and "epoch 1" in s for s in logs)
    assert [h["epoch"] for h in out["history"]] == [1]
    assert 0.0 <= out["test_ndcg"] <= 1.0


@pytest.fixture(scope="module")
def proxy_dir(tmp_path_factory):
    """The OAG proxy at scale 0.001 (544 papers), in a ``save_dir``."""
    path = tmp_path_factory.mktemp("proxy") / "graph"
    oag_proxy.build(0.001, seed=0).save_dir(str(path))
    return path


CLI_FLAGS = ["--device", "cpu", "--n_hid", "32", "--n_heads", "4",
             "--n_layers", "2", "--sample_depth", "2", "--sample_width", "8",
             "--batch_size", "8", "--node_cap", "64", "--no-native_sampler",
             "--n_batch", "2", "--repeat", "1", "--n_pool", "2",
             "--n_epoch", "1"]


def test_cli_trains_on_the_proxy(proxy_dir, tmp_path, capsys):
    """``run paper_field`` and ``paper_venue`` on the OAG proxy with each
    task's default label relation and ``--features oag`` (529-wide input):
    an epoch, the test metrics and both checkpoints; without a GPU the
    default device raises; ``preprocess_oag`` reads its ``--input_dir``
    (here one without the TSVs)."""
    from pyhgt_tpu_torch import run

    flags = ["--data", str(proxy_dir), "--model_dir", str(tmp_path),
             *CLI_FLAGS]
    for task in ("paper_field", "paper_venue"):
        assert run.main([task, *flags]) == 0
        out = capsys.readouterr().out
        assert "epoch 0: loss" in out and "test NDCG" in out
        assert "model parameters" in out
        for name in (f"{task}_hgt", f"{task}_hgt_latest"):
            assert (tmp_path / name / "state.pt").exists()
        state = torch.load(tmp_path / f"{task}_hgt" / "state.pt",
                           weights_only=True)
        assert state["model"]["gnn.adapt_w"].shape[1] == 529
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["paper_venue", "--data", str(proxy_dir)])
    with pytest.raises(FileNotFoundError, match="PR_CS_20190919.tsv"):
        run.main(["preprocess_oag", "--input_dir", str(proxy_dir)])


@pytest.mark.cuda
def test_cuda_node_classification_matches_cpu(tmp_path):
    """A toy ``run_node_classification`` on the card under the slice's
    kernel flags against the same run on the CPU, both resumed from the
    same seeded weights, dropout 0: the epoch's loss within the bf16 edge
    stage's 3e-2. Needs no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pyhgt_tpu_torch.graph import container
    from test_torch_serving import toy_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = toy_graph(container)
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = small_cfg(ExperimentConfig, model_dir=str(tmp_path / device),
                        task_name="pf_toy", n_hid=128, **FLAGS)
        layout = engine.make_layout(cfg, graph)
        model = engine.node_classifier(cfg, layout, IN_DIM, n_classes(graph),
                                       seed=1, head_mode="seeds")
        save_checkpoint(str(tmp_path / device / "pf_toy_hgt_latest"),
                        TrainState(model, engine.make_tx(
                            cfg, model.named_parameters(), 1)))
        out = engine.run_node_classification(
            cfg.replace(n_epoch=2), graph, label_meta=LABEL,
            log=lambda s: None, resume=True, device=device)
        losses[device] = [h["loss"] for h in out["history"]]
    assert len(losses["cuda"]) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=CUDA_TOL, atol=CUDA_TOL)
