"""The port's serving path against the JAX package's: checkpoint restore,
``OgbnPredictor`` and its transports.

The graph is the JAX tests' toy graph (``tests/test_experiments.py``: 60
papers, 30 authors, 5 venues, labels over 4 classes), built here through
either package's ``Graph`` container; the configuration is their
``_tiny_cfg`` (4 heads, 2 layers, sample depth 2, width 8, batch 8, node
cap 64, edge cap 128) with ``n_hid`` 128, so that the wide segment sums of
the slice's flags take the ``live_partials`` path (it needs D >= 128). The
JAX package is imported inside fixtures: on a machine without it the
CUDA-marked cases still run.
"""

import dataclasses
import io
import json
import threading
import warnings
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.experiments.engine import (
    make_layout, make_tx, node_classifier,
)
from pyhgt_tpu_torch.experiments import serving
from pyhgt_tpu_torch.experiments.serving import (
    OgbnPredictor, node_answer, serve_http, serve_jsonl,
)
from pyhgt_tpu_torch.graph import container
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.train.checkpoint import (
    BestCheckpointPolicy, load_checkpoint, save_checkpoint,
)
from pyhgt_tpu_torch.train.step import TrainState

FLAGS = dict(seg_pallas=True, edge_bf16=True, softmax_pallas=True)
# f32: the packages sum in other orders (~1e-5 on one log-prob); the
# slice's flags round every per-edge tensor to bf16 (2^-8), on the JAX side
# maybe after other fusions; the log-probs are accumulated over 2 resamples
TOL = {"f32": 1e-4, "flags": 3e-2}
NODES = [3, 17, 42]


def toy_graph(mod):
    """``tests/conftest.py``'s ``make_toy_graph(60, 30, 5, seed=2)`` through
    ``mod.Graph`` (either package's container), with
    ``tests/test_experiments.py``'s ogbn labels and splits, frozen."""
    r = np.random.default_rng(2)
    g = mod.Graph()
    n_paper, n_author, n_venue = 60, 30, 5
    papers = [{"id": f"p{i}", "type": "paper"} for i in range(n_paper)]
    authors = [{"id": f"a{i}", "type": "author"} for i in range(n_author)]
    venues = [{"id": f"v{i}", "type": "venue"} for i in range(n_venue)]
    years = r.integers(2000, 2020, size=n_paper)
    for i, p in enumerate(papers):
        t = int(years[i])
        for a in r.choice(n_author, size=r.integers(1, 4), replace=False):
            g.add_edge(authors[a], p, time=t, relation_type="AP_write")
        v = int(r.integers(0, n_venue))
        g.add_edge(p, venues[v], time=t, relation_type="PV_in")
        for j in r.choice(n_paper, size=r.integers(0, 3), replace=False):
            if j != i:
                g.add_edge(papers[int(j)], p, time=t, relation_type="PP_cite")
    for t, n in (("paper", n_paper), ("author", n_author), ("venue", n_venue)):
        g.set_features(t, {"emb": r.normal(size=(n, 16)).astype(np.float32)})
    csr = g.freeze()
    rng = np.random.default_rng(0)
    csr.aux.update(
        y=rng.integers(0, 4, n_paper), years=np.full(n_paper, 2015),
        train_mask=rng.random(n_paper) < 0.5,
        valid_mask=rng.random(n_paper) < 0.3,
        test_mask=rng.random(n_paper) < 0.3,
    )
    return csr


def tiny_cfg(cls, **kw):
    base = dict(
        n_hid=128, n_heads=4, n_layers=2, sample_depth=2, sample_width=8,
        batch_size=8, n_batch=2, repeat=1, n_pool=2, n_epoch=2,
        node_cap=64, edge_cap=128, native_sampler=False, max_lr=1e-2,
        vr_num=2,
    )
    base.update(kw)
    return cls(**base)


def write_port_checkpoint(cfg, graph, path, seed=1):
    """A port checkpoint of a seeded NodeClassifierModel under ``cfg``."""
    layout = make_layout(cfg, graph)
    model = node_classifier(cfg, layout, graph.features["paper"]["emb"].shape[1],
                            int(graph.aux["y"].max()) + 1, seed=seed)
    save_checkpoint(path, TrainState(model, make_tx(cfg, model.named_parameters(), 1)))
    return model


@pytest.fixture(scope="module")
def port_env(tmp_path_factory):
    """A CPU predictor of the port over the port-built toy graph and a
    port checkpoint."""
    graph = toy_graph(container)
    cfg = tiny_cfg(ExperimentConfig, **FLAGS)
    path = str(tmp_path_factory.mktemp("ckpt") / "node")
    write_port_checkpoint(cfg, graph, path)
    return cfg, graph, path, OgbnPredictor(cfg, graph, path,
                                           log=lambda s: None, device="cpu")


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The toy graph written by the JAX package (``save_dir``), and a JAX
    checkpoint of a seeded ``TrainState`` as ``run_ogbn`` would leave it:
    the port reads the graph through its module-mapping unpickler, and the
    weights through ``convert.checkpoint_from_flax`` of the JAX predictor's
    restored parameters."""
    jax = pytest.importorskip("jax")
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments.engine import (
        _infer_in_dim, gnn_kwargs, make_layout as jax_layout, make_sampler,
        make_tx as jax_tx,
    )
    from pyhgt_tpu.graph import container as jax_container
    from pyhgt_tpu.models import NodeClassifierModel
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta
    from pyhgt_tpu.sampling.sorted_batch import sort_batch
    from pyhgt_tpu.tasks import OgbnNodeTask
    from pyhgt_tpu.train.checkpoint import save_checkpoint as jax_save
    from pyhgt_tpu.train.step import TrainState as JaxState

    tmp = tmp_path_factory.mktemp("jax")
    jgraph = toy_graph(jax_container)
    jgraph.save_dir(str(tmp / "graph"))
    cfg = tiny_cfg(JaxConfig)
    layout = jax_layout(cfg, jgraph)
    em = EdgeStaticMeta.from_layout(layout)
    task = OgbnNodeTask(graph=jgraph, sampler=make_sampler(cfg, jgraph),
                        layout=layout, batch_size=cfg.batch_size)
    tb0 = task.sample(np.arange(4), np.random.default_rng(0))
    model = NodeClassifierModel(
        gnn_kwargs=gnn_kwargs(cfg, layout, _infer_in_dim(tb0)),
        n_classes=task.n_classes, target_type_id=0, head_mode="full")
    se0 = sort_batch(tb0.sub, layout, em)
    params = jax.jit(lambda k: model.init(k, *tb0.batch_args, em, se=se0))(
        jax.random.PRNGKey(123))
    ckpt = str(tmp / "ckpt")
    jax_save(ckpt, JaxState.create(params, jax_tx(cfg, params, 1)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return JaxConfig, jgraph, ckpt, CSRGraph.load_dir(str(tmp / "graph")), tree


@pytest.mark.parametrize("name", ["f32", "flags"])
def test_predictor_matches_jax(jax_env, tmp_path, name):
    """JAX checkpoint -> JAX ``OgbnPredictor`` restores it ->
    ``convert.checkpoint_from_flax`` -> the port's ``OgbnPredictor`` on the
    CPU: the same accumulated log-probs for the same request and generator
    (the numpy sampler under f32, the C++ one under the slice's flags)."""
    from pyhgt_tpu.experiments.serving import OgbnPredictor as JaxPredictor
    from pyhgt_tpu_torch.convert import checkpoint_from_flax, flax_to_state_dict

    JaxConfig, jgraph, ckpt, graph, tree = jax_env
    flags = dict(FLAGS, native_sampler=True) if name == "flags" else {}
    jpred = JaxPredictor(tiny_cfg(JaxConfig, **flags), jgraph, ckpt,
                         log=lambda s: None)
    path = str(tmp_path / "port")
    checkpoint_from_flax(jpred.params, path, step=int(jpred.state.step))
    # the JAX restore is exact, and the tree maps key for key onto the
    # port's model (the port's restore is strict)
    restored = flax_to_state_dict(jpred.params)
    for k, v in flax_to_state_dict(tree).items():
        assert torch.equal(restored[k], v), k
    pred = OgbnPredictor(tiny_cfg(ExperimentConfig, **flags), graph, path,
                         log=lambda s: None, device="cpu")
    assert type(pred.task.sampler).__name__ == (
        "NativeHGSampler" if name == "flags" else "HGSampler")
    want = jpred.predict_logprobs(NODES, rng=np.random.default_rng(5))
    got = pred.predict_logprobs(NODES, rng=np.random.default_rng(5))
    assert got.shape == (3, pred.n_classes) == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[name], atol=TOL[name])
    assert len(pred.stats) == pred.cfg.vr_num
    assert all(s["edges"] > 0 and s["sort_ms"] >= 0 for s in pred.stats)


def test_checkpoint_restores_bit_equal_and_strictly(port_env, tmp_path):
    cfg, graph, path, pred = port_env
    model = write_port_checkpoint(cfg, graph, str(tmp_path / "again"))
    for k, v in model.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k
    # a trained state round-trips with its optimizer moments and step
    opt = make_tx(cfg, model.named_parameters(), 1)
    state = TrainState(model, opt)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    policy = BestCheckpointPolicy(str(tmp_path / "best"))
    assert policy.update(0.5, state) and not policy.update(0.4, state)
    fresh = write_port_checkpoint(cfg, graph, str(tmp_path / "x"), seed=9)
    back = load_checkpoint(str(tmp_path / "best"),
                           TrainState(fresh, make_tx(cfg, fresh.named_parameters(), 1)))
    assert back.step == 1
    assert torch.equal(back.model.gnn.adapt_w, model.gnn.adapt_w)
    assert back.optimizer.inner.state_dict()["state"].keys() == \
        opt.inner.state_dict()["state"].keys()
    # strict: a checkpoint of another width (missing / extra / reshaped
    # parameters) raises
    wide = dataclasses.replace(cfg, n_layers=3)
    write_port_checkpoint(wide, graph, str(tmp_path / "wide"))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_checkpoint(str(tmp_path / "wide"),
                        TrainState(fresh, make_tx(cfg, fresh.named_parameters(), 1)))
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path / "best"), state, force=False)


def test_predict_determinism_duplicates_and_vr_clamp(port_env):
    """As ``tests/test_experiments.py``'s serving test: deterministic per
    rng, duplicated ids answer identically, ``vr_num=0`` clamps to 1."""
    _, _, _, pred = port_env
    lp = pred.predict_logprobs(NODES, rng=np.random.default_rng(5))
    assert lp.shape == (3, pred.n_classes)
    assert np.isfinite(lp).all() and (lp <= 0).all()
    labels = pred.predict(NODES, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(labels, np.argmax(lp, axis=-1))
    np.testing.assert_array_equal(
        lp, pred.predict_logprobs(NODES, rng=np.random.default_rng(5)))
    lp_dup = pred.predict_logprobs([17, 3, 17], rng=np.random.default_rng(5))
    np.testing.assert_array_equal(lp_dup[0], lp_dup[2])
    assert (lp_dup < 0).all()
    lp0 = pred.predict_logprobs([3], vr_num=0, rng=np.random.default_rng(5))
    assert (lp0 < 0).all()


class _CountingPredictor:
    """Wraps a predictor and records each ``predict_logprobs`` call."""

    def __init__(self, pred):
        self.pred, self.calls = pred, []
        self.n_classes = pred.n_classes

    def predict_logprobs(self, nodes, vr_num=None, rng=None):
        self.calls.append(list(nodes))
        if 10**9 in list(nodes):
            raise ValueError("node out of range")
        return self.pred.predict_logprobs(nodes, vr_num=vr_num, rng=rng)


@pytest.mark.parametrize("mode", ["plain", "coalesced", "adaptive"])
def test_serve_jsonl(port_env, mode):
    """Plain: one call per line, a malformed line answers an error.
    Coalesced (fixed window) and adaptive: a burst answers in request
    order; a fixed window folds the burst into one call; a poison request
    errors alone."""
    _, _, _, pred = port_env
    wrapped = _CountingPredictor(pred)
    out = io.StringIO()
    lines = ('{"nodes": [3], "vr_num": 1}\n{"nodes": [17, 42], "vr_num": 1}\n'
             'bad json\n{"nodes": [1000000000], "vr_num": 1}\n')
    wait = {"plain": 0.0, "coalesced": 0.5, "adaptive": "auto"}[mode]
    served = serve_jsonl(wrapped, stdin=io.StringIO(lines), stdout=out,
                         log=lambda s: None, coalesce_wait=wait)
    assert served == 4
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    assert got[0]["nodes"] == [3] and got[1]["nodes"] == [17, 42]
    assert all(0 <= p < pred.n_classes for x in got[:2] for p in x["pred"])
    assert "error" in got[2] and "error" in got[3]
    if mode == "coalesced":
        assert wrapped.calls[0] == [3, 17, 42, 10**9]
    if mode == "plain":
        assert wrapped.calls == [[3], [17, 42], [10**9]]


@pytest.mark.parametrize("wait", [0.0, 0.05, "auto"])
def test_deadline_ignored_under_a_fixed_window_warns(port_env, wait):
    """``deadline_ms`` caps adaptive coalescing only: under a fixed window
    (plain or coalesced) a warning and a log line say it is ignored, and
    the requests are still answered; under ``"auto"`` nothing is said."""
    _, _, _, pred = port_env
    logs, out = [], io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        served = serve_jsonl(pred, stdin=io.StringIO('{"nodes": [3]}\n'),
                             stdout=out, log=logs.append,
                             coalesce_wait=wait, deadline_ms=25)
    assert served == 1 and "pred" in json.loads(out.getvalue())
    said = [w for w in caught if "deadline_ms" in str(w.message)]
    if wait == "auto":
        assert not said and not any("deadline" in s for s in logs)
    else:
        assert len(said) == 1 and said[0].category is RuntimeWarning
        assert "ignored" in str(said[0].message)
        assert any(s.startswith("WARNING: deadline_ms=25 is ignored")
                   for s in logs)


def test_predictor_stats_stay_bounded(port_env, monkeypatch):
    """A long-lived predictor keeps the records of its last
    ``STATS_KEEP`` forwards only; the newest record is the last one, and
    a request still writes its ``sample_ms`` into it. The forward's model
    call is stubbed, so the test runs many forwards cheaply."""
    _, _, _, pred = port_env
    keep = 5
    monkeypatch.setattr(serving, "STATS_KEEP", keep)
    monkeypatch.setattr(
        serving, "sorted_logprobs",
        lambda fwd, nf, nmk, se, em, dev, edges=None: np.zeros(
            (pred.layout.node_cap, pred.n_classes), np.float32))
    pred.stats.clear()
    for i in range(1, 4):
        pred.predict_logprobs(NODES, vr_num=4, rng=np.random.default_rng(1))
        assert len(pred.stats) == min(4 * i, keep)
    assert "sample_ms" in pred.stats[-1]
    assert all(s["edges"] > 0 for s in pred.stats[-keep:])
    pred.stats.clear()


def test_serve_http(port_env):
    _, _, _, pred = port_env
    srv = serve_http(node_answer(pred), port=0, log=lambda s: None)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        req = urllib.request.Request(
            base, data=b'{"nodes": [3, 17], "vr_num": 1}',
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["nodes"] == [3, 17] and len(body["logp"]) == 2
        assert all(0 <= p < pred.n_classes for p in body["pred"])
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base, data=b"not json"), timeout=30)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    finally:
        srv.shutdown()
        srv.server_close()


def test_run_serve_cli(port_env, tmp_path, monkeypatch):
    """``run.main(["serve", ...])`` answers JSON-lines on stdout;
    ``preprocess_oag`` reads its ``--input_dir`` (here one without the
    TSVs); without ``--device`` and without a GPU
    ``serve``, ``paper_field`` and ``serve --serve_task link`` raise instead
    of running on the CPU."""
    from pyhgt_tpu_torch import run

    cfg, graph, path, _ = port_env
    graph.save_dir(str(tmp_path / "graph"))
    argv = ["serve", "--data", str(tmp_path / "graph"), "--ckpt", path,
            "--n_hid", "128", "--n_heads", "4", "--n_layers", "2",
            "--sample_depth", "2", "--sample_width", "8", "--batch_size", "8",
            "--node_cap", "64", "--edge_cap", "128", "--no-prev_norm",
            "--no-last_norm", "--seg_pallas", "--edge_bf16",
            "--softmax_pallas", "--vr_num", "1"]
    out = io.StringIO()
    monkeypatch.setattr("sys.stdin", io.StringIO(
        '{"nodes": [1, 2]}\n{"nodes": [5], "vr_num": 2}\n'))
    monkeypatch.setattr("sys.stdout", out)
    assert run.main(argv + ["--device", "cpu"]) == 0
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [len(x["pred"]) for x in got] == [2, 1]
    assert all(0 <= p < 4 for x in got for p in x["pred"])
    with pytest.raises(FileNotFoundError, match="PR_CS_20190919.tsv"):
        run.main(["preprocess_oag", "--input_dir", str(tmp_path / "graph")])
    if not torch.cuda.is_available():
        for task in (argv, ["paper_field", "--data", str(tmp_path / "graph")],
                     ["serve", "--serve_task", "link", "--ckpt", path,
                      "--data", str(tmp_path / "graph")]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run.main(task)


@pytest.mark.cuda
def test_cuda_predictor_matches_cpu(port_env):
    """The predictor on the card against the CPU predictor: the same
    sampled subgraphs, log-probs within the bf16 edge stage's 3e-2, and
    ``live_partials`` and ``segment_softmax_partials`` each launched once
    per layer per forward and no other kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pyhgt_tpu_torch.ops import pallas_seg as ps

    cfg, graph, path, cpu = port_env
    gpu = OgbnPredictor(cfg, graph, path, log=lambda s: None, device="cuda")
    counters = (ps.live_partials, ps.segment_softmax_partials,
                ps.live_partials_pair, ps.live_partials_slab,
                ps.live_partials_weighted, ps.head_sum_product)
    for fn in counters:
        fn.launches = 0
    gpu.stats.clear()
    got = gpu.predict_logprobs(NODES, rng=np.random.default_rng(5))
    forwards = len(gpu.stats)
    assert forwards == cfg.vr_num
    assert [fn.launches for fn in counters] == [
        cfg.n_layers * forwards, cfg.n_layers * forwards, 0, 0, 0, 0]
    want = cpu.predict_logprobs(NODES, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(gpu.last_batch.target_ids,
                                  cpu.last_batch.target_ids)
    np.testing.assert_allclose(got, want, rtol=TOL["flags"],
                               atol=TOL["flags"])
