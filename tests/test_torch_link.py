"""The port's author-disambiguation link path against the JAX package's:
the name groups, link pairs and ``LinkPredictionTask.sample``,
``LinkMatcherModel.score_pairs`` and the grouped listwise loss,
``MatcherIndex``, ``run_author_disambiguation``, ``LinkPredictor.topk``,
the link transports and the CLI tasks ``author_disambiguation`` and
``serve --serve_task link``.

The graph, the configuration and the way both runners start from the
same weights are ``tests/test_torch_oag.py``'s: the toy graph's
authorship relation ``AP_write`` stands in for OAG's
``AP_write_first`` (``first_meta`` ``rev_AP_write``), as in the JAX
package's own tests; groups are padded to 8 candidates.
"""

import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.convert import checkpoint_from_flax, flax_to_state_dict
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.experiments.serving import (
    LinkPredictor,
    _answer_link_batch,
    serve_link_jsonl,
)
from pyhgt_tpu_torch.tasks.link_prediction import (
    LinkPredictionTask,
    build_link_pairs,
    build_name_groups,
    grouped_listwise_loss,
)
from pyhgt_tpu_torch.tasks.matcher_index import MatcherIndex
from test_torch_ogbn import CUDA_TOL, LOSS_TOL
from test_torch_oag import (
    FWD_TOL, IN_DIM, check_items, check_layouts, check_metrics, jax_apply,
    run_both, shape_only_init, small_cfg, toy,  # noqa: F401  (the fixture)
)
from test_torch_sampler import _same
from test_torch_serving import FLAGS

METAS = dict(first_meta=("author", "paper", "rev_AP_write"),
             write_meta=("paper", "author", "AP_write"))
MAX_GROUP = 8
# top-k scores of the same index and queries: f32 products in another order
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def runs(toy, tmp_path_factory):  # noqa: F811
    """One ``run_author_disambiguation`` of each package from the same
    seeded weights."""
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments import engine as jengine

    jgraph, graph, _ = toy
    tmp = tmp_path_factory.mktemp("link")
    jcfg = small_cfg(JaxConfig, model_dir=str(tmp / "jax"),
                     task_name="ad_toy")
    cfg = small_cfg(ExperimentConfig, model_dir=str(tmp / "port"),
                    task_name="ad_toy")
    model = engine.link_matcher(cfg, engine.make_layout(cfg, graph), IN_DIM)
    res = run_both(jengine, jengine.run_author_disambiguation,
                   engine.run_author_disambiguation, jcfg, cfg, jgraph,
                   graph, model, max_group=MAX_GROUP, **METAS)
    return dict(res, model=model, cfg=cfg, jcfg=jcfg, tmp=tmp)


def tasks(jgraph, graph, **group_kw):
    """Each package's ``LinkPredictionTask`` on the toy graph (the
    uncalibrated layout), and the port's pairs."""
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments import engine as jengine
    from pyhgt_tpu.tasks.link_prediction import LinkPredictionTask as JaxTask
    from pyhgt_tpu.tasks.link_prediction import build_name_groups as jgroups

    out = []
    for mod, task_cls, cfg, g, groups_fn in (
            (jengine, JaxTask, small_cfg(JaxConfig), jgraph, jgroups),
            (engine, LinkPredictionTask, small_cfg(ExperimentConfig), graph,
             build_name_groups)):
        groups = groups_fn(g, METAS["first_meta"], **group_kw)
        out.append(task_cls(
            graph=g, sampler=mod.make_sampler(cfg, g),
            layout=mod.make_layout(cfg, g), groups=groups,
            write_meta=METAS["write_meta"], batch_size=8,
            max_group=MAX_GROUP))
    jtask, task = out
    pairs = build_link_pairs(graph, task.groups, engine.OAG_SPLITS,
                             METAS["first_meta"])
    return jtask, task, pairs


@pytest.mark.parametrize("group_kw", [{}, dict(min_papers=1, min_group=3)],
                         ids=["default", "loose"])
def test_link_task_bit_equal(toy, group_kw):  # noqa: F811
    """``build_name_groups`` and ``build_link_pairs`` give the JAX
    package's dicts; ``LinkPredictionTask.sample`` under equal generators
    gives its padded batch, ``cand_idx``, ``cand_mask`` and
    ``query_mask``, bit for bit."""
    from pyhgt_tpu.experiments.engine import OAG_SPLITS as JSPLITS
    from pyhgt_tpu.tasks.link_prediction import build_link_pairs as jpairs

    jgraph, graph, _ = toy
    jtask, task, pairs = tasks(jgraph, graph, **group_kw)
    assert task.groups == jtask.groups and task.groups
    want = jpairs(jgraph, jtask.groups, JSPLITS, METAS["first_meta"])
    assert pairs == want and all(pairs[k] for k in pairs)
    for seed in (0, 1):
        tb = task.sample(pairs["train"], engine.OAG_SPLITS["train"],
                         np.random.default_rng(seed))
        jtb = jtask.sample(want["train"], JSPLITS["train"],
                           np.random.default_rng(seed))
        for f in dataclasses.fields(tb.sub):
            _same(getattr(tb.sub, f.name), getattr(jtb.sub, f.name), f.name)
        for name in ("cand_idx", "cand_mask", "query_mask"):
            _same(getattr(tb, name), getattr(jtb, name), name)
        assert tb.query_mask.any() and (
            tb.cand_mask.sum(1)[tb.query_mask] >= 2).all()


def test_score_pairs_and_loss_match_jax(toy, runs):  # noqa: F811
    """The runs' initial weights in the JAX package's ``LinkMatcherModel``
    and the port's: ``score_pairs`` on a sampled batch within 1e-4 (f32),
    and the grouped listwise loss against the JAX package's
    ``make_link_loss_fn`` within 1e-4."""
    import jax
    from pyhgt_tpu.experiments import engine as jengine
    from pyhgt_tpu.models import LinkMatcherModel as JaxModel
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
    from pyhgt_tpu.sampling.sorted_batch import sort_batch as jsort
    from pyhgt_tpu.tasks.link_prediction import make_link_loss_fn
    from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
    from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch

    jgraph, graph, _ = toy
    jtask, task, pairs = tasks(jgraph, graph)
    jcfg, cfg = runs["jcfg"], runs["cfg"]
    tb = task.sample(pairs["valid"], engine.OAG_SPLITS["valid"],
                     np.random.default_rng(3))
    jem = JaxMeta.from_layout(jtask.layout)
    se = jsort(tb.sub, jtask.layout, jem)
    jmodel = JaxModel(
        gnn_kwargs=jengine.gnn_kwargs(jcfg, jtask.layout, IN_DIM),
        n_hid=jcfg.n_hid, query_type_id=0, n_query=8)
    want = np.asarray(jax_apply(
        jmodel, runs["params"], *tb.batch_args, jem, tb.cand_idx, se=se,
        method=JaxModel.score_pairs))

    class WithSorted:
        """``jmodel`` with the batch's SortedEdges passed on (the sorted
        edge path needs them; the loss closure does not pass any)."""

        def apply(self, params, *a, method, **kw):
            return jmodel.apply(params, *a, se=se, method=method, **kw)

    loss_fn = make_link_loss_fn(WithSorted(), jem)
    want_loss = float(jax.jit(lambda p: loss_fn(
        p, jax.random.key(0), *tb.batch_args, tb.cand_idx, tb.cand_mask,
        tb.query_mask))(runs["params"]))
    em = EdgeStaticMeta.from_layout(task.layout)
    model = runs["model"]
    model.load_state_dict(flax_to_state_dict(runs["params"]))
    t = torch.as_tensor
    with torch.no_grad():
        got = model.eval().score_pairs(
            t(tb.sub.node_feat), t(tb.sub.node_mask),
            sort_batch(tb.sub, task.layout, em, with_backward=False).to(
                torch.device("cpu")), em, t(tb.cand_idx))
        loss = grouped_listwise_loss(got, t(tb.cand_mask),
                                     t(tb.query_mask)).item()
    assert got.shape == want.shape == (8, MAX_GROUP)
    live = tb.cand_mask
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert abs(loss - want_loss) <= FWD_TOL * max(1.0, abs(want_loss))


def test_matcher_index_matches_jax(runs):
    """The runs' matcher weights in both packages' ``MatcherIndex`` over 50
    random candidates, batches of 16: the scores equal the direct
    two-tower product and the JAX index's within 1e-5; top-k picks the
    argmax first; ``refresh`` and ``build`` bump the version."""
    from pyhgt_tpu.models import Matcher as JaxMatcher
    from pyhgt_tpu.tasks.matcher_index import MatcherIndex as JaxIndex

    r = np.random.default_rng(0)
    cands = r.normal(size=(50, 32)).astype(np.float32)
    queries = r.normal(size=(4, 32)).astype(np.float32)
    jm = JaxMatcher(n_hid=32)
    jp = {"params": runs["params"]["params"]["matcher"]}
    jidx = JaxIndex(lambda p, x: jm.apply(p, x, method=JaxMatcher.left))
    jidx.build(jp, cands, batch=16)
    want = np.asarray(jidx.score(jm.apply(jp, queries,
                                          method=JaxMatcher.right)))
    matcher = runs["model"].matcher
    idx = MatcherIndex(lambda m, x: m.left(x)).build(matcher, cands,
                                                     batch=16)
    with torch.no_grad():
        q = matcher.right(torch.as_tensor(queries))
        direct = matcher(torch.as_tensor(cands),
                         torch.as_tensor(queries)).T.numpy()
    scores = idx.score(q).numpy()
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores, direct, rtol=1e-5, atol=1e-5)
    vals, ids = idx.score(q, top_k=3)
    assert tuple(vals.shape) == ids.shape == (4, 3)
    np.testing.assert_array_equal(ids[:, 0], np.argmax(scores, axis=1))
    v0 = idx.params_version
    idx.refresh(matcher, cands)
    assert idx.params_version == v0 + 1
    with pytest.raises(RuntimeError, match="not built"):
        MatcherIndex(lambda m, x: x).score(q)


def test_link_layouts_and_items_equal(runs):
    check_layouts(runs["seen"])
    check_items(runs["seen"], runs["cfg"].n_batch,
                ("cand_idx", "cand_mask", "query_mask"))


def test_link_loss_and_metrics_match(runs):
    """The epoch's train loss within 1e-4; validation and test NDCG/MRR
    batch by batch within one query's worth; the JAX history's keys, and
    the port's timing beside them."""
    (h,), (jh,) = runs["out"]["history"], runs["jout"]["history"]
    assert h["epoch"] == jh["epoch"] == 0
    assert set(jh) <= set(h)
    assert abs(h["loss"] - jh["loss"]) <= LOSS_TOL
    assert h["edges_dropped"] == jh["edges_dropped"]
    check_metrics(runs["seen"])
    n_test = runs["seen"]["port"]["metrics"][1][2]
    for key in ("test_ndcg", "test_mrr"):
        assert abs(runs["out"][key] - runs["jout"][key]) * n_test <= 1 + 1e-9
    assert h["edges"] > 0 and h["step_ms"] is not None
    assert any("resumed" in s and "epoch 0" in s for s in runs["logs"])
    for name in ("ad_toy_hgt", "ad_toy_hgt_latest"):
        assert (runs["tmp"] / "port" / name / "state.pt").exists()


@pytest.fixture(scope="module")
def predictors(toy, runs):  # noqa: F811
    """The JAX run's best checkpoint in a JAX ``LinkPredictor``, and, by
    ``convert.checkpoint_from_flax``, in the port's (CPU), each with an
    index over the first 12 authors."""
    from pyhgt_tpu.experiments.serving import LinkPredictor as JaxPredictor

    from pyhgt_tpu.models import LinkMatcherModel as JaxModel

    jgraph, graph, _ = toy
    best = str(runs["tmp"] / "jax" / "ad_toy_hgt")
    with pytest.MonkeyPatch.context() as mp:
        shape_only_init(mp, JaxModel)
        jpred = JaxPredictor(runs["jcfg"], jgraph, best, max_group=MAX_GROUP,
                             log=lambda s: None, **METAS)
    path = str(runs["tmp"] / "converted")
    checkpoint_from_flax(jpred.params, path, step=int(jpred.state.step))
    pred = LinkPredictor(runs["cfg"], graph, path, max_group=MAX_GROUP,
                         log=lambda s: None, device="cpu", **METAS)
    authors = np.arange(12)
    for p in (jpred, pred):
        p.build_author_index(authors)
    return jpred, pred


def test_link_predictor_topk_matches_jax(predictors):
    """``topk`` of the same query papers and generators: scores within
    1e-4 of the JAX predictor's; the same authors wherever the next score
    is clear of the k-th by more than twice that; the record of each
    forward."""
    jpred, pred = predictors
    papers, k = [0, 5, 9, 21], 4
    jvals, jids = jpred.topk(papers, k=k)
    vals, ids = pred.topk(papers, k=k)
    assert vals.shape == ids.shape == jvals.shape == (4, k)
    np.testing.assert_allclose(vals, jvals, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert (np.diff(vals, axis=1) <= 0).all()
    full = np.sort(np.asarray(jpred.index.score(jpred._right(
        jpred.params, jpred._reps(
            {"paper": np.stack([papers, np.full(4, jpred.max_time)], 1)},
            np.random.default_rng(jpred.cfg.seed + 13))[
                jpred.layout.schema.type_id("paper"), :4]))), axis=1)
    for row in range(4):
        gaps = -np.diff(full[row, ::-1][: k + 1])
        if (gaps > 2 * SCORE_TOL).all():
            assert ids[row].tolist() == jids[row].tolist()
        elif gaps[-1] > 2 * SCORE_TOL:
            assert set(ids[row]) == set(jids[row])
    rec = pred.stats[-1]
    assert rec["edges"] > 0 and min(rec[k] for k in (
        "sample_ms", "sort_ms", "forward_ms", "topk_ms")) >= 0
    clamp_vals, clamp_ids = pred.topk([0], k=100)
    assert clamp_ids.shape == (1, 12)


def test_link_transports(predictors):
    """JSON-lines: top-k queries, an online index rebuild (versioned),
    a malformed line; the coalesced loop answers in order; a burst with a
    poison request fails only that request."""
    _, pred = predictors
    v0 = pred.index.params_version
    requests = ('{"papers": [0, 5], "k": 3}\n'
                '{"index_authors": [0, 1, 2, 3, 4]}\n'
                '{"papers": [5], "k": 2}\noops\n')
    for wait in (0.0, 0.01):
        out = io.StringIO()
        assert serve_link_jsonl(pred, stdin=io.StringIO(requests),
                                stdout=out, log=lambda s: None,
                                coalesce_wait=wait) == 4
        lines = [json.loads(l) for l in out.getvalue().splitlines()]
        assert lines[0]["papers"] == [0, 5] and len(lines[0]["authors"][0]) == 3
        assert lines[1]["indexed"] == 5
        assert set(lines[2]["authors"][0]) <= {0, 1, 2, 3, 4}
        assert "error" in lines[3]
    assert pred.index.params_version == v0 + 2
    resp = _answer_link_batch(pred, [
        {"papers": [0, 5], "k": 3}, {"papers": [2], "k": 3},
        {"papers": [1], "k": 3, "times": [2015, 2016]},
        {"index_authors": [0, 1, 2]}, {"papers": [4], "k": 2}])
    assert resp[0]["papers"] == [0, 5] and len(resp[1]["authors"][0]) == 3
    assert "error" in resp[2] and resp[3]["indexed"] == 3
    assert set(resp[4]["authors"][0]) <= {0, 1, 2}


def test_cli_trains_and_serves_links(toy, tmp_path, monkeypatch,  # noqa: F811
                                     capsys):
    """``run author_disambiguation`` with ``--first_meta`` /
    ``--write_meta`` writes its checkpoints; ``serve --serve_task link``
    restores the best one, indexes the first ``--index_authors`` grouped
    authors and answers JSON lines on stdout (logs on stderr)."""
    from pyhgt_tpu_torch import run
    from test_torch_oag import CLI_FLAGS

    flags = ["--data", str(toy[2]), "--model_dir", str(tmp_path),
             "--task_name", "ad_cli", "--first_meta", "author,paper,"
             "rev_AP_write", "--write_meta", "paper,author,AP_write",
             *CLI_FLAGS]
    assert run.main(["author_disambiguation", *flags]) == 0
    assert "test NDCG" in capsys.readouterr().out
    assert (tmp_path / "ad_cli_hgt" / "state.pt").exists()
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        '{"papers": [3, 7], "k": 2}\n'))
    assert run.main(["serve", "--serve_task", "link", "--ckpt",
                     str(tmp_path / "ad_cli_hgt"), "--index_authors", "6",
                     *flags]) == 0
    cap = capsys.readouterr()
    (line,) = cap.out.splitlines()
    resp = json.loads(line)
    assert resp["papers"] == [3, 7] and np.shape(resp["authors"]) == (2, 2)
    assert "indexing 6 candidate authors" in cap.err


@pytest.mark.cuda
def test_cuda_link_run_matches_cpu(tmp_path):
    """A toy ``run_author_disambiguation`` on the card under the slice's
    kernel flags against the same run on the CPU, both resumed from the
    same seeded weights, dropout 0: the epoch losses within the bf16 edge
    stage's 3e-2. Needs no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pyhgt_tpu_torch.graph import container
    from pyhgt_tpu_torch.train.checkpoint import save_checkpoint
    from pyhgt_tpu_torch.train.step import TrainState
    from test_torch_serving import toy_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = toy_graph(container)
    graph.features["author"]["name"] = np.array(
        [f"name{i % 4}" for i in range(graph.num_nodes["author"])])
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = small_cfg(ExperimentConfig, model_dir=str(tmp_path / device),
                        task_name="ad_toy", n_hid=128, **FLAGS)
        model = engine.link_matcher(cfg, engine.make_layout(cfg, graph),
                                    IN_DIM, seed=1)
        save_checkpoint(str(tmp_path / device / "ad_toy_hgt_latest"),
                        TrainState(model, engine.make_tx(
                            cfg, model.named_parameters(), 1)))
        out = engine.run_author_disambiguation(
            cfg.replace(n_epoch=2), graph, max_group=MAX_GROUP,
            log=lambda s: None, resume=True, device=device, **METAS)
        losses[device] = [h["loss"] for h in out["history"]]
    assert len(losses["cuda"]) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=CUDA_TOL, atol=CUDA_TOL)
