"""The port's three runners under the parallel modes, as the JAX package's
``tests/test_experiments.py`` drives its own (dp, gp, dp x gp): each of
``run_ogbn``, ``run_node_classification`` (paper-venue style, KL over the
venue) and ``run_author_disambiguation`` trains 2 epochs under ``dp = 2``,
``gp = 2`` and ``pp = 2`` in one world of two gloo ranks on the CPU
(spawned once for the module), on ``tests/conftest.py``'s toy graph
(``make_toy_graph(60, 30, 5, seed=2)`` with its author names, built by the
port's container, and ``tests/test_torch_serving.py``'s ogbn labels). Each
run's losses are finite and the same on both ranks, every score comes from
rank 0 to both, and rank 0's best checkpoint loads into a single-process
port model. The CLI: ``python -m pyhgt_tpu_torch.run ogbn_mag --gp 2``
under ``torchrun`` (two CPU ranks), and the refusal of a world of the
wrong size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.graph import container
from pyhgt_tpu_torch.parallel.distributed import spawn
from pyhgt_tpu_torch.train.checkpoint import load_checkpoint
from pyhgt_tpu_torch.train.step import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNERS = ("ogbn", "node_classification", "link")
MODES = ("dp", "gp", "pp")
LABEL = ("venue", "paper", "PV_in")
METAS = dict(first_meta=("author", "paper", "rev_AP_write"),
             write_meta=("paper", "author", "AP_write"))
TINY = ["--n_hid", "32", "--n_heads", "4", "--n_layers", "2",
        "--sample_depth", "2", "--sample_width", "8", "--batch_size", "8",
        "--n_batch", "2", "--n_epoch", "1", "--node_cap", "64",
        "--edge_cap", "128", "--no-native_sampler", "--vr_num", "1",
        "--n_pool", "1", "--device", "cpu"]


def toy_graph():
    """``make_toy_graph(60, 30, 5, seed=2)`` through the port's container,
    with the author names and the ogbn labels and splits."""
    r = np.random.default_rng(2)
    g = container.Graph()
    n_paper, n_author, n_venue = 60, 30, 5
    papers = [{"id": f"p{i}", "type": "paper"} for i in range(n_paper)]
    authors = [{"id": f"a{i}", "type": "author"} for i in range(n_author)]
    venues = [{"id": f"v{i}", "type": "venue"} for i in range(n_venue)]
    years = r.integers(2000, 2020, size=n_paper)
    for i, p in enumerate(papers):
        t = int(years[i])
        for a in r.choice(n_author, size=r.integers(1, 4), replace=False):
            g.add_edge(authors[a], p, time=t, relation_type="AP_write")
        g.add_edge(p, venues[int(r.integers(0, n_venue))], time=t,
                   relation_type="PV_in")
        for j in r.choice(n_paper, size=r.integers(0, 3), replace=False):
            if j != i:
                g.add_edge(papers[int(j)], p, time=t, relation_type="PP_cite")
    for t, n in (("paper", n_paper), ("author", n_author), ("venue", n_venue)):
        g.set_features(t, {"emb": r.normal(size=(n, 16)).astype(np.float32)})
    g.node_feature["author"]["name"] = np.array(
        [f"name{i % 4}" for i in range(n_author)])
    csr = g.freeze()
    rng = np.random.default_rng(0)
    csr.aux.update(
        y=rng.integers(0, 4, n_paper), years=np.full(n_paper, 2015),
        train_mask=rng.random(n_paper) < 0.5,
        valid_mask=rng.random(n_paper) < 0.3,
        test_mask=rng.random(n_paper) < 0.3)
    return csr


def run_cfg(runner, mode, model_dir):
    return ExperimentConfig(
        n_hid=32, n_heads=4, n_layers=2, sample_depth=2, sample_width=8,
        batch_size=8, n_batch=2, repeat=1, n_pool=1, n_epoch=2,
        node_cap=64, edge_cap=128, native_sampler=False, max_lr=1e-2,
        dropout=0.0, vr_num=1, calibrate_caps=False, seg_pallas=True,
        model_dir=model_dir, task_name=f"{runner}_{mode}",
        **({mode: 2} if mode else {}))


def _run(runner, cfg, graph):
    quiet = dict(log=lambda s: None, device="cpu")
    if runner == "ogbn":
        return engine.run_ogbn(cfg, graph, max_eval_nodes=8, **quiet)
    if runner == "node_classification":
        return engine.run_node_classification(cfg, graph, label_meta=LABEL,
                                              **quiet)
    return engine.run_author_disambiguation(cfg, graph, max_group=8,
                                            **METAS, **quiet)


def _runs_world(rank, world, tmp):
    graph = toy_graph()
    out = {}
    for runner in RUNNERS:
        for mode in MODES:
            res = _run(runner, run_cfg(runner, mode, tmp), graph)
            scores = {k: v for k, v in res.items()
                      if k in ("test_ndcg", "test_mrr", "best_valid")}
            if "test" in res:
                scores["test_acc"] = res["test"]["acc"]
            out[(runner, mode)] = (
                [h["loss"] for h in res["history"]],
                [h.get("valid_acc", h.get("valid_ndcg"))
                 for h in res["history"]], scores)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("par_runs"))
    return tmp, spawn(_runs_world, 2, tmp)


def _single_model(runner, cfg, graph):
    """The runner's model on one process (no parallel knob)."""
    layout = engine.make_layout(cfg, graph)
    if runner == "link":
        return engine.link_matcher(cfg, layout, 16)
    n_classes = (int(graph.aux["y"].max()) + 1 if runner == "ogbn" else
                 int((np.diff(graph.adj[LABEL].indptr) > 0).sum()))
    return engine.node_classifier(
        cfg, layout, 16, n_classes,
        head_mode="full" if runner == "ogbn" else "seeds")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("runner", RUNNERS)
def test_runner_trains_under_mode(runs, runner, mode):
    tmp, ranks = runs
    (losses, valid, scores), other = ranks[0][(runner, mode)], \
        ranks[1][(runner, mode)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert other == (losses, valid, scores)    # every rank the same
    assert all(np.isfinite(v) for v in valid)
    for k, v in scores.items():
        assert v is None or 0.0 <= v <= 1.0, k
    cfg = run_cfg(runner, None, tmp).replace(task_name=f"{runner}_{mode}")
    model = _single_model(runner, cfg, toy_graph())
    path = os.path.join(tmp, f"{runner}_{mode}_hgt")
    state = load_checkpoint(path, TrainState(model, engine.make_tx(
        cfg, model.named_parameters(), 2)))
    assert state.step >= 2
    if mode == "pp":
        # the pipeline's rank 0 writes the gathered model, no optimizer
        assert not state.optimizer.inner.state


def _cli(graph_dir, model_dir, *extra):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "pyhgt_tpu_torch.run", "ogbn_mag",
            "--data", graph_dir, "--model_dir", model_dir, *TINY, *extra]


def test_cli_gp_under_torchrun(tmp_path):
    graph_dir = str(tmp_path / "graph")
    toy_graph().save_dir(graph_dir)
    cmd = _cli(graph_dir, str(tmp_path / "m"), "--gp", "2",
               "--dist_backend", "gloo")
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dist: 2 ranks, backend gloo" in out.stdout
    assert "kernel launches per rank" in out.stdout
    assert "test acc" in out.stdout
    assert os.path.exists(tmp_path / "m" / "ogbn_mag_hgt" / "state.pt")


def test_cli_refuses_a_world_of_the_wrong_size(tmp_path, monkeypatch):
    from pyhgt_tpu_torch import run

    graph_dir = str(tmp_path / "graph")
    toy_graph().save_dir(graph_dir)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="torchrun --standalone "
                                         "--nproc_per_node 4"):
        run.main(["ogbn_mag", "--data", graph_dir, "--model_dir",
                  str(tmp_path / "m"), *TINY, "--dp", "2", "--gp", "2"])
