"""The port's runners with the baseline convs against the JAX package's:
``run_ogbn`` (on ``tests/test_torch_ogbn.py``'s toy graph) and
``run_node_classification`` (on ``tests/test_torch_oag.py``'s), with
``conv_name`` ``gat`` and ``rgcn``, and the node classifier also with
HGT on the segment edge path (``edge_impl="segment"``), two steps each.
Both runners resume
from the port's seeded weights carried into flax by
``convert.named_to_flax`` (``test_torch_oag.run_both``: dropout 0, one
loader worker, the numpy sampler). The epoch's train loss agrees within
``LOSS_TOL`` (1e-4, f32 on both sides), and so does every validation
score. A ``dense_hgt`` checkpoint restores into ``OgbnPredictor``, which
answers with the restored weights, and ``run paper_field --conv_name gat``
runs with ``--device cpu`` and raises without it on a machine with no GPU.
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.experiments.serving import OgbnPredictor
from pyhgt_tpu_torch.graph import container
from test_torch_oag import IN_DIM, LABEL, n_classes, run_both, small_cfg, toy
from test_torch_ogbn import LOSS_TOL
from test_torch_serving import tiny_cfg, toy_graph, write_port_checkpoint

# (runner, conv_name, edge_impl)
CASES = [("ogbn", "gat", "sorted"), ("ogbn", "rgcn", "sorted"),
         ("node_classification", "gat", "sorted"),
         ("node_classification", "rgcn", "sorted"),
         ("node_classification", "hgt", "segment")]
CONV_CLASS = {"gat": "GATConv", "rgcn": "RGCNConv", "hgt": "HGTConv"}


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: "-".join(p[:2]) + ("-segment" if p[2] ==
                                                 "segment" else ""))
def conv_run(request, toy, tmp_path_factory):  # noqa: F811
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments import engine as jengine

    runner, conv, edge_impl = request.param
    tmp = tmp_path_factory.mktemp(f"{runner}_{conv}")
    kw = dict(conv_name=conv, edge_impl=edge_impl, n_batch=2, repeat=1,
              n_epoch=1)
    if runner == "ogbn":
        from pyhgt_tpu.graph import container as jax_container

        jgraph = toy_graph(jax_container)
        jgraph.save_dir(str(tmp / "graph"))
        graph = engine.CSRGraph.load_dir(str(tmp / "graph"))
        kw.update(dropout=0.0, n_pool=1, native_sampler=False, vr_num=1,
                  task_name="ogbn_toy")
        jcfg = tiny_cfg(JaxConfig, model_dir=str(tmp / "jax"), **kw)
        cfg = tiny_cfg(ExperimentConfig, model_dir=str(tmp / "port"), **kw)
        model = engine.node_classifier(
            cfg, engine.make_layout(cfg, graph), IN_DIM,
            int(graph.aux["y"].max()) + 1)
        res = run_both(jengine, jengine.run_ogbn, engine.run_ogbn, jcfg, cfg,
                       jgraph, graph, model, max_eval_nodes=8)
    else:
        jgraph, graph, _ = toy
        jcfg = small_cfg(JaxConfig, model_dir=str(tmp / "jax"),
                         task_name="pf_toy", **kw)
        cfg = small_cfg(ExperimentConfig, model_dir=str(tmp / "port"),
                        task_name="pf_toy", **kw)
        model = engine.node_classifier(
            cfg, engine.make_layout(cfg, graph), IN_DIM, n_classes(graph),
            head_mode="seeds")
        res = run_both(jengine, jengine.run_node_classification,
                       engine.run_node_classification, jcfg, cfg, jgraph,
                       graph, model, label_meta=LABEL, multi_label=True)
    return dict(res, runner=runner, conv=conv, edge_impl=edge_impl,
                model=model)


def test_losses_and_validation_match_jax(conv_run):
    """The model is the conv asked for; the epoch's loss and validation
    scores agree with the JAX runner's within 1e-4."""
    gnn = conv_run["model"].gnn
    assert {type(c).__name__ for c in gnn.convs} == {
        CONV_CLASS[conv_run["conv"]]}
    assert gnn.reads_edges
    (h,), (jh,) = conv_run["out"]["history"], conv_run["jout"]["history"]
    assert np.isfinite(h["loss"])
    assert abs(h["loss"] - jh["loss"]) <= LOSS_TOL
    assert (h["edges"], h["edges_dropped"]) == (jh["edges"],
                                                jh["edges_dropped"])
    for key in ("valid_acc", "valid_ndcg", "valid_mrr"):
        if key in jh:
            assert abs(h[key] - jh[key]) <= LOSS_TOL, key


def test_dense_hgt_checkpoint_serves(tmp_path):
    """A ``dense_hgt`` checkpoint restores into ``OgbnPredictor``; its
    answer is the restored model's (its weights equal the saved ones)."""
    graph = toy_graph(container)
    cfg = tiny_cfg(ExperimentConfig, conv_name="dense_hgt", dropout=0.0)
    model = write_port_checkpoint(cfg, graph, str(tmp_path / "ckpt"))
    pred = OgbnPredictor(cfg, graph, str(tmp_path / "ckpt"),
                         log=lambda s: None, device="cpu")
    assert {type(c).__name__ for c in pred.model.gnn.convs} == {
        "DenseHGTConv"}
    saved = model.state_dict()
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    logp = pred.predict_logprobs([3, 17, 42], vr_num=2)
    assert logp.shape == (3, pred.n_classes) and np.isfinite(logp).all()
    assert pred.predict([3, 17, 42]).shape == (3,)


def test_cli_conv_name(toy, tmp_path, capsys):  # noqa: F811
    from pyhgt_tpu_torch import run

    flags = ["--data", str(toy[2]), "--conv_name", "gat",
             "--label_meta", ",".join(LABEL), "--features", "mag",
             "--model_dir", str(tmp_path), "--n_hid", "32", "--n_heads", "4",
             "--n_layers", "2", "--sample_depth", "2", "--sample_width", "8",
             "--batch_size", "8", "--node_cap", "64", "--edge_cap", "128",
             "--no-native_sampler", "--n_batch", "2", "--repeat", "1",
             "--n_pool", "1", "--n_epoch", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["paper_field", *flags])
    assert run.main(["paper_field", *flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0: loss" in out and "test NDCG" in out
    assert (tmp_path / "paper_field_gat_latest" / "state.pt").exists()
