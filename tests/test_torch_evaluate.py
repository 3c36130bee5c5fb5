"""The port's ``multi_sample_eval`` against the JAX package's: the same
task (the toy graph of ``tests/test_torch_serving.py``, the numpy sampler,
an uncalibrated layout) and a deterministic stand-in forward, so that every
returned statistic, ``return_arrays`` included, must be equal; and the
port's repair: a forward that raises leaves no sampling thread alive."""

import threading

import numpy as np
import pytest

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.experiments.engine import make_layout, make_sampler
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from test_torch_serving import tiny_cfg, toy_graph

N_CLASSES = 4


def fake_forward(params, nf, es, et, dt, emk, nmk):
    """Log-probs ``[node_cap, 4]`` of the paper block, a fixed function of
    each row's input features (so of the sampled paper's id); padded rows
    are uniform."""
    x = np.asarray(nf)[0].astype(np.float64) @ params
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(
        np.float32)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """The JAX task over the JAX-built toy graph and the port's over the
    same graph read back from its ``save_dir``."""
    pytest.importorskip("jax")
    from pyhgt_tpu.config import ExperimentConfig as JaxConfig
    from pyhgt_tpu.experiments.engine import (
        make_layout as jax_layout, make_sampler as jax_sampler,
    )
    from pyhgt_tpu.graph import container as jax_container
    from pyhgt_tpu.tasks.ogbn import OgbnNodeTask as JaxTask

    tmp = tmp_path_factory.mktemp("eval")
    jgraph = toy_graph(jax_container)
    jgraph.save_dir(str(tmp / "graph"))
    graph = CSRGraph.load_dir(str(tmp / "graph"))
    jcfg, cfg = tiny_cfg(JaxConfig), tiny_cfg(ExperimentConfig)
    jtask = JaxTask(graph=jgraph, sampler=jax_sampler(jcfg, jgraph),
                    layout=jax_layout(jcfg, jgraph), batch_size=8)
    task = OgbnNodeTask(graph=graph, sampler=make_sampler(cfg, graph),
                        layout=make_layout(cfg, graph), batch_size=8)
    weights = np.random.default_rng(3).normal(size=(16, N_CLASSES))
    return jtask, task, weights


@pytest.mark.parametrize("n_prefetch", [0, 2])
def test_multi_sample_eval_matches_jax(tasks, n_prefetch):
    from pyhgt_tpu.tasks.evaluate import multi_sample_eval as jax_eval

    jtask, task, w = tasks
    kw = dict(split="test", batch_size=8, vr_num=3, return_arrays=True,
              n_prefetch=n_prefetch)
    want = jax_eval(fake_forward, w, jtask, rng=np.random.default_rng(11),
                    **kw)
    got = multi_sample_eval(fake_forward, w, task,
                            rng=np.random.default_rng(11), **kw)
    assert got.keys() == want.keys()
    assert got["n_eval"] > 0 and len(got["vr_curve"]) == 3
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].dtype == v.dtype, k
        else:
            assert got[k] == v, k


def _pool_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("ThreadPoolExecutor") and t.is_alive()}


def test_failing_forward_leaves_no_pool_threads(tasks):
    """The sampling pool of ``n_prefetch`` is shut down however the loop
    ends: a forward that raises on its third call leaves no pool thread of
    this call alive."""
    _, task, w = tasks
    calls = []

    def forward(params, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return fake_forward(params, *args)

    before = _pool_threads()
    with pytest.raises(RuntimeError, match="device lost"):
        multi_sample_eval(forward, w, task, split="test", batch_size=8,
                          vr_num=3, rng=np.random.default_rng(0),
                          n_prefetch=2)
    assert len(calls) == 3
    assert not (_pool_threads() - before)
