"""The port's OAG preprocessing against the JAX package's: both
``preprocess_oag`` on the synthetic TSVs of ``tests/test_oag_preprocess.py``
(the reference layout, a field hierarchy, authors, affiliations, venues,
``vfi_vector.tsv`` and ``SeqName``) build equal graphs, array for array
(adjacency, times, every feature column, names, schema): host numpy, so
the comparison is exact. ``make_title_embedder`` through that file's tiny
mock transformer equals the JAX package's, and ``python -m
pyhgt_tpu_torch.run preprocess_oag`` writes a ``save_dir`` that the port's
``load_graph`` reads.
"""

import contextlib

import numpy as np
import pytest

from pyhgt_tpu.datasets import oag as joag
from pyhgt_tpu_torch.datasets import oag
from test_oag_preprocess import _MockTokenizer, _MockXLNet, oag_dir  # noqa: F401
from test_torch_sampler import _same_graph

QUIET = dict(log=lambda s: None)


def _embedders(kind):
    if kind == "stub":
        return None, None, 8
    tok, model = _MockTokenizer(), _MockXLNet()
    return (oag.make_title_embedder(model, tok),
            joag.make_title_embedder(model, tok), model.dim)


@pytest.mark.parametrize("kind", ["stub", "mock"])
def test_preprocess_matches_jax(oag_dir, kind):  # noqa: F811
    """Equal graphs with zero stub embeddings (both warn) and with the
    mock embedder."""
    mine, theirs, dim = _embedders(kind)

    def warns():
        return (pytest.warns(UserWarning, match="ZERO stubs")
                if kind == "stub" else contextlib.nullcontext())

    with warns():
        got = oag.preprocess_oag(oag_dir, domain="_T", citation_bar=1,
                                 emb_dim=dim, title_embedder=mine, **QUIET)
    with warns():
        want = joag.preprocess_oag(oag_dir, domain="_T", citation_bar=1,
                                   emb_dim=dim, title_embedder=theirs,
                                   **QUIET)
    _same_graph(got, want)
    assert got.num_nodes["paper"] == 3
    if kind == "mock":
        assert np.abs(got.features["paper"]["emb"]).sum() > 0


def test_title_embedder_matches_jax():
    tok, model = _MockTokenizer(), _MockXLNet()
    mine = oag.make_title_embedder(model, tok)
    theirs = joag.make_title_embedder(model, tok)
    for title in ("heterogeneous graph transformer networks at scale",
                  "x" * 500, "abc"):
        a, b = mine(title), theirs(title)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert (oag.VENUE_TYPES, oag.TEST_TIME_BAR, oag.XLNET_DIM) == (
        joag.VENUE_TYPES, joag.TEST_TIME_BAR, joag.XLNET_DIM)


def test_cli_writes_what_load_graph_reads(oag_dir, tmp_path):  # noqa: F811
    """``run preprocess_oag`` (the reference's ``preprocess_OAG.py``
    surface) writes a ``save_dir`` that ``run.load_graph`` memory-maps,
    equal to the JAX package's graph of the same TSVs."""
    from pyhgt_tpu_torch.run import load_graph, main

    out = str(tmp_path / "oag_out")
    with pytest.warns(UserWarning, match="ZERO stubs"):
        rc = main(["preprocess_oag", "--input_dir", str(oag_dir),
                   "--output_dir", out, "--citation_bar", "1",
                   "--domain", "_T"])
    assert rc == 0
    with pytest.warns(UserWarning):
        want = joag.preprocess_oag(oag_dir, domain="_T", citation_bar=1,
                                   **QUIET)
    _same_graph(load_graph(out), want)
