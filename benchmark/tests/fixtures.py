"""Fixtures of the benchmark's own tests (imported by each test file): a copy of ``BENCHMARK.json``
whose configurations are cut to a size the CPU runs in seconds (the
widths, depth, fan-outs and graph scale shrunk, the limits of ``correct``
those of that size; every other key as committed)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.spec import ROOT

TINY = dict(n_hid=128, sample_depth=2, sample_width=32, graph_scale=0.002)
TINY_BATCH = {"hgt-ogbn-mag": 16, "hgt-oag": 32}
# the cells' limits are set from readings at their own size; at this size
# on the CPU the sound runs read up to 3e-4 on the losses and 5e-3 on the
# norms, the planted faults 4e-2 and more (a changed edge: 1 or more)
TINY_LIMITS = dict(batch_mismatch=0, loss_gap=2e-3, first_loss_gap=2e-3,
                   grad_norm_gap=2e-2, update_norm_gap=1e-2, input_gap=1e-4)


def write_tiny_bench(tmp: Path, **over) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY, batch_size=TINY_BATCH[c["name"]],
                   limits=TINY_LIMITS, **over)
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    out = tmp / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return out


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return write_tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import, so every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """The tiny runs are latency-bound; several test workers each using
    every core for torch's intra-op threads slow each other down tenfold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
