"""The controls of each cell at its own size, on the card: the plain
reference in the program's place one precision below what the
configuration states (its node products' inputs at TF32, below their
float32; its edge stage at fp8 e4m3, below its bfloat16) comes out not
correct under the cell's limits, and so does the planted half-batch fault,
on three seeds, while the program itself comes out correct. Runs where
there is a card:

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda -o addopts=""
"""

from __future__ import annotations

import pytest

from benchmark import calibrate, check, spec, system
from benchmark.tests.fixtures import cuda_device  # noqa: F401

CELLS = ("hgt-ogbn-mag.train", "hgt-oag-field.train")
SEEDS = (901, 902, 903)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda_device):
    c = spec.load_cell(cell)
    graph = system.make_graph(c.config, cuda_device)
    limits = c.config["limits"]
    for seed in SEEDS:
        r = calibrate.readings(c, seed, graph, cuda_device, True, print)
        assert check.verdict(r["program"], limits)[0], r["program"]
        assert not check.verdict(r["control_tf32"], limits)[0], r
        assert not check.verdict(r["control_fp8"], limits)[0], r
        assert not check.verdict(r["half_batch"], limits)[0], r
