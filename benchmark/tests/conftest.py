"""The tiny batch of each configuration that ``fixtures.TINY_BATCH`` does
not name, so that ``write_tiny_bench`` cuts every configuration of
``BENCHMARK.json``."""

from benchmark.tests import fixtures

fixtures.TINY_BATCH.setdefault("dense-hgt-ogbn-mag", 16)
