"""The plain reference: plain PyTorch and numpy, nothing of the program.

A configuration's ``reference`` names the module here that models its
network (``hgt``): it holds ``CONVS`` (the ``conv_name`` values it models),
``CONTROLS`` (its lower precisions), ``Precision``, ``dropout_masks``,
``forward`` and ``loss``."""

from __future__ import annotations

import importlib


def for_config(cfg: dict):
    """The configuration's reference, ``benchmark/reference/<name>.py``;
    raises where it does not model the configuration's ``conv_name``."""
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    if cfg["conv_name"] not in mod.CONVS:
        raise ValueError(f"the reference {cfg['reference']!r} models "
                         f"{mod.CONVS}, not conv_name {cfg['conv_name']!r}")
    return mod
