"""Carry parameter trees across between the JAX package and the port.

The JAX package's ``Flagship.init_params`` (or a trained checkpoint's
params) is a nested dict; as numpy arrays it reads::

    {"params": {
        "gnn": {"adapt_w": [T, Din, n_hid], "adapt_b": [T, n_hid],
                "convs_<i>": {"base_conv": {wq, bq, wk, bk, wv, bv, wa, ba,
                                            rel_pri, rel_att, rel_msg, skip,
                                            ln_scale, ln_bias, rte_w, rte_b}}},
        "clf": {"Dense_0": {"kernel": [n_hid, n_out], "bias": [n_out]}}}}

A JAX ``LinkMatcherModel`` has ``"matcher": {"left_linear": {kernel,
bias}, "right_linear": {kernel, bias}}`` in place of ``clf``. The port
keeps every HGT leaf under the same name and shape; only a flax ``Dense``
kernel ``[in, out]`` becomes the torch ``Linear`` weight ``[out, in]``
(``clf.linear``, ``matcher.left_linear``, ``matcher.right_linear``). The map is about names and shapes, not about what the
leaves mean: it carries a tree of gradients or of updated parameters the
same way (:func:`flax_to_state_dict`), and :func:`named_to_flax` brings the
port's named tensors (``named_parameters()``, or their ``.grad``) back into
the flax layout. A JAX ``NodeClassifierModel`` tree has the same layout
(``gnn`` and ``clf``), so it maps unchanged onto the port's
``NodeClassifierModel`` (either head mode), and a ``LinkMatcherModel``
tree onto the port's ``LinkMatcherModel``; :func:`checkpoint_from_flax`
writes either as a port checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# torch Linear -> flax Dense path of each head's linears
_DENSE = {"clf.linear": ("clf", "Dense_0"),
          "matcher.left_linear": ("matcher", "left_linear"),
          "matcher.right_linear": ("matcher", "right_linear")}


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state-dict layout (``FlagshipModel``,
    ``NodeClassifierModel`` or ``LinkMatcherModel``) of a flax-shaped tree
    (parameters, gradients, optimizer moments)."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    gnn = p["gnn"]
    for name, leaf in gnn.items():
        if name.startswith("convs_"):
            i = int(name[len("convs_"):])
            for k, v in leaf["base_conv"].items():
                put(f"gnn.convs.{i}.{k}", v)
        else:
            put(f"gnn.{name}", leaf)
    for key, (head, layer) in _DENSE.items():
        if head in p:
            dense = p[head][layer]
            put(f"{key}.weight", np.asarray(dense["kernel"]).T)
            put(f"{key}.bias", dense["bias"])
    return out


def named_to_flax(named: Mapping[str, torch.Tensor]) -> Dict:
    """The flax layout ``{"params": {"gnn": ..., "clf" or "matcher":
    ...}}`` (numpy leaves) of the port's tensors keyed as in
    ``named_parameters()``: the inverse of :func:`flax_to_state_dict`."""
    params: Dict = {"gnn": {}}
    gnn = params["gnn"]
    for key, t in named.items():
        arr = t.detach().cpu().numpy()
        parts = key.split(".")
        linear, _, leaf = key.rpartition(".")
        if parts[:2] == ["gnn", "convs"]:
            conv = gnn.setdefault(f"convs_{parts[2]}", {"base_conv": {}})
            conv["base_conv"][parts[3]] = arr
        elif parts[0] == "gnn":
            gnn[parts[1]] = arr
        elif linear in _DENSE and leaf in ("weight", "bias"):
            head, layer = _DENSE[linear]
            dense = params.setdefault(head, {}).setdefault(layer, {})
            if leaf == "weight":
                dense["kernel"] = arr.T
            else:
                dense["bias"] = arr
        else:
            raise KeyError(f"no flax leaf for {key}")
    return {"params": params}


def load_flax_params(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a flax ``FlagshipModel`` param tree into the port's
    ``FlagshipModel`` (strict: every leaf must map to a parameter and every
    parameter must be covered)."""
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    return model


def checkpoint_from_flax(tree: Mapping, path: str, step: int = 0) -> None:
    """Write the port checkpoint directory ``path``
    (:mod:`pyhgt_tpu_torch.train.checkpoint`) from a JAX parameter tree of
    a ``NodeClassifierModel`` or a ``LinkMatcherModel`` (numpy or array
    leaves, e.g. a restored ``TrainState.params``): the model's state dict
    and ``step``, with no optimizer state."""
    from pyhgt_tpu_torch.train.checkpoint import write_checkpoint

    write_checkpoint(path, flax_to_state_dict(tree), None, step)
