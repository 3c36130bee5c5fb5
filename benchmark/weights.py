"""The benchmark's weights: every parameter drawn from the run's seed on
the run's device, in one call, and handed alike to the program and to the
plain reference. The program's own initialisation is overwritten.

Rule by the last component of a parameter's name (the architecture's
names; the reference reads the same names):

- biases (``bias``, ``bq``, ``bk``, ``bv``, ``ba``, ``adapt_b``,
  ``rte_b``, ``ln_bias``): normal, std 0.02;
- scales, gates and priors (``ln_scale``, ``scale``, ``skip``,
  ``rel_pri``): 1 + normal, std 0.1;
- matrices: normal, std 1 / sqrt(fan_in); fan_in is the last dim of a
  ``weight`` (a ``Linear``'s ``[out, in]``) and the second-to-last of a
  stacked bank (``[..., in, out]``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

BIASES = ("bias", "bq", "bk", "bv", "ba", "adapt_b", "rte_b", "ln_bias")
UNIT_SCALES = ("ln_scale", "scale", "skip", "rel_pri")
# keeps the weights' stream apart from any other use of the seed
STREAM = 0x5EED_0001


def _mean_std(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in BIASES:
        return 0.0, 0.02
    if leaf in UNIT_SCALES:
        return 1.0, 0.1
    if len(shape) < 2:
        raise ValueError(f"no weight rule for the vector {name!r}")
    fan_in = shape[-1] if leaf == "weight" else shape[-2]
    return 0.0, 1.0 / math.sqrt(fan_in)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named use of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw(names_shapes: List[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` f32 on ``device``: one normal draw for all of
    them, cut and scaled by the rule above. The same list, seed and device
    give the same values."""
    sizes = [math.prod(s) for _, s in names_shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, STREAM),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), n in zip(names_shapes, sizes):
        mean, std = _mean_std(name, shape)
        out[name] = (flat[at:at + n].view(shape) * std + mean).contiguous()
        at += n
    return out


def names_shapes(model: torch.nn.Module):
    """The model's parameters as ``[(name, shape)]`` in name order."""
    return sorted((n, tuple(p.shape)) for n, p in model.named_parameters())


@torch.no_grad()
def load_into(model: torch.nn.Module, seed: int, device) -> None:
    """Overwrite every parameter of ``model`` (already on ``device``) with
    :func:`draw`'s values."""
    params = dict(model.named_parameters())
    for name, value in draw(names_shapes(model), seed, device).items():
        params[name].copy_(value)
