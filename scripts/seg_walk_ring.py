"""Time the segment-sum walks under other settings of their copy ring, on
one card.

    python3 scripts/seg_walk_ring.py [--variant kStages=4,kStageBytes=8192 \
        --variant kWindowEvictFirst=false ...] [--out FILE]

``csrc/pair_walk.cuh`` streams each block's rows into a ring of
``kStages`` stages of about ``kStageBytes`` bytes; the window kind copies
with an L2 evict-first policy when ``kWindowEvictFirst``. For each variant
given (NAME=VALUE pairs of those constants; an empty one is the source as
it is; default: the source, 4 x 8192, 8 x 8192, 2 x 16384, 2 x 4096, and
the source again to see the card drift), this builds the package's kernels
from a copy of ``pyhgt_tpu_torch/csrc`` with those constants replaced and
times ``live_partials``, ``live_partials_pair`` and ``live_partials_slab``
through the package's wrappers on the aux of ``scripts/seg_kernel_ab.py``
(the bench, ogbn-mag and OAG batches; eager over 20 calls and cold in a
CUDA graph of 8 input copies). One JSON line per reading, with the variant
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import seg_kernel_ab as ab  # noqa: E402

DEFAULT = ["", "kStages=4,kStageBytes=8192", "kStages=8,kStageBytes=8192",
           "kStages=2,kStageBytes=16384", "kStages=2,kStageBytes=4096", ""]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME=VALUE,... of pair_walk.cuh's constants "
                         "(repeatable; empty: the source as it is)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(ab.ROOT))
    import torch
    from pyhgt_tpu_torch.ops import cuda_build, pallas_seg as ps

    if not torch.cuda.is_available():
        raise SystemExit("seg_walk_ring: no CUDA device")
    card = ab.card_line()
    lines = []
    with tempfile.TemporaryDirectory(prefix="seg_ring_") as tmp:
        tmp = Path(tmp)
        aux = tmp / "aux.npz"
        ab.build_auxes(aux)
        csrc = cuda_build.CSRC
        for i, variant in enumerate(args.variant or DEFAULT):
            src = tmp / f"csrc{i}"
            shutil.copytree(csrc, src)
            header = src / "pair_walk.cuh"
            text = header.read_text()
            for pair in filter(None, variant.split(",")):
                name, value = pair.split("=")
                text, n = re.subn(rf"constexpr (\w+) {name} = [^;]+;",
                                  rf"constexpr \1 {name} = {value};", text)
                if n != 1:
                    raise SystemExit(f"{name} not found in {header}")
            header.write_text(text)
            label = variant or "source"
            cuda_build.CSRC, cuda_build.BUILD_DIR = src, tmp / f"build{i}"
            cuda_build.load.cache_clear()
            ps._c_fn.cache_clear()
            for line in ab.time_walks(ps, label, str(aux), card):
                print(json.dumps(line), flush=True)
                lines.append(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
