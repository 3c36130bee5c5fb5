"""Node products: the float32 GEMMs' share of their compute roofline over
the traced steps: the least time of the steps' node-level FLOPs
(``benchmark.flops``' node products plus the DenseHGT FFN's, at valid
nodes) at the float32 peak, over the device time of the kernels that
compute them, found by name (:func:`is_f32_gemm`). Padded rows are work
the kernels do and the FLOPs leave out, so the share stays under 100."""

import re

from benchmark.metrics.dense_train_mfu import node_flops
from benchmark.peaks import FLOPS_PER_S

_GEMM = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)
# the narrower precisions cuBLAS names in its kernels' types
_NARROW = re.compile(r"bf16|f16|tf32|e4m3|e5m2|half", re.IGNORECASE)


def is_f32_gemm(name: str) -> bool:
    """A GEMM or GEMV kernel of no narrower precision than float32. The
    names a traced ogbn-mag DenseHGT step runs on the H100 (TF32 off):
    cuBLAS's ``sm80_xmma_gemm_f32f32_f32f32_f32_{nn,nt,tn}_n_tilesize*``
    (``execute_kernel`` and ``execute_split_k_kernel``), cutlass's
    ``cutlass::Kernel2<cutlass_80_simt_sgemm_*>`` and cublasLt's
    ``splitKreduce_kernel<..., float, ...>``; other shapes take cuBLAS's
    ``gemv2T_kernel_val``, ``gemvNSP_kernel``, ``gemmSN_*_kernel`` and
    ``gemmk1_kernel``, and batched products the same kernels. A name that
    carries ``bf16``, ``f16``, ``tf32`` or an fp8 type is left out."""
    return bool(_GEMM.search(name)) and not _NARROW.search(name)


def read(ctx):
    t = ctx["trace"]
    if not t.get("counts") or not t.get("kernels"):
        return None
    cfg = ctx["config"]
    least = sum(node_flops(c, cfg) for c in t["counts"]) \
        / FLOPS_PER_S[cfg["precision"]["node_products"]]
    seconds = sum(s for n, s in t["kernels"] if is_f32_gemm(n))
    return 100.0 * least / seconds if least > 0 and seconds > 0 else None
