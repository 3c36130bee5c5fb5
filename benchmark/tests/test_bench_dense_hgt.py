"""The DenseHGT cell on the CPU: its two readers against hand counts
(the FFN's FLOPs in ``dense_train_mfu``, the GEMM name matcher of
``node_gemm_roofline`` on a synthetic kernel list), and whole runs of the
tiny cell: ``correct`` against the plain reference
(``benchmark/reference/dense_hgt.py``), not correct with the node
products at TF32, and read correct with the FFN's products alone at TF32
(what the comparison cannot see). Where there is a card, the cell's
controls at its own size, as ``test_bench_control.py`` checks the HGT
cells':

    python3 -m pytest benchmark/tests/test_bench_dense_hgt.py -m cuda -o addopts=""
"""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, check, peaks, run, spec, system
from benchmark.metrics.dense_train_mfu import ffn_flops
from benchmark.metrics.node_gemm_roofline import is_f32_gemm
from benchmark.tests.fixtures import (  # noqa: F401
    _few_threads,
    cuda_device,
    tiny_bench,
)

CELL = "dense-hgt-ogbn-mag.train"
SEEDS = (901, 902, 903)
# the readers as the harness loads them, by name
mfu = spec.reader("dense_train_mfu")
gemm = spec.reader("node_gemm_roofline")


def test_ffn_flops_by_hand():
    # 10 nodes, D 8, 2 layers: mid 2*10*8*16 + out 2*10*16*8 forward,
    # three times that forward and backward
    assert ffn_flops(10, 8, 2) == 2 * 3 * (2 * 10 * 8 * 16 + 2 * 10 * 16 * 8)


def _ctx(**trace):
    cfg = dict(n_hid=8, n_layers=2, precision=dict(node_products="float32",
                                                   edge_products="bfloat16"))
    count = dict(flops=dict(node=1e12, edge=2e12), nodes=dict(a=6, b=4))
    window = dict(counts=[count, count], seconds=2.0)
    return dict(config=cfg, window=window,
                trace=dict(trace, counts=[count] * 3))


def test_dense_train_mfu_by_hand():
    ffn = 24.0 * 2 * 10 * 8 * 8
    least = 2 * ((1e12 + ffn) / peaks.FLOPS_PER_S["float32"]
                 + 2e12 / peaks.FLOPS_PER_S["bfloat16"])
    assert mfu(_ctx()) == pytest.approx(100.0 * least / 2.0)


NODE_GEMMS = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)",
    "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float>, float, float)",
    "void gemmSN_NN_kernel<float, 128, 2, 4, 8, 5, 4, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float> >(cublasGemmSmallNParams<cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float>)",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float, float, float, true, false, false, false>(cublasLt::cublasSplitKParams<float>, float const*, float const*, float*, float const*, float const*, float const*, float const*, float*, void*, long, float*, int*)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(cutlass_80_simt_sgemm_128x256_8x4_nt_align1::Params)",
]
NOT_NODE_GEMMS = [
    "void walk_kernel<__nv_bfloat16, 0, 2>(WalkArgs)",
    "void softmax_partials_kernel(float const*, int const*, int, float*, float*)",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, long, bool)",
    "void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true, at::native::ReduceAdd>(at::cuda::detail::TensorInfo<float, unsigned int>)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1}, std::array<char*, 2ul>)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>(int, float, float const*, float const*, float const*, float*, float*, float*)",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsigned int, float, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsigned int, float, 4>)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
    "sm80_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x16_stage4_warpsize2x2x1_tensor16x8x8_execute_kernel__5x_cublas",
]


@pytest.mark.parametrize("name", NODE_GEMMS)
def test_matcher_takes_the_f32_gemms(name):
    assert is_f32_gemm(name)


@pytest.mark.parametrize("name", NOT_NODE_GEMMS)
def test_matcher_leaves_other_kernels(name):
    assert not is_f32_gemm(name)


def test_node_gemm_roofline_by_hand():
    kernels = [(NODE_GEMMS[0], 0.5), (NODE_GEMMS[3], 0.25),
               (NOT_NODE_GEMMS[0], 9.0)]
    ffn = 24.0 * 2 * 10 * 8 * 8
    least = 3 * (1e12 + ffn) / peaks.FLOPS_PER_S["float32"]
    assert gemm(_ctx(kernels=kernels)) == pytest.approx(100.0 * least / 0.75)
    assert gemm(_ctx(kernels=[(NOT_NODE_GEMMS[0], 1.0)])) is None
    assert gemm(_ctx()) is None


def _run(bench, capsys, trace=0, seed=3_100_000_019):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "1", "--trace", str(trace)], require_cuda=False,
                  bench_path=bench)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def test_tiny_cell_is_correct(tiny_bench, capsys):
    line = _run(tiny_bench, capsys)
    assert line["correct"] is True and line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_tiny_cell_traced(tiny_bench, capsys):
    """The traced line reads the FFN-aware MFU; without a card no kernel
    runs, so the GEMMs' roofline stays silent."""
    line = _run(tiny_bench, capsys, trace=1)
    assert line["correct"] is True
    assert {"loader_wait_ms", "dense_train_mfu"} <= set(line["metrics"])
    assert "node_gemm_roofline" not in line["metrics"]


@pytest.mark.parametrize("where", ["adapter", "every_node_product"])
def test_tf32_node_products_are_not_correct(tiny_bench, where, capsys,
                                            monkeypatch):
    """The node products with both inputs rounded to TF32, as the card
    computes them with TF32 switched on: the input adapter's alone, or
    every one (the typed linears and the FFN's and head's ``Dense``)."""
    import torch.nn.functional as F

    from benchmark.reference.hgt import tf32
    from pyhgt_tpu_torch.models import conv as conv_mod
    from pyhgt_tpu_torch.models import model as model_mod

    plain = model_mod.typed_linear
    monkeypatch.setattr(model_mod, "typed_linear",
                        lambda x, w, b=None: plain(tf32(x), tf32(w), b))
    if where == "every_node_product":
        monkeypatch.setattr(conv_mod, "typed_linear",
                            lambda x, w, b=None: plain(tf32(x), tf32(w), b))
        monkeypatch.setattr(
            conv_mod.Dense, "forward",
            lambda self, x: F.linear(tf32(x), tf32(self.weight), self.bias))
    line = _run(tiny_bench, capsys)
    assert line["correct"] is False
    assert line["checks"]["input_gap"]["value"] \
        > line["checks"]["input_gap"]["limit"]


def test_tf32_ffn_alone_is_not_seen(tiny_bench, capsys, monkeypatch):
    """The FFN's two products (``mid``, ``out``) alone at TF32, every
    other product at float32: ``input_gap`` taps the first layer's input,
    before any FFN, and reads nothing, while the losses and norms stay
    within their limits, so the run reads correct. This pins what the
    comparison cannot see; a tap after the first layer's FFN would."""
    import torch.nn.functional as F

    from benchmark.reference.hgt import tf32
    from pyhgt_tpu_torch.models import conv as conv_mod

    class TF32Dense(conv_mod.Dense):
        def forward(self, x):
            return F.linear(tf32(x), tf32(self.weight), self.bias)

    def ffn_dense(*args, **kw):
        # conv.py's ``dense`` builds only the FFN's two linears here (the
        # head's comes from model.py's import of it)
        linear = plain_dense(*args, **kw)
        linear.__class__ = TF32Dense
        return linear

    plain_dense = conv_mod.dense
    monkeypatch.setattr(conv_mod, "dense", ffn_dense)
    line = _run(tiny_bench, capsys)
    assert line["checks"]["input_gap"]["value"] == 0.0
    assert line["correct"] is True, line["checks"]


@pytest.mark.cuda
def test_control_is_not_correct(cuda_device):
    """At the cell's own size: the program correct on three seeds, the
    TF32 and fp8 controls and the half-batch fault not correct on each."""
    c = spec.load_cell(CELL)
    graph = system.make_graph(c.config, cuda_device)
    limits = c.config["limits"]
    for seed in SEEDS:
        r = calibrate.readings(c, seed, graph, cuda_device, True, print)
        assert check.verdict(r["program"], limits)[0], r["program"]
        assert not check.verdict(r["control_tf32"], limits)[0], r
        assert not check.verdict(r["control_fp8"], limits)[0], r
        assert not check.verdict(r["half_batch"], limits)[0], r
