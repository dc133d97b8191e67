"""The trace's arithmetic: families, busy time and its shares."""

import random

import pytest

from benchmark.lib import trace as TR

# kernel names as the H100 profiles of the benchmark's cells list them
NAMES = {
    "void dgrad_engine<__nv_bfloat16, 128, 6, 7, 3, 3, 5, false>(int, int, int, __nv_bfloat16 "
    "const*, int, __nv_bfloat16 const*, int, __nv_bfloat16*, kernel_grad_params": "conv",
    "void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024, 5, 5, 3, 3, 3, 1, false, "
    "false, true>(int, int, int, __nv_bfloat16 const*, int, __nv_bfloat16*": "conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, "
    "false, true, (cudnnKernelDataType_t)0>": "conv",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_analytic_bf16_128x64_64x3_"
    "nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_analytic_bf16_128x64_64x3_nhwc_align8::"
    "Params)": "conv",
    "(anonymous namespace)::attention_bwd_dkv_wgmma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
    "const*": "attention",
    "(anonymous namespace)::wavlm_fwd_wgmma_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*": 
        "attention",
    "Memcpy DtoH (Device -> Pageable)": "memcpy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
    "pow_tensor_scalar_kernel_impl<float, float>(at::TensorIteratorBase&": "elementwise",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
    "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn": "conv",
    "void cudnn::engines_precompiled::dgrad_engine<float, 128, 6, 7, 3, 3, 5, false>(int, int, "
    "int, float const*, int, float const*, int, float*, kernel_grad_params, unsigned long long, "
    "int, unsigned long long, int, float, int, int, int)": "conv",
    "cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816wgrad_optimized_bf16_128x128_32x3_"
    "nhwc_align8>(cutlass_tensorop_bf16_s16816wgrad_optimized_bf16_128x128_32x3_nhwc_align8::"
    "Params)": "conv",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1_execute_"
    "segment_k_off_kernel__5x_cublas": "matmul",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>"
    "(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8::Params)": "matmul",
    "attention_fwd_wgmma_kernel": "attention",
    "attention_bwd_dkv_wgmma_kernel": "attention",
    "void wavlm_bwd_dq_wgmma_kernel<64>(WavlmBwdArgs)": "attention",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl("
    "at::TensorIteratorBase&, at::native::GeluType)::{lambda()#2}::operator()() const::"
    "{lambda()#2}::operator()() const::{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >": 
        "elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
    "const::{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned "
    "int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
    "at::native::memory::StoreWithCast<1> >": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<"
    "float, float, float, float>, unsigned int, float, 4> >": "reductions",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous "
    "namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::PointwiseOpScalar"
    "TensorListFunctor<float, 4, 3, 3> >": "optimizer",
    "void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float,"
    " 4, at::native::templates::cuda::uniform_and_transform<float, float, at::CUDAGenerator"
    "Impl*>": "random",
    "Memcpy HtoD (Pinned -> Device)": "memcpy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::convert_float_bf16>": 
        "elementwise",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_family_of_real_kernel_names(name):
    assert TR.family(name) == NAMES[name]


def synthetic(seed=0, n=400):
    """Random device operations, some overlapping, over a 1 s window."""
    rng = random.Random(seed)
    names = sorted(NAMES)
    ops = []
    for _ in range(n):
        s = rng.uniform(-0.05, 1.0)
        ops.append((rng.choice(names), s, s + rng.expovariate(1 / 0.004)))
    host = [("bench.dispatch", 0.0, 0.5), ("aten::copy_", 0.5, 0.7), ("cudaStreamSynchronize",
                                                                   0.7, 1.0)]
    lo, hi = 0.0, 1.0
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    return TR.Trace(ops, host, lo, hi)


@pytest.mark.parametrize("seed", range(4))
def test_shares_sum_to_the_busy_time_and_stay_under_the_window(seed):
    tr = synthetic(seed)
    fams = {TR.family(n) for n, _, _ in tr.ops}
    total = sum(tr.family_busy_s(f) for f in fams)
    assert total == pytest.approx(tr.busy_s, rel=1e-9)
    assert 0.0 < tr.busy_s <= tr.window_s
    for f in fams:
        assert 0.0 <= tr.family_busy_s(f) <= tr.family_kernel_s(f) + 1e-12
    idle = sum(v for _, v in tr.idle_gaps(100))
    assert idle == pytest.approx(tr.window_s - tr.busy_s, rel=1e-9)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert TR.union(iv) == 3.0
    assert TR.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert TR.busy_shares([(0.0, 2.0), (1.0, 2.0)]) == [1.5, 0.5]


def test_idle_gaps_name_the_innermost_host_range():
    tr = TR.Trace([("k", 0.0, 0.1), ("k", 0.6, 0.65), ("k", 0.9, 1.0)],
                  [("outer", 0.0, 1.0), ("inner", 0.2, 0.5)], 0.0, 1.0)
    gaps = dict(tr.idle_gaps())
    assert gaps["inner"] == pytest.approx(0.5)  # 0.1-0.6, its middle inside "inner"
    assert gaps["outer"] == pytest.approx(0.25)  # 0.65-0.9
