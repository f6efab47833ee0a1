// K1: one quantized ring hop, dequantize -> accumulate -> requantize.
//
// Replaces the Pallas TPU kernel `_hop_kernel` (mpi4torch_tpu/ops/
// quant_kernels.py:196, launched by `_hop_pallas`).  For each block row
// of `block` elements:
//
//   part  = mine + q * scale          (hop 0, q == nullptr: part = mine)
//   amax  = max |part|                (NaN propagates)
//   s     = the smallest power of two with 127 s >= amax, >= 2^-126
//   q'    = clip(rint(part / s))      or clip(floor(part / s + noise))
//   resid = part - q' * s             (optional)
//
// Bitwise contract with the plain version (ops/quant_kernels.py
// `_torch_hop`): s is a power of two, so q * s, part / s and q' * s are
// exact and only the one rounding step rounds.  Hence: the division is
// the correctly rounded __fdiv_rn; the stochastic sum is __fadd_rn (no
// contraction into anything else); rounding is rintf (half to even, as
// torch.round); the build uses no --use_fast_math (no approximate
// division, no flush to zero), so subnormal parts quantize as on the CPU.
// The products may contract into FMAs: they are exact, so it changes no
// bit.
//
// Design.  The TPU kernel walks 256-row tiles of a sequential grid in
// VMEM; here one thread block owns one block row and there is nothing to
// carry between blocks.  Each thread takes VEC contiguous elements per
// step (char4 / float4 loads when the block is a multiple of 4 and the
// operands are aligned), the row's absmax is a warp-shuffle max plus a
// shared-memory combine across warps, and the second pass re-reads the
// row (from L1: a 256-element row is 1.3-2.3 KB) to quantize and store.
// Any block size works; there is no lane tiling to satisfy.
//
// Bound: memory.  Per element it moves 1 B of q in, 4 B of mine, 1 B of
// q' out, plus 4 B of noise and 4 B of residual when asked: 6 to 14 B
// per element and 8 B per row of scales, against ~10 operations.

#include <cuda_runtime.h>
#include <stdint.h>
#include <cfloat>

namespace {

// max that propagates NaN from either side (fmaxf drops it).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float po2_scale(float amax) {
  float s = __uint_as_float(__float_as_uint(amax) & 0x7F800000u) * 0.015625f;
  if (127.0f * s < amax) s = s * 2.0f;
  return fmaxf(s, FLT_MIN);
}

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  __device__ __forceinline__ static void load_q(const int8_t* p, float* v) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
  }
  __device__ __forceinline__ static void load_f(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ __forceinline__ static void store_q(int8_t* p, const int* v) {
    *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static void store_f(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<1> {
  __device__ __forceinline__ static void load_q(const int8_t* p, float* v) {
    v[0] = *p;
  }
  __device__ __forceinline__ static void load_f(const float* p, float* v) {
    v[0] = *p;
  }
  __device__ __forceinline__ static void store_q(int8_t* p, const int* v) {
    *p = static_cast<int8_t>(v[0]);
  }
  __device__ __forceinline__ static void store_f(float* p, const float* v) {
    *p = v[0];
  }
};

// part for VEC elements at offset `off` of the row.
template <bool HOP0, int VEC>
__device__ __forceinline__ void load_part(const int8_t* q, const float* mine,
                                          float s_in, size_t off, float* p) {
  Vec<VEC>::load_f(mine + off, p);
  if (!HOP0) {
    float qv[VEC];
    Vec<VEC>::load_q(q + off, qv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = p[j] + qv[j] * s_in;
  }
}

// The row's absmax, on every thread of the block.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = warp_max[0];
  const int nwarps = blockDim.x >> 5;
  for (int w = 1; w < nwarps; ++w) v = nanmax(v, warp_max[w]);
  return v;
}

template <bool HOP0, bool STOCH, bool RESID, int VEC>
__global__ void quant_hop_kernel(const int8_t* __restrict__ q,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ mine,
                                 const float* __restrict__ noise,
                                 int8_t* __restrict__ q_out,
                                 float* __restrict__ scale_out,
                                 float* __restrict__ resid, int block) {
  const size_t row0 = static_cast<size_t>(blockIdx.x) * block;
  const float s_in = HOP0 ? 0.0f : scale[blockIdx.x];
  const int step = blockDim.x * VEC;

  float amax = 0.0f;
  for (int i = threadIdx.x * VEC; i < block; i += step) {
    float p[VEC];
    load_part<HOP0, VEC>(q, mine, s_in, row0 + i, p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = nanmax(fabsf(p[j]), amax);
  }
  const float s = po2_scale(block_max(amax));

  for (int i = threadIdx.x * VEC; i < block; i += step) {
    const size_t off = row0 + i;
    float p[VEC], n[VEC], r[VEC];
    int qi[VEC];
    load_part<HOP0, VEC>(q, mine, s_in, off, p);
    if (STOCH) Vec<VEC>::load_f(noise + off, n);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = __fdiv_rn(p[j], s);
      const float t = STOCH ? floorf(__fadd_rn(v, n[j])) : rintf(v);
      qi[j] = static_cast<int>(fminf(fmaxf(t, -127.0f), 127.0f));
      if (RESID) r[j] = p[j] - static_cast<float>(qi[j]) * s;
    }
    Vec<VEC>::store_q(q_out + off, qi);
    if (RESID) Vec<VEC>::store_f(resid + off, r);
  }
  if (threadIdx.x == 0) scale_out[blockIdx.x] = s;
}

template <bool HOP0, bool STOCH, bool RESID>
cudaError_t launch(const int8_t* q, const float* scale, const float* mine,
                   const float* noise, int8_t* q_out, float* scale_out,
                   float* resid, long long nb, int block, int vec,
                   cudaStream_t stream) {
  // One thread per VEC-element group, rounded up to whole warps.
  const int groups = (block + vec - 1) / vec;
  int threads = ((groups + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid(static_cast<unsigned>(nb));
  if (vec == 4)
    quant_hop_kernel<HOP0, STOCH, RESID, 4><<<grid, threads, 0, stream>>>(
        q, scale, mine, noise, q_out, scale_out, resid, block);
  else
    quant_hop_kernel<HOP0, STOCH, RESID, 1><<<grid, threads, 0, stream>>>(
        q, scale, mine, noise, q_out, scale_out, resid, block);
  return cudaGetLastError();
}

template <bool HOP0, bool STOCH>
cudaError_t launch_resid(bool want_resid, const int8_t* q, const float* scale,
                         const float* mine, const float* noise,
                         int8_t* q_out, float* scale_out, float* resid,
                         long long nb, int block, int vec,
                         cudaStream_t stream) {
  if (want_resid)
    return launch<HOP0, STOCH, true>(q, scale, mine, noise, q_out, scale_out,
                                     resid, nb, block, vec, stream);
  return launch<HOP0, STOCH, false>(q, scale, mine, noise, q_out, scale_out,
                                    resid, nb, block, vec, stream);
}

}  // namespace

// q == nullptr: hop 0 (part = mine).  noise == nullptr: round half to
// even.  resid == nullptr: no residual.  vec is 4 (block % 4 == 0 and
// every operand aligned for char4 / float4) or 1.  Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int mpi4torch_quant_hop(const void* q, const void* scale,
                                   const void* mine, const void* noise,
                                   void* q_out, void* scale_out, void* resid,
                                   long long nb, int block, int vec,
                                   void* stream) {
  if (nb <= 0 || nb > 2147483647LL || block <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && block % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  const auto* mp = static_cast<const float*>(mine);
  const auto* np = static_cast<const float*>(noise);
  auto* qo = static_cast<int8_t*>(q_out);
  auto* so = static_cast<float*>(scale_out);
  auto* ro = static_cast<float*>(resid);
  const bool want_resid = ro != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qp == nullptr) {
    err = np ? launch_resid<true, true>(want_resid, qp, sp, mp, np, qo, so,
                                        ro, nb, block, vec, st)
             : launch_resid<true, false>(want_resid, qp, sp, mp, np, qo, so,
                                         ro, nb, block, vec, st);
  } else {
    err = np ? launch_resid<false, true>(want_resid, qp, sp, mp, np, qo, so,
                                         ro, nb, block, vec, st)
             : launch_resid<false, false>(want_resid, qp, sp, mp, np, qo, so,
                                          ro, nb, block, vec, st);
  }
  return static_cast<int>(err);
}
