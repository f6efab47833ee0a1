// Block attention forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces: the TPU kernel `_fwd_kernel` of mpi4torch_tpu/ops/flash.py
// (launched by `_pallas_block`).  Same function: the normalised attention
// partials (out, lse) of q against one KV block, with an online softmax
// over KV tiles; causal and sliding-window masks by global int32 positions
// (q_off / kv_off); GQA by index (q head hh reads KV head hh / (h / h_kv));
// a fully masked row gives out = 0 and lse = -1e30.  KV tiles beyond the
// causal frontier and below the window start are skipped; both cuts are
// exactly neutral (those tiles would add p = 0 and leave the running max
// alone), the argument of `_causal_n_live` / `_window_start_tile` there.
//
// What bounds it on the H100: the work is 4*b*h*d multiply-adds-worth of
// FLOPs per unmasked (q, k) pair.  At long prompts that is tensor-core
// bound (989 TFLOP/s bf16); at short prompts the q/k/v/out bytes
// (3.35 TB/s) are.
//
// What this first design does about it: it is the simple, exact version.
// One thread block of 256 threads per (q tile, batch x head), batch x head
// on grid x (up to 2^31 - 1) and the q tile on grid y.  The q tile and each
// K/V tile are staged through shared memory in f32; each thread owns an
// R x R block of the score tile and an R x (DMAX/16) block of the output
// accumulator in registers; the row statistics of the online softmax live
// in registers and are reduced across the 16 threads of a row with warp
// shuffles.  All products are f32 FMA on the CUDA cores: f32 inputs get no
// TF32 (the JAX package pins f32-exact contraction for f32 operands), and
// bf16 inputs are widened on load.  So this kernel runs at the CUDA-core
// FMA rate, well under the tensor-core bound; wgmma, TMA staging and warp
// specialisation are later work.
//
// Layout: q (b, sq, h, d), k and v (b, sk, h_kv, d) with the last
// dimension contiguous and the other strides passed in (elements).  out
// is written contiguous (b, sq, h, d) in q's type, lse contiguous
// (b, sq, h) in f32.  d is a multiple of 8 up to 512; it is zero-padded
// in shared memory to the instantiated width DMAX, which changes no dot
// product.  Tiles are 16 R rows: R = 4 (64-row tiles) for DMAX 64, 128
// and 256; R = 2 (32-row tiles) for DMAX 512, where 64-row tiles would need
// 394 KB of shared memory (32-row ones need 197 KB, one block per SM).
// The softmax scale is 1 / sqrt(dh) of the true head dim dh <= d: a head
// dim that is not a multiple of 8 arrives zero-padded by the launcher.
// Ragged sq / sk edges are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block: 16 (tx) x 16 (ty)
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Floor division for a positive divisor (C++ '/' truncates toward zero).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Max / sum over the 16 lanes that share one score row (lanes differ in
// their low four bits, so xor 8, 4, 2, 1 stays inside the row's group).
__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// R rows of q (and of keys) per thread: tiles of 16 R rows.
template <int DMAX>
__host__ __device__ constexpr int rows_per_thread() {
  return DMAX <= 256 ? 4 : 2;
}

template <int DMAX>
constexpr size_t smem_bytes() {
  constexpr int B = 16 * rows_per_thread<DMAX>();
  return sizeof(float) *
         (size_t)(B * (DMAX + 1) + 2 * B * (DMAX + 1) + B * (B + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int h, int h_kv, int sq, int sk,
                 int d, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int q_off,
                 int kv_off, int causal, int window, float scale) {
  constexpr int R = rows_per_thread<DMAX>();
  constexpr int BQ = 16 * R;     // q rows per block
  constexpr int BK = 16 * R;     // KV rows per tile
  constexpr int LD = DMAX + 1;  // odd row stride: conflict-free columns
  constexpr int LDP = BK + 1;
  constexpr int DC = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ks = Qs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ps = Vs + BK * LD;    // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16*jj, out columns tx + 16*c
  const int ty = tid >> 4;  // rows ty + 16*i
  const int row0 = blockIdx.y * BQ;
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int hk = hh / (h / h_kv);

  const T* qb = q + (long long)b * q_sb + hh * q_sh;
  const T* kb = k + (long long)b * k_sb + hk * k_sh;
  const T* vb = v + (long long)b * v_sb + hk * v_sh;

  for (int idx = tid; idx < BQ * DMAX; idx += NT) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int row = row0 + r;
    Qs[r * LD + c] =
        (row < sq && c < d) ? to_f32(qb[(long long)row * q_ss + c]) : 0.f;
  }

  // Live KV tiles for this q tile: [j_begin, j_end).
  const int n_tiles = (sk + BK - 1) / BK;
  int j_begin = 0, j_end = n_tiles;
  if (causal) {
    const int q_hi = q_off + min(sq, row0 + BQ) - 1;
    j_end = clampi(floordiv(q_hi - kv_off, BK) + 1, 0, n_tiles);
    if (window > 0)
      j_begin = clampi(floordiv(q_off + row0 - window + 1 - kv_off, BK), 0,
                       n_tiles);
  }

  float m_i[R], l_i[R], acc[R][DC];
  int qpos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_i[i] = NEG_BIG;
    l_i[i] = 0.f;
    qpos[i] = q_off + row0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int c0 = j * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done
    for (int idx = tid; idx < BK * DMAX; idx += NT) {
      const int r = idx / DMAX, c = idx % DMAX;
      const int col = c0 + r;
      const bool ok = col < sk && c < d;
      Ks[r * LD + c] = ok ? to_f32(kb[(long long)col * k_ss + c]) : 0.f;
      Vs[r * LD + c] = ok ? to_f32(vb[(long long)col * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < R; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[R], kv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) kv[jj] = Ks[(tx + 16 * jj) * LD + c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      bool live[R];
      float rmax = NEG_BIG;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int col = c0 + tx + 16 * jj;
        const int kpos = kv_off + col;
        bool ok = col < sk;
        if (causal)
          ok = ok && qpos[i] >= kpos && (window <= 0 || qpos[i] - kpos < window);
        live[jj] = ok;
        s[i][jj] = ok ? s[i][jj] * scale : NEG_BIG;
        rmax = fmaxf(rmax, s[i][jj]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(rmax));
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const float p = live[jj] ? expf(s[i][jj] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * jj] = p;
        psum += p;
      }
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + row_sum16(psum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the whole P tile is in shared memory

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= sq) continue;
    const bool nz = l_i[i] > 0.f;
    const long long o = ((long long)b * sq + row) * h + hh;
    T* orow = out + o * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(orow + col, nz ? acc[i][c] / l_i[i] : 0.f);
    }
    if (tx == 0) lse[o] = nz ? m_i[i] + logf(l_i[i]) : NEG_BIG;
  }
}

// The kernel for element type T and head dim d, its dynamic shared memory
// and its q-tile rows; sets the attribute that allows that much shared
// memory.
template <typename T>
cudaError_t pick_t(int d, const void** fn, size_t* smem, int* bq) {
  if (d <= 64) {
    *fn = (const void*)flash_fwd_kernel<T, 64>;
    *smem = smem_bytes<64>();
    *bq = 16 * rows_per_thread<64>();
  } else if (d <= 128) {
    *fn = (const void*)flash_fwd_kernel<T, 128>;
    *smem = smem_bytes<128>();
    *bq = 16 * rows_per_thread<128>();
  } else if (d <= 256) {
    *fn = (const void*)flash_fwd_kernel<T, 256>;
    *smem = smem_bytes<256>();
    *bq = 16 * rows_per_thread<256>();
  } else {
    *fn = (const void*)flash_fwd_kernel<T, 512>;
    *smem = smem_bytes<512>();
    *bq = 16 * rows_per_thread<512>();
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

cudaError_t pick(int is_bf16, int d, const void** fn, size_t* smem,
                 int* bq) {
  return is_bf16 ? pick_t<__nv_bfloat16>(d, fn, smem, bq)
                 : pick_t<float>(d, fn, smem, bq);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  `strides` holds the element
// strides (batch, seq, head) of q, then k, then v.  `is_bf16` selects the
// element type of q/k/v/out (0 = float32, 1 = bfloat16).  `d` is the
// operands' head dim and `dh` <= d the true head dim, whose 1 / sqrt(dh)
// is the softmax scale.
extern "C" int mpi4torch_flash_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int is_bf16, int b, int h, int h_kv,
                                   int sq, int sk, int d,
                                   const long long* strides, int q_off,
                                   int kv_off, int causal, int window,
                                   int dh, void* stream) {
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || sq < 1 || sk < 0 ||
      d < 8 || d > 512 || d % 8 != 0 || dh < 1 || dh > d ||
      (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  int bq;
  cudaError_t e = pick(is_bf16, d, &fn, &smem, &bq);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (sq + bq - 1) / bq;
  if (n_q > 65535) return (int)cudaErrorInvalidValue;
  const long long* p = strides;
  long long q_sb = p[0], q_ss = p[1], q_sh = p[2], k_sb = p[3], k_ss = p[4],
            k_sh = p[5], v_sb = p[6], v_ss = p[7], v_sh = p[8];
  const float scale = 1.0f / sqrtf((float)dh);
  void* args[] = {&q,    &k,    &v,    &out,  &lse,  &h,    &h_kv,
                  &sq,   &sk,   &d,    &q_sb, &q_ss, &q_sh, &k_sb,
                  &k_ss, &k_sh, &v_sb, &v_ss, &v_sh, &q_off, &kv_off,
                  &causal, &window, (void*)&scale};
  return (int)cudaLaunchKernel(fn, dim3(b * h, n_q), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

// What the compiler and the card made of the kernel for element type
// `is_bf16` at head dim d: writes registers per thread, local-memory bytes
// per thread (spills), static and dynamic shared memory per block, and the
// blocks that fit on one SM, to out[0..4].
extern "C" int mpi4torch_flash_fwd_props(int is_bf16, int d, int* out) {
  const void* fn;
  size_t smem;
  int bq;
  cudaError_t e = pick(is_bf16, d, &fn, &smem, &bq);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return 0;
}
