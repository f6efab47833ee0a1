// Block attention forward on Hopper's tensor cores (sm_90a), behind a plain
// C interface: bfloat16 operands with a head dim d that is a multiple of 8
// up to 128 (the variant "tc"; float32, and bfloat16 with d > 128, take
// flash_fwd.cu, the variant "simt").
//
// Replaces: the TPU kernel `_fwd_kernel` (mpi4torch_tpu/ops/flash.py:243,
// launched by `_pallas_block` at :349).  Same function as flash_fwd.cu: the
// normalised attention partials (out, lse) of q against one KV block, with
// an online softmax over KV tiles; causal and sliding-window masks by the
// global int32 positions q_off + row and kv_off + col; GQA by index (q head
// hh reads KV head hh / (h / h_kv)); a fully masked row gives out = 0 and
// lse = -1e30.  Rounding is the TPU kernel's own: s is summed in f32, p is
// rounded to bf16 where it enters the PV product (`p.astype(vb.dtype)` at
// flash.py:289), the row max, the row sum and the output accumulator stay
// f32, and out rounds once to bf16 at the end.
//
// What bounds it on the H100: per unmasked (query, key) pair and head it
// does 4 d FLOPs (s and PV).  At the training shape (8, 2048, 16, 128)
// bf16 causal that is 137.5 GFLOP against 269 MB of q/k/v/out/lse, so it
// is operations-bound on the bf16 tensor cores (989 TFLOP/s): 0.139 ms
// (the bytes alone would take 0.080 ms at 3.35 TB/s).
// At the serving prefill (1, 1024, 16, 128) it is 4.3 GFLOP against 16.8
// MB, bytes-bound (3.35 TB/s): 0.005 ms, where a grid of 256 blocks of 64
// rows is one wave on 132 SMs and the time is the latency of one q tile's
// walk over its KV tiles.
//
// What this design does about it (the design of flash_bwd_tc.cu's K3):
//
// * Both products of a tile run on the tensor cores as bf16 x bf16 -> f32
//   `mma.sync.aligned.m16n8k16`.  Each of four warps owns 16 rows of the
//   block's 64-row q tile.  S = Q_w K^T takes the warp's Q fragments from
//   registers (loaded once per block with `ldmatrix`) and K from shared
//   memory by `ldmatrix`.  The S accumulators, after the online softmax
//   and a bf16 pack, are the A fragments of O_w += P V directly (no
//   shared-memory round trip for P); V comes by `ldmatrix.trans`.
// * The online softmax stays in registers: the row max goes over the four
//   lanes that share an accumulator row (`__shfl_xor_sync` 1 and 2), the
//   scale and log2(e) fold into one multiply-add per score ahead of the
//   SFU's `ex2.approx` (not the library's exp2f, whose range handling
//   measured as a sixth of the kernel's time), O is rescaled by the
//   correction once per tile, and each lane keeps a partial row sum over
//   its own columns that the quad adds up once at the end.
// * bf16 tiles in shared memory, rows padded by 16 bytes (LD = DMAX + 8) so
//   the eight rows of an `ldmatrix` fall in distinct bank groups, filled by
//   16-byte `cp.async` with zero fill past d and past the ragged sq / sk
//   edges.  K/V are double-buffered: tile j + 1 loads while tile j
//   computes.  At DMAX 128 that is 17 KB for Q and 68 KB for K/V, so two
//   blocks (eight MMA warps) fit an SM; the 64 + 32 + 32 registers of the
//   O accumulators, the S tile and the Q fragments fit the 255 that
//   __launch_bounds__(128, 2) allows without spilling (chip_smoke.py
//   phase 2 reads the registers and local memory back).
// * The tile shape is the one of the shapes tools/flash_fwd_tc_sweep.py
//   measures (64 or 128 q rows, four or eight warps, 32- or 64-key tiles)
//   that neither spills nor loses at the training or the prefill shape:
//   eight warps of 16 rows fit one block per SM in the registers, and
//   32-key tiles double the barriers and copy waits per product.
// * Causal and window tile cuts as in flash_fwd.cu; the per-element mask
//   runs only on tiles that straddle the diagonal, the window edge or a
//   ragged sk edge.  A masked score is -inf, so its p is exactly
//   ex2(-inf) = 0 whatever the running max (which starts at -1e30 and
//   stays finite): a tile whose pairs of one row are all masked adds
//   nothing to that row, and a row masked everywhere ends with l = 0.
//   Zero-filled keys past sk score 0, not -inf, so they are masked in the
//   non-causal case too.  Under a causal mask the q tiles are taken
//   heaviest first, with the tile index on the slow grid axis.
//
// Later work: wgmma with 64-row warpgroup tiles (the only way to the full
// tensor-core rate), TMA copies with a producer warp, and output stores
// staged through shared memory.
//
// Layout: q (b, sq, h, d), k and v (b, sk, h_kv, d), with the last
// dimension contiguous and every (batch, seq, head) row starting on a
// 16-byte boundary (the wrapper guarantees it); strides are passed in
// elements.  out is written contiguous (b, sq, h, d) in bf16, lse
// contiguous (b, sq, h) in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;   // threads per block
constexpr int BQ = 16 * NW;   // q rows per block: 16 per warp
constexpr int BK = 64;        // keys per KV tile
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ bool pair_live(int qpos, int kpos, int causal,
                                          int window) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// Every pair of q rows [q_lo, q_hi] x keys [k_lo, k_hi] (positions) is
// unmasked: the tile needs no per-element mask.
__device__ __forceinline__ bool tile_interior(int q_lo, int q_hi, int k_lo,
                                              int k_hi, int causal,
                                              int window) {
  if (!causal) return true;
  return q_lo >= k_hi && (window <= 0 || q_hi - k_lo < window);
}

// 2^x on the SFU (`ex2.approx`, relative error below 2^-22; ex2(-inf) =
// +0).  The library's exp2f wraps the same instruction in a slower path
// for accuracy that p, rounded to bf16, has no use for.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` (0 or 16) are read
// from src and the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy ROWS rows of one head of a (batch, seq, head, d) bf16 operand, from
// sequence row r0 on, into shared memory [ROWS][DMAX + 8]; rows at or
// beyond n and columns at or beyond d are zero.
template <int ROWS, int DMAX>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int n,
                                          int d) {
  constexpr int CPR = DMAX / 8;  // 16-byte chunks per row
  constexpr int LD = DMAX + 8;
  static_assert((ROWS * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < n && c < d;
    cp_async16(dst + r * LD + c, ok ? src + (long long)row * ss + c : src,
               ok ? 16 : 0);
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (DMAX + 8);
}

// One block per (BQ-row q tile, batch x q head); warp w owns q rows
// 16 w .. 16 w + 15 of the tile.  A loop over KV tiles, double-buffered.
// sl2 = log2(e) / sqrt(d): scores times sl2 are base-2 exponents.
template <int DMAX>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int h, int h_kv, int sq, int sk,
                    int d, Strides st, int q_off, int kv_off, int causal,
                    int window, float sl2) {
  constexpr int LD = DMAX + 8;
  constexpr int KD = DMAX / 16;  // k steps over the head dim
  constexpr int NK = BK / 8;     // key columns of S, in n tiles
  constexpr int ND = DMAX / 8;   // head-dim columns of O, in n tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int hk = hh / (h / h_kv);
  // Under a causal mask the last q tiles walk the most KV tiles: take
  // them first.
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int row0 = qt * BQ;

  const bf16* qb = q + b * st.q_b + hh * st.q_h;
  const bf16* kb = k + b * st.k_b + hk * st.k_h;
  const bf16* vb = v + b * st.v_b + hk * st.v_h;

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

  load_tile<BQ, DMAX>(Qs, qb, st.q_s, row0, sq, d);
  if (j_begin < j_end) {
    load_tile<BK, DMAX>(Ks, kb, st.k_s, j_begin * BK, sk, d);
    load_tile<BK, DMAX>(Vs, vb, st.v_s, j_begin * BK, sk, d);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The warp's 16 q rows as A fragments, once for the whole KV loop.
  uint32_t qa[KD][4];
  {
    const bf16* a_row = Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * LD + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) ldsm_x4(qa[ks], a_row + ks * 16);
  }

  // This thread's two q rows (C-fragment rows g and g + 8 of its warp);
  // m in base-2 exponent units, l this lane's share of the row sum.
  const int r_lo = row0 + warp * 16 + (lane >> 2);
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // K rows for ldmatrix: lanes 0-7 and 8-15 address keys 0-7 at head-dim
  // columns 0 and 8 of a k step, lanes 16-31 keys 8-15.
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                     ((lane >> 3) & 1) * 8;
  // V rows for ldmatrix.trans: keys 0-7 / 8-15 of a k step, head-dim
  // columns 0 and 8 of an n-tile pair.
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 8;

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      const int nxt = stage ^ 1;
      load_tile<BK, DMAX>(Ks + nxt * BK * LD, kb, st.k_s, (j + 1) * BK, sk,
                          d);
      load_tile<BK, DMAX>(Vs + nxt * BK * LD, vb, st.v_s, (j + 1) * BK, sk,
                          d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q_w K^T, f32.
    float s[NK][4];
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
      s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
      for (int jj = 0; jj < NK; jj += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + k_lane + jj * 8 * LD + ks * 16);
        mma16816(s[jj], qa[ks], bk[0], bk[1]);
        mma16816(s[jj + 1], qa[ks], bk[2], bk[3]);
      }
    }

    const int c0 = j * BK;
    const bool interior =
        c0 + BK <= sk &&
        tile_interior(q_off + row0, q_off + row0 + BQ - 1, kv_off + c0,
                      kv_off + c0 + BK - 1, causal, window);
    if (!interior) {
#pragma unroll
      for (int jj = 0; jj < NK; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r_lo + 8 * (e >> 1);
          const int col = c0 + jj * 8 + 2 * (lane & 3) + (e & 1);
          if (!(col < sk &&
                pair_live(q_off + row, kv_off + col, causal, window)))
            s[jj][e] = -INFINITY;
        }
    }

    // Online softmax: new row max over the quad, correction, p.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) {
      mx[0] = fmaxf(mx[0], fmaxf(s[jj][0], s[jj][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[jj][2], s[jj][3]));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[jj][e], sl2, -m[e >> 1]));
        s[jj][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] *= corr[e >> 1];

    // O_w += P V: P rounded to bf16 as A fragments, V by ldmatrix.trans.
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int jj = 0; jj < ND; jj += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + v_lane + ks * 16 * LD + jj * 8);
        mma16816(acc[jj], pa, bv[0], bv[1]);
        mma16816(acc[jj + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // Whole row sums, then out = acc / l and lse = m ln 2 + log l (out = 0,
  // lse = -1e30 where nothing was live).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* ob = out + ((long long)b * sq * h + hh) * d;
  const long long rs = (long long)h * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= sq) continue;
    const bool nz = l[i] > 0.f;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj) {
      const int col = jj * 8 + 2 * (lane & 3);
      if (col < d)
        *reinterpret_cast<uint32_t*>(ob + row * rs + col) =
            nz ? pack_bf16(acc[jj][2 * i] / l[i], acc[jj][2 * i + 1] / l[i])
               : 0u;
    }
    if ((lane & 3) == 0)
      lse[((long long)b * sq + row) * h + hh] =
          nz ? m[i] * LN2 + logf(l[i]) : NEG_BIG;
  }
}

// The kernel for head dim d (DMAX 64 or 128) and its dynamic shared
// memory; sets the attribute that allows that much.
cudaError_t pick(int d, const void** fn, size_t* smem) {
  *fn = d <= 64 ? (const void*)flash_fwd_tc_kernel<64>
                : (const void*)flash_fwd_tc_kernel<128>;
  *smem = d <= 64 ? smem_bytes<64>() : smem_bytes<128>();
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Operands are bfloat16 (lse
// float32); `strides` holds the element strides (batch, seq, head) of q,
// then k, then v.  `d` is the operands' head dim and `dh` <= d the true
// head dim, whose 1 / sqrt(dh) is the softmax scale: a head dim that is not
// a multiple of 8 arrives zero-padded to d by the launcher.
extern "C" int mpi4torch_flash_fwd_tc(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int b, int h, int h_kv, int sq, int sk,
                                      int d, const long long* strides,
                                      int q_off, int kv_off, int causal,
                                      int window, int dh, void* stream) {
  const int n_q = (sq + BQ - 1) / BQ;
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || sq < 1 || sk < 0 ||
      d < 8 || d > 128 || d % 8 != 0 || dh < 1 || dh > d || n_q > 65535)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  cudaError_t e = pick(d, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const long long* p = strides;
  Strides st{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
  const float sl2 = LOG2E / sqrtf((float)dh);
  void* args[] = {&q,  &k,  &v,  &out,     &lse,    &h,
                  &h_kv, &sq, &sk, &d,     &st,     &q_off,
                  &kv_off, &causal, &window, (void*)&sl2};
  return (int)cudaLaunchKernel(fn, dim3(b * h, n_q), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

// What the compiler and the card made of the kernel at head dim d: writes
// registers per thread, local-memory bytes per thread (spills), static and
// dynamic shared memory per block, and the blocks that fit on one SM, to
// out[0..4].
extern "C" int mpi4torch_flash_fwd_tc_props(int d, int* out) {
  const void* fn;
  size_t smem;
  cudaError_t e = pick(d, &fn, &smem);
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
