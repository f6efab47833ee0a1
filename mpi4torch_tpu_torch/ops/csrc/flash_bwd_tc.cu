// Block attention backward on Hopper's tensor cores (sm_90a), behind a
// plain C interface: dq (K3) and dk/dv (K4) for bfloat16 operands with a
// head dim d that is a multiple of 8 up to 128 (the variant "tc"; float32,
// and bfloat16 with d > 128, take flash_bwd.cu, the variant "simt").
//
// Replaces: the TPU kernels `_bwd_dq_kernel` (mpi4torch_tpu/ops/flash.py:444,
// launched at :585) and `_bwd_dkv_kernel` (:485, launched at :611).  Same
// function as flash_bwd.cu: for every unmasked (query, key) pair
//
//     p  = exp(s * scale - lse),   s  = q . k
//     ds = p * (do . v - dd)
//     dq = scale * sum_k ds k      (K3: one block per q tile)
//     dv = sum_q p do,  dk = scale * sum_q ds q   (K4: one block per KV tile)
//
// with dd = sum(do * out) - dlse computed outside the kernels.  Rounding is
// the TPU kernel's own: p and ds are rounded to bf16 where they enter a
// product (`ds.astype(kb.dtype)` at flash.py:472, `p.astype(do_t.dtype)`
// at :515, `ds.astype(q_t.dtype)` at :518); every sum is f32; lse, dd, the
// exponent and the masks stay f32 / int32; the gradients round once to
// bf16 at the end.
//
// What bounds it on the H100: per unmasked pair and head K3 does 6 d FLOPs
// (s, dp, dq) and K4 8 d (s, dp, dv, dk).  At the training shape (8, 2048,
// 16, 128) bf16 causal that is 206 and 275 GFLOP against 0.34 and 0.41 GB
// of operands, so both are operations-bound on the bf16 tensor cores (989
// TFLOP/s): 0.21 and 0.28 ms.
//
// What this design does about it:
//
// * All five products of a tile run on the tensor cores as bf16 x bf16 ->
//   f32 `mma.sync.aligned.m16n8k16`, operands read from shared memory with
//   `ldmatrix` (`.trans` where the product contracts over rows).  mma.sync
//   rather than wgmma: each warp owns 16 rows of its block's own tile, so
//   the score tile a warp computes is exactly the A operand (16 rows) of
//   its next product, and P / dS go from accumulators to A fragments in
//   registers with no shared-memory round trip.  A wgmma design would need
//   64-row warpgroup tiles and P / dS in the wgmma register layout; that is
//   later work (and wgmma is the only way to the full 989 TFLOP/s).
//     K3, warp w, per KV tile:  S = Q_w K^T and dP = dO_w V^T (ldmatrix),
//       dS in registers -> dQ_w += dS K (K by ldmatrix.trans).
//     K4, warp w, per q tile:   S^T = K_w Q^T and dP^T = V_w dO^T, so P^T
//       and dS^T already sit in the accumulator layout with KV rows as M;
//       packed to bf16 they are the A operands of dV_w += P^T dO and
//       dK_w += dS^T Q (dO, Q by ldmatrix.trans).
// * Operands stay bf16 in shared memory (half the bytes of flash_bwd.cu's
//   f32 staging), copied with 16-byte `cp.async` (zero-filled past d and past
//   the ragged sq / sk edges), double-buffered on the looped-over operand:
//   K/V tiles in K3; Q/dO tiles and their lse/dd rows (4-byte cp.async) in
//   K4.  The block's own tile (Q/dO in K3, K/V in K4) is loaded once.  Rows
//   are padded by 16 bytes (LD = DMAX + 8), so the eight 16-byte rows of an
//   ldmatrix fall in eight distinct bank groups: no conflicts.  A d that is
//   not a multiple of 16 (72, say) is zero-padded to DMAX (64 or 128).
// * Tiles: K3 64 q rows x 64 keys, K4 64 keys x 32 q rows, four warps
//   (128 threads) each.  At DMAX = 128 shared memory is 104 KB (K3) and
//   69 KB (K4), so two blocks (eight MMA warps) fit an SM.  The f32
//   accumulators take 64 (K3) and 128 (K4) registers a thread; each kernel
//   fits the 255 that __launch_bounds__(128, 2) allows without spilling
//   (chip_smoke.py phase 2 reads the registers and local memory back).
// * Causal and window tile cuts as in flash_bwd.cu; the per-element mask
//   runs only on tiles that straddle the diagonal, the window edge or a
//   ragged edge, interior tiles skip it.  K3 takes its q tiles in reverse
//   under a causal mask and both kernels put the tile index on the slow
//   grid axis, so the heaviest blocks (the last q tiles of K3, the first KV
//   tiles of K4) are scheduled first and the light ones fill the tail.
// * Nothing is atomic.  K3 is one block per q tile, K4 one block per KV
//   tile that walks its group's q heads in a fixed order, so the same
//   inputs give the same bits.
//
// Layout: q and do (b, sq, h, d); k and v (b, sk, h_kv, d); lse and dd
// (b, sq, h) f32.  The last dimension of q/k/v/do is contiguous and every
// (batch, seq, head) row starts on a 16-byte boundary (the wrapper
// guarantees it); strides are passed in elements.  dq is written
// contiguous (b, sq, h, d), dk and dv contiguous (b, sk, h_kv, d), bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;   // threads per block
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h,
      l_b, l_s, l_h, d_b, d_s, d_h;
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// One row statistic (lse or dd) per q row of a tile, rows r0 .. r0 + ROWS;
// zero past n.
template <int ROWS>
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           long long ss, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const int row = r0 + i;
    const bool ok = row < n;
    cp_async4(dst + i, ok ? src + (long long)row * ss : src, ok ? 4 : 0);
  }
}

// acc = A B^T for one warp: A is 16 rows of shared memory [.][LD], B is
// NTILE * 8 rows [.][LD], both contracted over their first 16 * KSTEPS
// columns.  acc[j] is the C fragment of columns 8 j .. 8 j + 7.
template <int NTILE, int KSTEPS, int LD>
__device__ __forceinline__ void gemm_abt(float (&acc)[NTILE][4],
                                         const bf16* A, const bf16* B,
                                         int lane) {
  static_assert(NTILE % 2 == 0, "n tiles come in pairs");
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* a_row = A + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      (lane >> 4) * 8;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_row + ks * 16);
#pragma unroll
    for (int j = 0; j < NTILE; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_row + j * 8 * LD + ks * 16);
      mma16816(acc[j], a, b[0], b[1]);
      mma16816(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc += A B for one warp: A (16 x 16 KSTEPS) is in registers as bf16 A
// fragments, B is 16 KSTEPS rows of shared memory [.][LD] (the contracted
// dimension runs down the rows; read with ldmatrix.trans), NTILE * 8
// columns wide.
template <int NTILE, int KSTEPS, int LD>
__device__ __forceinline__ void gemm_ab(float (&acc)[NTILE][4],
                                        const uint32_t (&a)[KSTEPS][4],
                                        const bf16* B, int lane) {
  static_assert(NTILE % 2 == 0, "n tiles come in pairs");
  const bf16* b_row = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int j = 0; j < NTILE; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, b_row + ks * 16 * LD + j * 8);
      mma16816(acc[j], a[ks], b[0], b[1]);
      mma16816(acc[j + 1], a[ks], b[2], b[3]);
    }
  }
}

// The C fragments of 16 KSTEPS columns, rounded to bf16 as A fragments of
// the next product (columns become its contracted dimension).
template <int KSTEPS>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KSTEPS][4],
                                           const float (&c)[2 * KSTEPS][4]) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    a[ks][0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// Write one warp's 16 x DMAX f32 accumulator times `mul` as bf16 rows
// r_lo and r_lo + 8 (those below n) of a contiguous (., n, heads, d)
// output at `base` (row 0 of this batch and head; row stride `rs`).
template <int NTILE>
__device__ __forceinline__ void store_rows(bf16* base, long long rs,
                                           const float (&acc)[NTILE][4],
                                           float mul, int r_lo, int n, int d,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NTILE; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (col >= d) continue;
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(base + r_lo * rs + col) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (r_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (r_lo + 8) * rs + col) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int DMAX, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * (DMAX + 8);
}

template <int DMAX, int BK, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BK + 4 * BQ) * (DMAX + 8) +
         sizeof(float) * 4 * BQ;
}

// K3: one block per (BQ-row q tile, batch x q head); warp w owns q rows
// 16 w .. 16 w + 15 of the tile.  A loop over KV tiles, double-buffered.
template <int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dd, bf16* __restrict__ dq,
                       int h, int h_kv, int sq, int sk, int d, Strides st,
                       int q_off, int kv_off, int causal, int window,
                       float scale) {
  static_assert(BQ == 16 * NW, "one 16-row slice of the q tile per warp");
  constexpr int LD = DMAX + 8;
  constexpr int KD = DMAX / 16;  // k steps over the head dim
  constexpr int NK = BK / 8;     // key columns of S, in n tiles
  constexpr int ND = DMAX / 8;   // head-dim columns of dQ, in n tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ds = Qs + BQ * LD;                       // [BQ][LD]  do
  bf16* Ks = Ds + BQ * LD;                       // [2][BK][LD]
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
  const bf16* dob = dout + b * st.o_b + hh * st.o_h;
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
  load_tile<BQ, DMAX>(Ds, dob, st.o_s, row0, sq, d);
  if (j_begin < j_end) {
    load_tile<BK, DMAX>(Ks, kb, st.k_s, j_begin * BK, sk, d);
    load_tile<BK, DMAX>(Vs, vb, st.v_s, j_begin * BK, sk, d);
  }
  cp_async_commit();

  // This thread's two q rows (C-fragment rows g and g + 8 of its warp).
  const int r_lo = row0 + warp * 16 + (lane >> 2);
  float lse2[2], ddv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    lse2[i] = row < sq ? lse[b * st.l_b + row * st.l_s + hh * st.l_h] * LOG2E
                       : 0.f;
    ddv[i] = row < sq ? dd[b * st.d_b + row * st.d_s + hh * st.d_h] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  const bool full_rows = row0 + BQ <= sq;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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

    float s[NK][4], dp[NK][4];
    gemm_abt<NK, KD, LD>(s, Qs + warp * 16 * LD, Kt, lane);
    gemm_abt<NK, KD, LD>(dp, Ds + warp * 16 * LD, Vt, lane);

    const int c0 = j * BK;
    const bool interior =
        full_rows && c0 + BK <= sk &&
        tile_interior(q_off + row0, q_off + row0 + BQ - 1, kv_off + c0,
                      kv_off + c0 + BK - 1, causal, window);
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[jj][e], sl2, -lse2[e >> 1]));
        if (!interior) {
          const int row = r_lo + 8 * (e >> 1);
          const int col = c0 + jj * 8 + 2 * (lane & 3) + (e & 1);
          if (!(row < sq && col < sk &&
                pair_live(q_off + row, kv_off + col, causal, window)))
            p = 0.f;
        }
        s[jj][e] = p * (dp[jj][e] - ddv[e >> 1]);  // ds
      }
    uint32_t ds_a[BK / 16][4];
    to_a_frags<BK / 16>(ds_a, s);
    gemm_ab<ND, BK / 16, LD>(acc, ds_a, Kt, lane);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  store_rows<ND>(dq + ((long long)b * sq * h + hh) * d, (long long)h * d,
                 acc, scale, r_lo, sq, d, lane);
}

// K4: one block per (BK-row KV tile, batch x KV head); warp w owns key
// rows 16 w .. 16 w + 15.  A loop over the q heads of the KV head's group
// and, inside, over q tiles, flattened into one double-buffered sequence.
template <int DMAX, int BK, int BQ>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int h, int h_kv, int sq,
                        int sk, int d, Strides st, int q_off, int kv_off,
                        int causal, int window, float scale) {
  static_assert(BK == 16 * NW, "one 16-row slice of the KV tile per warp");
  constexpr int LD = DMAX + 8;
  constexpr int KD = DMAX / 16;  // k steps over the head dim
  constexpr int NQ = BQ / 8;     // q columns of S^T, in n tiles
  constexpr int ND = DMAX / 8;   // head-dim columns of dK / dV, in n tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* Vs = Ks + BK * LD;                       // [BK][LD]
  bf16* Qs = Vs + BK * LD;                       // [2][BQ][LD]
  bf16* Ds = Qs + 2 * BQ * LD;                   // [2][BQ][LD]  do
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BQ * LD);  // [2][BQ] lse
  float* Es = Ls + 2 * BQ;                                 // [2][BQ] dd

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / h_kv;
  const int hk = blockIdx.x % h_kv;
  const int g = h / h_kv;
  // Under a causal mask the first KV tiles walk the most q tiles; they
  // come first in blockIdx.y order.
  const int col0 = blockIdx.y * BK;

  // Live q tiles for this KV tile: [i_begin, i_end).
  const int n_q = (sq + BQ - 1) / BQ;
  int i_begin = 0, i_end = n_q;
  if (causal) {
    i_begin = clampi(floordiv(kv_off + col0 - q_off, BQ), 0, n_q);
    if (window > 0) {
      const int kv_hi = kv_off + min(sk, col0 + BK) - 1;
      i_end = clampi(floordiv(kv_hi + window - 1 - q_off, BQ) + 1, 0, n_q);
    }
  }
  const int n_live = max(i_end - i_begin, 0);
  const int n_iter = g * n_live;

  // Stage the operands of iteration t (q head hk g + t / n_live, q tile
  // i_begin + t % n_live) into buffer `buf`.
  auto issue = [&](int t, int buf) {
    const int hh = hk * g + t / n_live;
    const int r0 = (i_begin + t % n_live) * BQ;
    load_tile<BQ, DMAX>(Qs + buf * BQ * LD, q + b * st.q_b + hh * st.q_h,
                        st.q_s, r0, sq, d);
    load_tile<BQ, DMAX>(Ds + buf * BQ * LD, dout + b * st.o_b + hh * st.o_h,
                        st.o_s, r0, sq, d);
    load_stats<BQ>(Ls + buf * BQ, lse + b * st.l_b + hh * st.l_h, st.l_s, r0,
                   sq);
    load_stats<BQ>(Es + buf * BQ, dd + b * st.d_b + hh * st.d_h, st.d_s, r0,
                   sq);
  };

  load_tile<BK, DMAX>(Ks, k + b * st.k_b + hk * st.k_h, st.k_s, col0, sk, d);
  load_tile<BK, DMAX>(Vs, v + b * st.v_b + hk * st.v_h, st.v_s, col0, sk, d);
  if (n_iter > 0) issue(0, 0);
  cp_async_commit();

  // This thread's two key rows (C-fragment rows g and g + 8 of its warp).
  const int k_lo = col0 + warp * 16 + (lane >> 2);
  const float sl2 = scale * LOG2E;
  const bool full_keys = col0 + BK <= sk;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int t = 0; t < n_iter; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_iter) {
      issue(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Dt = Ds + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Et = Es + buf * BQ;
    const int r0 = (i_begin + t % n_live) * BQ;

    float s[NQ][4], dp[NQ][4];  // S^T and dP^T: key rows, q columns
    gemm_abt<NQ, KD, LD>(s, Ks + warp * 16 * LD, Qt, lane);
    gemm_abt<NQ, KD, LD>(dp, Vs + warp * 16 * LD, Dt, lane);

    const bool interior =
        full_keys && r0 + BQ <= sq &&
        tile_interior(q_off + r0, q_off + r0 + BQ - 1, kv_off + col0,
                      kv_off + col0 + BK - 1, causal, window);
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const int qi = jj * 8 + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + qi);
      const float2 e2 = *reinterpret_cast<const float2*>(Et + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x;
        const float ev = (e & 1) ? e2.y : e2.x;
        float p = exp2f(fmaf(s[jj][e], sl2, -lv * LOG2E));
        if (!interior) {
          const int key = k_lo + 8 * (e >> 1);
          const int row = r0 + qi + (e & 1);
          if (!(row < sq && key < sk &&
                pair_live(q_off + row, kv_off + key, causal, window)))
            p = 0.f;
        }
        dp[jj][e] = p * (dp[jj][e] - ev);  // ds^T
        s[jj][e] = p;                      // p^T
      }
    }
    uint32_t p_a[BQ / 16][4], ds_a[BQ / 16][4];
    to_a_frags<BQ / 16>(p_a, s);
    to_a_frags<BQ / 16>(ds_a, dp);
    gemm_ab<ND, BQ / 16, LD>(acc_v, p_a, Dt, lane);
    gemm_ab<ND, BQ / 16, LD>(acc_k, ds_a, Qt, lane);
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

  const long long o = ((long long)b * sk * h_kv + hk) * d;
  const long long rs = (long long)h_kv * d;
  store_rows<ND>(dk + o, rs, acc_k, scale, k_lo, sk, d, lane);
  store_rows<ND>(dv + o, rs, acc_v, 1.f, k_lo, sk, d, lane);
}

// Tile shapes: K3 (BQ, BK) = (64, 64), K4 (BK, BQ) = (64, 32), at DMAX 64
// (d <= 64) and 128.
constexpr int DQ_BQ = 64, DQ_BK = 64, DKV_BK = 64, DKV_BQ = 32;

template <int DMAX>
const void* dq_fn() {
  return (const void*)flash_bwd_dq_tc_kernel<DMAX, DQ_BQ, DQ_BK>;
}
template <int DMAX>
const void* dkv_fn() {
  return (const void*)flash_bwd_dkv_tc_kernel<DMAX, DKV_BK, DKV_BQ>;
}

// The kernel of `part` (0 = dq, 1 = dk/dv) for head dim d, and its dynamic
// shared memory; sets the attribute that allows that much.
cudaError_t pick(int part, int d, const void** fn, size_t* smem) {
  if (part == 0) {
    *fn = d <= 64 ? dq_fn<64>() : dq_fn<128>();
    *smem = d <= 64 ? dq_smem_bytes<64, DQ_BQ, DQ_BK>()
                    : dq_smem_bytes<128, DQ_BQ, DQ_BK>();
  } else {
    *fn = d <= 64 ? dkv_fn<64>() : dkv_fn<128>();
    *smem = d <= 64 ? dkv_smem_bytes<64, DKV_BK, DKV_BQ>()
                    : dkv_smem_bytes<128, DKV_BK, DKV_BQ>();
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

bool bad_shape(int b, int h, int h_kv, int sq, int sk, int d) {
  return b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || sq < 1 || sk < 1 ||
         d < 8 || d > 128 || d % 8 != 0;
}

Strides unpack(const long long* p) {
  return Strides{p[0],  p[1],  p[2],  p[3],  p[4],  p[5],
                 p[6],  p[7],  p[8],  p[9],  p[10], p[11],
                 p[12], p[13], p[14], p[15], p[16], p[17]};
}

}  // namespace

// Both return a cudaError_t code (0 = launched).  Operands are bfloat16
// (lse and dd float32); `strides` holds the element strides (batch, seq,
// head) of q, k, v, do, lse and dd, in that order.  `d` is the operands'
// head dim and `dh` <= d the true head dim, whose 1 / sqrt(dh) is the
// softmax scale: a head dim that is not a multiple of 8 arrives zero-padded
// to d by the launcher, and the zero columns change no dot product.
extern "C" int mpi4torch_flash_bwd_tc_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* dd,
                                         void* dq, int b, int h, int h_kv,
                                         int sq, int sk, int d,
                                         const long long* strides, int q_off,
                                         int kv_off, int causal, int window,
                                         int dh, void* stream) {
  const int n_q = (sq + DQ_BQ - 1) / DQ_BQ;
  if (bad_shape(b, h, h_kv, sq, sk, d) || dh < 1 || dh > d || n_q > 65535)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  cudaError_t e = pick(0, d, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  Strides st = unpack(strides);
  const float scale = 1.0f / sqrtf((float)dh);
  void* args[] = {&q,  &k,  &v,    &dout,   &lse,    &dd,     &dq,
                  &h,  &h_kv, &sq, &sk,     &d,      &st,     &q_off,
                  &kv_off, &causal, &window, (void*)&scale};
  return (int)cudaLaunchKernel(fn, dim3(b * h, n_q), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int mpi4torch_flash_bwd_tc_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dd,
                                          void* dk, void* dv, int b, int h,
                                          int h_kv, int sq, int sk, int d,
                                          const long long* strides,
                                          int q_off, int kv_off, int causal,
                                          int window, int dh, void* stream) {
  const int n_k = (sk + DKV_BK - 1) / DKV_BK;
  if (bad_shape(b, h, h_kv, sq, sk, d) || dh < 1 || dh > d || n_k > 65535)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  cudaError_t e = pick(1, d, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  Strides st = unpack(strides);
  const float scale = 1.0f / sqrtf((float)dh);
  void* args[] = {&q,  &k,  &v,    &dout,   &lse,   &dd,     &dk,
                  &dv, &h,  &h_kv, &sq,     &sk,    &d,      &st,
                  &q_off, &kv_off, &causal, &window, (void*)&scale};
  return (int)cudaLaunchKernel(fn, dim3(b * h_kv, n_k), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

// What the compiler and the card made of a kernel: part 0 = dq, 1 = dk/dv,
// at head dim d.  Writes registers per thread, local-memory bytes per
// thread (spills), static and dynamic shared memory per block, and the
// blocks that fit on one SM, to out[0..4].
extern "C" int mpi4torch_flash_bwd_tc_props(int part, int d, int* out) {
  const void* fn;
  size_t smem;
  cudaError_t e = pick(part, d, &fn, &smem);
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
