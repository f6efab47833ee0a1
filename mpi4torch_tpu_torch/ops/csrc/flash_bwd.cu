// Block attention backward for Hopper (sm_90a), behind a plain C interface:
// two kernels, dq (K3) and dk/dv (K4).
//
// Replaces: the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// mpi4torch_tpu/ops/flash.py (both launched by `_pallas_bwd`).  Same
// function: the gradients of the normalised partials (out, lse) of q against
// one KV block, by recomputation from the forward's residuals.  For every
// unmasked (query, key) pair
//
//     p  = exp(s * scale - lse),   s  = q . k
//     dp = do . v,                 ds = p * (dp - dd)
//
// with dd = delta - dlse = sum(do * out) - dlse computed outside the kernels
// (as the JAX package does), and
//
//     dq = scale * sum_k ds k      (K3: one block per q tile)
//     dv = sum_q p do,  dk = scale * sum_q ds q   (K4: one block per KV tile)
//
// Masks follow global int32 positions (q_off / kv_off): causal, and a
// sliding window of `window` positions.  K3 skips the KV tiles beyond the
// causal frontier and below the window start (the cuts of `_causal_n_live`
// / `_window_start_tile`); K4 makes the mirror cuts (start at the causal
// diagonal, stop after the window's farthest query).  Skipped tiles hold
// only masked pairs, whose p is zero, so the cuts change no bit.  A fully
// masked row (lse = -1e30) has p = 0 everywhere and gets zero gradients.
//
// What bounds it on the H100: per unmasked pair and head, K3 does 6*d
// FLOPs (s, dp, dq) and K4 8*d (s, dp, dv, dk).  At the training shape
// (8, 2048, 16, 128) bf16 causal that is 206 and 275 GFLOP against 0.34 and
// 0.41 GB of operands: tensor-core bound (989 TFLOP/s bf16) at about 0.21
// and 0.28 ms.
//
// What this first design does about it: it is the simple, exact version,
// built like flash_fwd.cu.  256 threads per block as a 16 x 16 grid; batch
// x head on grid x (up to 2^31 - 1), the block's own tile on grid y; every
// operand tile is staged through shared memory in f32 (bf16 is widened on
// load; f32 gets no TF32), each thread owns a small block of the score
// tile and of the f32 gradient accumulators in registers, and all products
// are f32 FMA on the CUDA cores.  So it runs at the CUDA-core rate, well
// under the tensor-core bound; mma.sync / wgmma, TMA staging and more
// blocks in flight are later work.  Nothing is atomic: under grouped-query
// attention a K4 block walks every q head of its KV head's group in turn,
// so dk/dv accumulate in one fixed order and two runs give the same bits.
//
// Layout: q and do (b, sq, h, d); k and v (b, sk, h_kv, d); lse and dd
// (b, sq, h) f32.  The last dimension of q/k/v/do is contiguous; all other
// strides are passed in (elements).  dq is written contiguous (b, sq, h, d)
// in q's type, dk and dv contiguous (b, sk, h_kv, d) in k's type.  d is a
// multiple of 8 up to 512, zero-padded in shared memory to the
// instantiated width DMAX (64, 128, 256 or 512); at DMAX = 256 and 512 the
// tiles are narrower so that shared memory and the accumulators still fit.
// The softmax scale is 1 / sqrt(dh) of the true head dim dh <= d: a head
// dim that is not a multiple of 8 arrives zero-padded by the launcher.
// Ragged sq / sk edges are masked in the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block: 16 (tx) x 16 (ty)

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

__device__ __forceinline__ bool pair_live(int qpos, int kpos, int causal,
                                          int window) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// Stage ROWS rows of one head of a (batch, seq, head, d) operand, from
// sequence row r0 on, into shared memory as f32 [ROWS][DMAX + 1]; rows at
// or beyond n and columns at or beyond d are zero.
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int n, int d) {
  constexpr int LD = DMAX + 1;
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += NT) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int row = r0 + r;
    dst[r * LD + c] =
        (row < n && c < d) ? to_f32(src[(long long)row * ss + c]) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over the first d columns of two
// staged tiles.  LD is odd, so the 16 B rows a warp reads per column fall
// in distinct banks; the A rows are broadcasts.
template <int RI, int RJ, int DMAX>
__device__ __forceinline__ void tile_dot(float (&s)[RI][RJ], const float* A,
                                         const float* B, int d, int ty,
                                         int tx) {
  constexpr int LD = DMAX + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float a[RI], bb[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bb[j] = B[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h,
      l_b, l_s, l_h, d_b, d_s, d_h;
};

template <int DMAX, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (DMAX + 1) +
                          (size_t)BQ * (BK + 1));
}

template <int DMAX, int BK, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (DMAX + 1) +
                          2 * (size_t)BK * (BQ + 1) + 2 * BQ);
}

// K3: one block per (BQ-row q tile, batch x q head); a loop over KV tiles.
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int h,
                    int h_kv, int sq, int sk, int d, Strides st, int q_off,
                    int kv_off, int causal, int window, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int LDS = BK + 1;
  constexpr int RI = BQ / 16;    // q rows per thread
  constexpr int RJ = BK / 16;    // key columns per thread
  constexpr int DC = DMAX / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ds = Qs + BQ * LD;    // [BQ][LD]  do
  float* Ks = Ds + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ss = Vs + BK * LD;    // [BQ][LDS] ds

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * BQ;
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int hk = hh / (h / h_kv);

  const T* qb = q + (long long)b * st.q_b + hh * st.q_h;
  const T* dob = dout + (long long)b * st.o_b + hh * st.o_h;
  const T* kb = k + (long long)b * st.k_b + hk * st.k_h;
  const T* vb = v + (long long)b * st.v_b + hk * st.v_h;
  stage<T, BQ, DMAX>(Qs, qb, st.q_s, row0, sq, d);
  stage<T, BQ, DMAX>(Ds, dob, st.o_s, row0, sq, d);

  float lse_i[RI], dd_i[RI];
  int qpos[RI];
  bool row_ok[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    row_ok[i] = row < sq;
    qpos[i] = q_off + row;
    lse_i[i] =
        row_ok[i] ? lse[(long long)b * st.l_b + row * st.l_s + hh * st.l_h]
                  : 0.f;
    dd_i[i] =
        row_ok[i] ? dd[(long long)b * st.d_b + row * st.d_s + hh * st.d_h]
                  : 0.f;
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

  float acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int c0 = j * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ss reads are done
    stage<T, BK, DMAX>(Ks, kb, st.k_s, c0, sk, d);
    stage<T, BK, DMAX>(Vs, vb, st.v_s, c0, sk, d);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
    tile_dot<RI, RJ, DMAX>(s, Qs, Ks, d, ty, tx);
    tile_dot<RI, RJ, DMAX>(dp, Ds, Vs, d, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int col = c0 + tx + 16 * jj;
        const bool live = row_ok[i] && col < sk &&
                          pair_live(qpos[i], kv_off + col, causal, window);
        const float p = live ? expf(s[i][jj] * scale - lse_i[i]) : 0.f;
        Ss[(ty + 16 * i) * LDS + tx + 16 * jj] = p * (dp[i][jj] - dd_i[i]);
      }
    __syncthreads();  // the whole ds tile is in shared memory

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= sq) continue;
    T* drow = dq + (((long long)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(drow + col, acc[i][c] * scale);
    }
  }
}

// K4: one block per (BK-row KV tile, batch x KV head); a loop over the q
// heads of the KV head's group and, inside, over q tiles.
template <typename T, int DMAX, int BK, int BQ>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int h_kv, int sq, int sk,
                     int d, Strides st, int q_off, int kv_off, int causal,
                     int window, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int LDS = BQ + 1;
  constexpr int RI = BK / 16;    // key rows per thread
  constexpr int RJ = BQ / 16;    // q columns per thread
  constexpr int DC = DMAX / 16;  // dk / dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Qs = Vs + BK * LD;    // [BQ][LD]
  float* Ds = Qs + BQ * LD;    // [BQ][LD]  do
  float* Ps = Ds + BQ * LD;    // [BK][LDS] p, transposed
  float* Gs = Ps + BK * LDS;   // [BK][LDS] ds, transposed
  float* Ls = Gs + BK * LDS;   // [BQ] lse
  float* Es = Ls + BQ;         // [BQ] dd

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = blockIdx.y * BK;
  const int b = blockIdx.x / h_kv;
  const int hk = blockIdx.x % h_kv;
  const int g = h / h_kv;

  stage<T, BK, DMAX>(Ks, k + (long long)b * st.k_b + hk * st.k_h, st.k_s,
                     col0, sk, d);
  stage<T, BK, DMAX>(Vs, v + (long long)b * st.v_b + hk * st.v_h, st.v_s,
                     col0, sk, d);

  int kpos[RI];
  bool key_ok[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int col = col0 + ty + 16 * i;
    key_ok[i] = col < sk;
    kpos[i] = kv_off + col;
  }

  // Live q tiles for this KV tile: [i_begin, i_end).
  const int n_q = (sq + BQ - 1) / BQ;
  int i_begin = 0, i_end = n_q;
  if (causal) {
    // The first q tile whose last query reaches this tile's first key.
    i_begin = clampi(floordiv(kv_off + col0 - q_off, BQ), 0, n_q);
    if (window > 0) {
      // The farthest query inside any of this tile's windows.
      const int kv_hi = kv_off + min(sk, col0 + BK) - 1;
      i_end = clampi(floordiv(kv_hi + window - 1 - q_off, BQ) + 1, 0, n_q);
    }
  }

  float acc_k[RI][DC], acc_v[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  for (int hh = hk * g; hh < (hk + 1) * g; ++hh) {
    const T* qb = q + (long long)b * st.q_b + hh * st.q_h;
    const T* dob = dout + (long long)b * st.o_b + hh * st.o_h;
    const float* lb = lse + (long long)b * st.l_b + hh * st.l_h;
    const float* eb = dd + (long long)b * st.d_b + hh * st.d_h;
    for (int it = i_begin; it < i_end; ++it) {
      const int r0 = it * BQ;
      __syncthreads();  // the previous tile's Qs / Ds / Ps / Gs reads are done
      stage<T, BQ, DMAX>(Qs, qb, st.q_s, r0, sq, d);
      stage<T, BQ, DMAX>(Ds, dob, st.o_s, r0, sq, d);
      for (int idx = tid; idx < BQ; idx += NT) {
        const int row = r0 + idx;
        Ls[idx] = row < sq ? lb[(long long)row * st.l_s] : 0.f;
        Es[idx] = row < sq ? eb[(long long)row * st.d_s] : 0.f;
      }
      __syncthreads();

      float s[RI][RJ], dpt[RI][RJ];
      tile_dot<RI, RJ, DMAX>(s, Ks, Qs, d, ty, tx);
      tile_dot<RI, RJ, DMAX>(dpt, Vs, Ds, d, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          const int qi = tx + 16 * jj;
          const int row = r0 + qi;
          const bool live = key_ok[i] && row < sq &&
                            pair_live(q_off + row, kpos[i], causal, window);
          const float p = live ? expf(s[i][jj] * scale - Ls[qi]) : 0.f;
          Ps[(ty + 16 * i) * LDS + qi] = p;
          Gs[(ty + 16 * i) * LDS + qi] = p * (dpt[i][jj] - Es[qi]);
        }
      __syncthreads();  // the whole p and ds tiles are in shared memory

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RI], gv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LDS + qq];
          gv[i] = Gs[(ty + 16 * i) * LDS + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float dov = Ds[qq * LD + tx + 16 * c];
          const float qv = Qs[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(gv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int col = col0 + ty + 16 * i;
    if (col >= sk) continue;
    const long long o = (((long long)b * sk + col) * h_kv + hk) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int cc = tx + 16 * c;
      if (cc < d) {
        store(dk + o + cc, acc_k[i][c] * scale);
        store(dv + o + cc, acc_v[i][c]);
      }
    }
  }
}

// Tile shapes per head-dim width: (BQ, BK) = (64, 64) up to d = 128; at
// d = 256 the looped-over tiles stay 64 rows and the block's own tile
// drops to 32 rows (shared memory 206 / 215 KB, accumulators 32 / 64
// registers a thread); at d = 512 the looped-over tiles are 32 rows and the
// block's own tile 16 (shared memory 194 / 197 KB, accumulators 32 / 64
// registers a thread).  One entry per (part, width): the kernel for
// element type T, its dynamic shared memory, and the rows of the block's
// own tile (grid y).
template <typename T>
cudaError_t pick_t(int part, int d, const void** fn, size_t* smem,
                   int* rows) {
#define MPI4TORCH_PICK(DMAX, OWN, LOOP)                                    \
  do {                                                                     \
    if (part == 0) {                                                       \
      *fn = (const void*)flash_bwd_dq_kernel<T, DMAX, OWN, LOOP>;          \
      *smem = dq_smem_bytes<DMAX, OWN, LOOP>();                            \
    } else {                                                               \
      *fn = (const void*)flash_bwd_dkv_kernel<T, DMAX, OWN, LOOP>;         \
      *smem = dkv_smem_bytes<DMAX, OWN, LOOP>();                           \
    }                                                                      \
    *rows = OWN;                                                           \
  } while (0)
  if (d <= 64)
    MPI4TORCH_PICK(64, 64, 64);
  else if (d <= 128)
    MPI4TORCH_PICK(128, 64, 64);
  else if (d <= 256)
    MPI4TORCH_PICK(256, 32, 64);
  else
    MPI4TORCH_PICK(512, 16, 32);
#undef MPI4TORCH_PICK
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

cudaError_t pick(int part, int is_bf16, int d, const void** fn, size_t* smem,
                 int* rows) {
  return is_bf16 ? pick_t<__nv_bfloat16>(part, d, fn, smem, rows)
                 : pick_t<float>(part, d, fn, smem, rows);
}

bool bad_shape(int b, int h, int h_kv, int sq, int sk, int d, int dh) {
  return b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || sq < 1 || sk < 1 ||
         d < 8 || d > 512 || d % 8 != 0 || dh < 1 || dh > d ||
         (long long)b * h > 0x7fffffffLL;
}

Strides unpack(const long long* p) {
  return Strides{p[0],  p[1],  p[2],  p[3],  p[4],  p[5],
                 p[6],  p[7],  p[8],  p[9],  p[10], p[11],
                 p[12], p[13], p[14], p[15], p[16], p[17]};
}

}  // namespace

// Both return a cudaError_t code (0 = launched).  `strides` holds the
// element strides (batch, seq, head) of q, k, v, do, lse and dd, in that
// order.  `is_bf16` selects the element type of q/k/v/do and of the
// gradients (0 = float32, 1 = bfloat16); lse and dd are float32.  `d` is
// the operands' head dim and `dh` <= d the true head dim, whose
// 1 / sqrt(dh) is the softmax scale.
extern "C" int mpi4torch_flash_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      void* dq, int is_bf16, int b, int h,
                                      int h_kv, int sq, int sk, int d,
                                      const long long* strides, int q_off,
                                      int kv_off, int causal, int window,
                                      int dh, void* stream) {
  if (bad_shape(b, h, h_kv, sq, sk, d, dh)) return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  int rows;
  cudaError_t e = pick(0, is_bf16, d, &fn, &smem, &rows);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (sq + rows - 1) / rows;
  if (n_q > 65535) return (int)cudaErrorInvalidValue;
  Strides st = unpack(strides);
  const float scale = 1.0f / sqrtf((float)dh);
  void* args[] = {&q,  &k,  &v,    &dout,   &lse,    &dd,     &dq,
                  &h,  &h_kv, &sq, &sk,     &d,      &st,     &q_off,
                  &kv_off, &causal, &window, (void*)&scale};
  return (int)cudaLaunchKernel(fn, dim3(b * h, n_q), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int mpi4torch_flash_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dd,
                                       void* dk, void* dv, int is_bf16, int b,
                                       int h, int h_kv, int sq, int sk, int d,
                                       const long long* strides, int q_off,
                                       int kv_off, int causal, int window,
                                       int dh, void* stream) {
  if (bad_shape(b, h, h_kv, sq, sk, d, dh)) return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  int rows;
  cudaError_t e = pick(1, is_bf16, d, &fn, &smem, &rows);
  if (e != cudaSuccess) return (int)e;
  const int n_k = (sk + rows - 1) / rows;
  if (n_k > 65535) return (int)cudaErrorInvalidValue;
  Strides st = unpack(strides);
  const float scale = 1.0f / sqrtf((float)dh);
  void* args[] = {&q,  &k,  &v,    &dout,   &lse,   &dd,     &dk,
                  &dv, &h,  &h_kv, &sq,     &sk,    &d,      &st,
                  &q_off, &kv_off, &causal, &window, (void*)&scale};
  return (int)cudaLaunchKernel(fn, dim3(b * h_kv, n_k), dim3(NT), args, smem,
                               static_cast<cudaStream_t>(stream));
}

// What the compiler and the card made of a kernel: part 0 = dq, 1 = dk/dv,
// for element type `is_bf16` at head dim d.  Writes registers per thread,
// local-memory bytes per thread (spills), static and dynamic shared memory
// per block, and the blocks that fit on one SM, to out[0..4].
extern "C" int mpi4torch_flash_bwd_props(int part, int is_bf16, int d,
                                         int* out) {
  const void* fn;
  size_t smem;
  int rows;
  cudaError_t e = pick(part, is_bf16, d, &fn, &smem, &rows);
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
