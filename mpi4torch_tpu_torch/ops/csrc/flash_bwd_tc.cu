// Block attention backward on Hopper's warpgroup tensor cores (sm_90a),
// behind a plain C interface: dq (K3) and dk/dv (K4) for bfloat16 operands
// with a head dim d that is a multiple of 8 up to 128 (the variant "tc";
// float32, and bfloat16 with d > 128, take flash_bwd.cu, the variant
// "simt").
//
// Replaces: the TPU kernels `_bwd_dq_kernel` (mpi4torch_tpu/ops/flash.py:444,
// launched at :585) and `_bwd_dkv_kernel` (:485, launched at :611).  Same
// function as flash_bwd.cu: for every unmasked (query, key) pair
//
//     p  = exp(s * scale - lse),   s  = q . k
//     ds = p * (do . v - dd)
//     dq = scale * sum_k ds k      (K3: a block per q tile or two)
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
// TFLOP/s): 0.21 and 0.28 ms.  At ViT-B/16's 196 keys (d 64) they are
// bytes-bound.  Warp-level mma.sync fed by ldmatrix reaches about a fifth
// of that rate; only warpgroup MMA (wgmma) reaches the full one.
//
// What this design does about it:
//
// * Every product runs as `wgmma.mma_async` m64nNk16 (bf16 in, f32
//   accumulators in registers), one 64-row slice per warpgroup.  The score
//   products read both operands from shared memory; the gradient products
//   take P or dS as the A operand from registers: the f32 accumulator
//   layout of a score tile is, per warp, the A-fragment layout of the next
//   product, so P and dS are rounded to bf16 and packed in place and never
//   touch shared or device memory.
//     K3, warpgroup of 64 q rows, per KV tile:  S = Q K^T, dP = dO V^T,
//       dQ += dS K (K read transposed from its row-major tile).
//     K4, warpgroup of 64 keys, per q tile:  S^T = K Q^T, dP^T = V dO^T,
//       so P^T and dS^T sit with keys as rows; dV += P^T dO, dK += dS^T Q.
//   S and dP are committed apart, so the exponentials of S run while dP is
//   still on the tensor cores; K3 leaves its dQ product in flight while
//   it issues the next tile's score products.
// * Operands are brought in by the Tensor Memory Accelerator: one thread
//   issues `cp.async.bulk.tensor` for a whole [rows x 64 columns] box of one
//   head, 128-byte swizzled (the layout wgmma's descriptors read without
//   bank conflicts), completion counted on an `mbarrier`.  TMA fills zeros
//   past the ragged sq / sk edges and past d (a d of 72 runs in two boxes
//   of 64 columns).  The block's own tile (Q/dO in K3, K/V in K4) is loaded
//   once; the looped-over tiles go through a ring of NS stages with a full
//   and an empty barrier each.
// * Warp specialisation: a block is three warpgroups.  Warp 0 is the
//   producer (K4's producer lanes also stage each q tile's lse and dd rows,
//   read a tile ahead, beside its TMA boxes); the two others are consumers
//   of 64 rows each, sharing every loaded tile.  `setmaxnreg` moves
//   registers from the producer warpgroup (40 a thread) to the consumers
//   (232): each holds one or two 64 x DMAX f32 gradient accumulators and
//   two score tiles.  Descriptors are formed where they are used (64 bits
//   each, hoisted out of the loop they spilled K4).
// * Tiles: K3 128 q rows against KV tiles of 64 keys, K4 128 keys against
//   q tiles of 64 rows (wider tiles serialise the wgmmas for want of
//   registers); 3 or 4 stages.  One block of 384
//   threads fills an SM's registers, so a block's fixed cost (its first
//   loads, its last product and its stores) is not hidden by another
//   block: K3 takes two q tiles a block and loads the second's Q/dO into a
//   second buffer while it works on the first.
// * Causal and window tile cuts as in flash_bwd.cu, per block and again per
//   warpgroup (a warpgroup whose 64 rows see none of a tile skips its
//   products and only releases the stage).  Only tiles that straddle the
//   diagonal, the window edge or a ragged edge are masked per element, as
//   one compare of each column against a per-row range.
// * Blocks run in chunks of heads (`block_order`), within a chunk the
//   heaviest tiles first: the blocks in flight share few heads, so the
//   tiles they share stay in L2 (at the training shape a wave over 132
//   heads would stream 134 MB of K/V from device memory for every q tile),
//   and the heavy blocks of the last heads do not end alone.
// * Nothing is atomic.  K3 sums each q tile's dQ in one block, K4 each KV
//   tile's dK/dV in one block that walks its group's q heads in a fixed
//   order, so the same inputs give the same bits.
//
// Layout: q and do (b, sq, h, d); k and v (b, sk, h_kv, d); lse and dd
// (b, sq, h) f32.  The last dimension of q/k/v/do is contiguous and every
// (batch, seq, head) row starts on a 16-byte boundary with strides that
// are multiples of 16 bytes (the wrapper guarantees it; TMA needs it);
// strides are passed in elements.  dq is written contiguous (b, sq, h, d),
// dk and dv contiguous (b, sk, h_kv, d), bf16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 384;       // threads per block: producer + 2 consumers
constexpr int ROWS = 64;      // rows of one consumer warpgroup's slice
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 232;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles: K3 takes 128 q rows (two consumer slices) against KV tiles of 64
// keys, K4 128 keys against q tiles of 64 rows, at either padded head dim;
// NS stages in each ring.
constexpr int DQ_BQ = 2 * ROWS, DQ_BK = 64, DQ_NS = 3;
constexpr int DKV_BK = 2 * ROWS, DKV_BQ = 64, DKV_NS = 4;

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

// Every pair of q rows [q_lo, q_hi] x keys [k_lo, k_hi] (positions) is
// unmasked: the tile needs no per-element mask.
__device__ __forceinline__ bool tile_interior(int q_lo, int q_hi, int k_lo,
                                              int k_hi, int causal,
                                              int window) {
  if (!causal) return true;
  return q_lo >= k_hi && (window <= 0 || q_hi - k_lo < window);
}

// No pair of q rows [q_lo, q_hi] x keys [k_lo, k_hi] is unmasked.
__device__ __forceinline__ bool tile_dead(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int causal, int window) {
  return causal && (q_hi < k_lo || (window > 0 && q_lo - k_hi >= window));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the SFU (`ex2.approx`, relative error below 2^-22), as K2 takes
// it: the library's exp2f wraps the same instruction in a slower path for
// accuracy that p and ds, rounded to bf16, have no use for.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The (head, tile) of work item `blk` of `heads` heads (batch x head) of
// `tiles` tiles each, items taken in order.  Heads go in chunks of
// `chunk`, and within a chunk tile by tile (tile 0 first: the kernels
// number their tiles heaviest first), so that the items in flight share few
// heads while the heavy tiles of every head still come early (a head run
// whole, heavy to light, leaves the last head's heaviest block running
// alone at the end).
__device__ __forceinline__ void block_order(int blk, int heads, int tiles,
                                            int chunk, int* head,
                                            int* tile) {
  const int per = chunk * tiles;
  const int c = blk / per, r = blk % per;
  const int n = min(chunk, heads - c * chunk);  // heads in this chunk
  *tile = r / n;
  *head = c * chunk + r % n;
}

// ---- mbarrier and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory at `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// A shared-memory matrix descriptor for a 128-byte swizzled tile (atoms of
// 8 rows x 128 bytes, 1024-byte aligned).  K-major operands (the
// contracted dimension along the 128-byte rows): `addr` steps 32 bytes
// per 16-element k step inside an atom, `sbo` 1024 to the next 8 rows.
// MN-major operands (contracted along the rows): `sbo` 1024 to the next 8
// rows of the contracted dimension, `lbo` to the next 64 columns.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The k-step `ks` (16 columns) of a K-major tile of `rows` rows whose 64
// column blocks lie `rows` x 128 bytes apart, from row `row`.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row,
                                           int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * 128 + row * 128 + (ks & 3) * 32,
                    16);
}

// The k-step `ks` (16 rows) of an MN-major tile of `rows` rows.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int ks) {
  return sw128_desc(tile + ks * 16 * 128, rows * 128);
}

// `x`, opaque to the compiler: what is derived from it (wgmma descriptors,
// 64 bits each) is formed where it is used and not hoisted out of a loop,
// where it would hold registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of `r` across this point
// (accumulators in flight in an asynchronous wgmma).
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_D8(i)                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)

// d (64 x 64) = [d +] A B^T: A 64 x 16 and B 64 x 16 both K-major in
// shared memory; `acc` 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N) = [d +] A B: A 64 x 16 bf16 fragments in registers, B 16 x N
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n"
      "}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WG_D64
#undef WG_D32
#undef WG_D8

// Write one warpgroup's 64 x DMAX f32 accumulator times `mul` as bf16:
// this thread's rows r_lo and r_lo + 8 (those below n) of a contiguous
// (., n, heads, d) output at `base` (row 0 of this batch and head; row
// stride `rs`).
template <int R>
__device__ __forceinline__ void store_rows(bf16* base, long long rs,
                                           const float (&acc)[R], float mul,
                                           int r_lo, int n, int d,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (col >= d) continue;
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(base + r_lo * rs + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (r_lo + 8) * rs + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// Shared memory of K3 at head dim DMAX: byte offsets from a 1024-byte
// aligned base.  Every tile is DMAX / 64 blocks of [rows][64] bf16.  Q and
// dO are double-buffered: a block's next q tile arrives while it works on
// the current one.
template <int DMAX>
struct DqSmem {
  static constexpr int NS = DQ_NS;
  static constexpr int QB = DQ_BQ * DMAX * 2, KB = DQ_BK * DMAX * 2;
  static constexpr int Q = 0;  // [2] x {Q tile, dO tile}
  static constexpr int K = 4 * QB, V = K + NS * KB;
  // q_full[2], q_empty[2], then the ring's full[NS], empty[NS]
  static constexpr int BAR = V + NS * KB;
  static constexpr int BYTES = BAR + 8 * (4 + 2 * NS) + 1024;
};

template <int DMAX>
struct DkvSmem {
  static constexpr int NS = DKV_NS, BQ = DKV_BQ;
  static constexpr int KB = DKV_BK * DMAX * 2, QB = BQ * DMAX * 2;
  static constexpr int K = 0, V = KB, Q = 2 * KB, DO = Q + NS * QB;
  static constexpr int LSE = DO + NS * QB, DD = LSE + 4 * NS * BQ;
  static constexpr int BAR = DD + 4 * NS * BQ;  // k/v, full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;
};

// K3: one block per `per_block` consecutive (128-row q tile, batch x q
// head) items of block_order.  Warpgroup 0's first thread loads each
// item's Q and dO once, into the buffer the item before last used, and
// streams its K/V tiles through the ring; warpgroups 1 and 2 own q rows
// 0..63 and 64..127 of the tile.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ dd, bf16* __restrict__ dq,
                       int h, int h_kv, int sq, int sk, int d, Strides st,
                       int q_off, int kv_off, int causal, int window,
                       float scale, int heads, int chunk, int per_block) {
  using L = DqSmem<DMAX>;
  constexpr int BQ = DQ_BQ, BK = DQ_BK, NS = DQ_NS, NB = DMAX / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto q_full = [&](int qb) { return base + L::BAR + 8 * qb; };
  auto q_empty = [&](int qb) { return base + L::BAR + 8 * (2 + qb); };
  auto full = [&](int s) { return base + L::BAR + 8 * (4 + s); };
  auto empty = [&](int s) { return base + L::BAR + 8 * (4 + NS + s); };

  const int n_q = (sq + BQ - 1) / BQ;
  const int first = blockIdx.x * per_block;
  const int n_items = min(per_block, heads * n_q - first);
  const int n_tiles = (sk + BK - 1) / BK;
  // Item m of this block: batch, q head, KV head, first q row, and its live
  // KV tiles [j_begin, j_end).  Under a causal mask the last q tiles walk
  // the most KV tiles: they come first.
  struct Item {
    int b, hh, hk, row0, j_begin, j_end;
  };
  auto item = [&](int m) {
    Item it;
    int bh, tile;
    block_order(first + m, heads, n_q, chunk, &bh, &tile);
    it.b = bh / h;
    it.hh = bh % h;
    it.hk = it.hh / (h / h_kv);
    it.row0 = (causal ? n_q - 1 - tile : tile) * BQ;
    it.j_begin = 0;
    it.j_end = n_tiles;
    if (causal) {
      const int q_hi = q_off + min(sq, it.row0 + BQ) - 1;
      it.j_end = clampi(floordiv(q_hi - kv_off, BK) + 1, 0, n_tiles);
      if (window > 0)
        it.j_begin = clampi(
            floordiv(q_off + it.row0 - window + 1 - kv_off, BK), 0, n_tiles);
    }
    return it;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.  `ring` counts K/V tiles over the block's items, `nq` its
    // items with live tiles.
    setmaxnreg_dec<REG_PRODUCER>();
    if (threadIdx.x == 0) {
      int ring = 0, nq = 0;
      for (int m = 0; m < n_items; ++m) {
        const Item it = item(m);
        if (it.j_begin >= it.j_end) continue;
        const int qb = nq & 1;
        mbar_wait(q_empty(qb), ((nq >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), 2 * L::QB);
        const uint32_t qt = base + L::Q + qb * 2 * L::QB;
        for (int c = 0; c < NB; ++c) {
          tma_load(qt + c * BQ * 128, &tq, q_full(qb), 64 * c, it.hh, it.row0,
                   it.b);
          tma_load(qt + L::QB + c * BQ * 128, &tdo, q_full(qb), 64 * c, it.hh,
                   it.row0, it.b);
        }
        ++nq;
        for (int j = it.j_begin; j < it.j_end; ++j, ++ring) {
          const int s = ring % NS;
          mbar_wait(empty(s), ((ring / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::KB);
          for (int c = 0; c < NB; ++c) {
            tma_load(base + L::K + s * L::KB + c * BK * 128, &tk, full(s),
                     64 * c, it.hk, j * BK, it.b);
            tma_load(base + L::V + s * L::KB + c * BK * 128, &tv, full(s),
                     64 * c, it.hk, j * BK, it.b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup w owns q rows 64 w .. 64 w + 63 of each tile.
    setmaxnreg_inc<REG_CONSUMER>();
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const float sl2 = scale * LOG2E;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // lse (times log2 e) and dd of this thread's two q rows of an item
    // (accumulator rows g and g + 8 of its warp), read an item ahead.
    auto stats = [&](const Item& it, float (&l)[2], float (&e)[2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = it.row0 + ROWS * w + warp * 16 + (lane >> 2) + 8 * i;
        const bool ok = row < sq;
        l[i] = ok ? lse[it.b * st.l_b + row * st.l_s + it.hh * st.l_h] * LOG2E
                  : 0.f;
        e[i] = ok ? dd[it.b * st.d_b + row * st.d_s + it.hh * st.d_h] : 0.f;
      }
    };
    float lse2[2], ddv[2], next_lse2[2], next_ddv[2];
    stats(item(0), lse2, ddv);
    int ring = 0, nq = 0;
    for (int m = 0; m < n_items; ++m) {
      const Item it = item(m);
      const int wrow0 = it.row0 + ROWS * w;
      const int r_lo = wrow0 + warp * 16 + (lane >> 2);
      const int wq_lo = q_off + wrow0, wq_hi = wq_lo + ROWS - 1;
      const bool full_rows = wrow0 + ROWS <= sq;

      float acc[DMAX / 2];
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
      if (it.j_begin < it.j_end) {
        const int qb = nq & 1;
        mbar_wait(q_full(qb), (nq >> 1) & 1);
        const uint32_t qa = base + L::Q + qb * 2 * L::QB, da = qa + L::QB;
        // The dQ product of a KV tile stays in flight while the next
        // tile's score products are issued; its stage is released when
        // both are done.
        int held = -1;  // the stage the dQ product in flight reads
        uint32_t ds_a[BK / 16][4];
        for (int j = it.j_begin; j < it.j_end; ++j, ++ring) {
          const int s = ring % NS;
          mbar_wait(full(s), (ring / NS) & 1);
          const uint32_t kt = base + L::K + s * L::KB;
          const uint32_t vt = base + L::V + s * L::KB;
          const int c0 = j * BK;
          const int k_lo = kv_off + c0, k_hi = k_lo + BK - 1;
          if (tile_dead(wq_lo, wq_hi, k_lo, k_hi, causal, window)) {
            wg_wait<0>();
            reg_fence(acc);
            if (held >= 0) release(empty(held));
            held = -1;
            release(empty(s));
            continue;
          }
          const uint32_t qw = opaque(qa), dw = opaque(da);
          float sc[BK / 2], dp[BK / 2];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < DMAX / 16; ++ks)
            wgmma_ss(sc, kmajor(qw, BQ, ROWS * w, ks), kmajor(kt, BK, 0, ks),
                     ks);
          wg_commit();
#pragma unroll
          for (int ks = 0; ks < DMAX / 16; ++ks)
            wgmma_ss(dp, kmajor(dw, BQ, ROWS * w, ks), kmajor(vt, BK, 0, ks),
                     ks);
          wg_commit();
          // S (and the dQ product before it) done; dP may still run while
          // the exponentials are taken.
          wg_wait<1>();
          reg_fence(sc);
          reg_fence(acc);
          if (held >= 0) release(empty(held));

          const bool interior = full_rows && c0 + BK <= sk &&
                                tile_interior(wq_lo, wq_hi, k_lo, k_hi,
                                              causal, window);
          // Off the interior, each of this thread's rows keeps the columns
          // [lo, hi] of its own (offsets from its first column, c0 + 2 *
          // (lane % 4)): below sk, at or before the row's position, within
          // the window, and none on a row at or past sq.
          int lo[2] = {0, 0}, hi[2] = {BK, BK};
          if (!interior) {
            const int cb = c0 + 2 * (lane & 3);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = r_lo + 8 * r;
              const int diag = q_off + row - kv_off - cb;
              hi[r] = row < sq ? min(sk - 1 - cb, causal ? diag : BK) : -1;
              lo[r] = causal && window > 0 ? diag - window + 1 : 0;
            }
          }
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i & 3) >> 1, col = (i >> 2) * 8 + (i & 1);
            const float p = ex2(fmaf(sc[i], sl2, -lse2[r]));
            sc[i] = col >= lo[r] && col <= hi[r] ? p : 0.f;
          }
          wg_wait<0>();
          reg_fence(dp);
          // ds = p (dp - dd), rounded to bf16 and packed as the A
          // fragments of dQ += dS K.
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int i = 8 * ks + 2 * jj, r = jj & 1;
              ds_a[ks][jj] = pack_bf16(sc[i] * (dp[i] - ddv[r]),
                                       sc[i + 1] * (dp[i + 1] - ddv[r]));
            }
          reg_fence(ds_a);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
            wgmma_rs(acc, ds_a[ks], mnmajor(kt, BK, ks), 1);
          wg_commit();
          held = s;
        }
        if (m + 1 < n_items) stats(item(m + 1), next_lse2, next_ddv);
        wg_wait<0>();
        reg_fence(acc);
        if (held >= 0) release(empty(held));
        release(q_empty(qb));
        ++nq;
      } else if (m + 1 < n_items) {
        stats(item(m + 1), next_lse2, next_ddv);
      }
      store_rows(dq + ((long long)it.b * sq * h + it.hh) * d,
                 (long long)h * d, acc, scale, r_lo, sq, d, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse2[i] = next_lse2[i];
        ddv[i] = next_ddv[i];
      }
    }
  }
}

// K4: one block per (128-key KV tile, batch x KV head).  Warp 0 loads the
// block's K/V once and streams, for each q head of the KV head's group
// and each live q tile, Q/dO boxes and their lse/dd rows through the ring;
// warpgroups 1 and 2 own keys 0..63 and 64..127 of the tile.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int h, int h_kv, int sq,
                        int sk, int d, Strides st, int q_off, int kv_off,
                        int causal, int window, float scale, int chunk) {
  using L = DkvSmem<DMAX>;
  constexpr int BK = DKV_BK, BQ = DKV_BQ, NS = DKV_NS, NB = DMAX / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* lse_s = reinterpret_cast<float*>(gbase + L::LSE);  // [NS][BQ]
  float* dd_s = reinterpret_cast<float*>(gbase + L::DD);    // [NS][BQ]
  const uint32_t bar_kv = base + L::BAR;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + NS + s); };

  // Under a causal mask the first KV tiles walk the most q tiles: they
  // come first.
  const int n_k = (sk + BK - 1) / BK;
  int bh, tile;
  block_order(blockIdx.x, gridDim.x / n_k, n_k, chunk, &bh, &tile);
  const int b = bh / h_kv;
  const int hk = bh % h_kv;
  const int g = h / h_kv;
  const int col0 = tile * BK;

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

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: warp 0.  Iteration t is q head hk g + t / n_live, q tile
    // i_begin + t % n_live.
    setmaxnreg_dec<REG_PRODUCER>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && n_iter > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KB);
        for (int c = 0; c < NB; ++c) {
          tma_load(base + L::K + c * BK * 128, &tk, bar_kv, 64 * c, hk, col0,
                   b);
          tma_load(base + L::V + c * BK * 128, &tv, bar_kv, 64 * c, hk, col0,
                   b);
        }
      }
      // Each lane's lse and dd rows of iteration t are read one iteration
      // ahead, so that their latency overlaps the wait for a free stage.
      constexpr int PER = BQ / 32;
      float lv[PER], ev[PER];
      auto fetch = [&](int t) {
        const int hh = hk * g + t / n_live;
        const int r0 = (i_begin + t % n_live) * BQ;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int row = r0 + lane + 32 * i;
          const bool ok = row < sq;
          lv[i] = ok ? lse[b * st.l_b + row * st.l_s + hh * st.l_h] * LOG2E
                     : 0.f;
          ev[i] = ok ? dd[b * st.d_b + row * st.d_s + hh * st.d_h] : 0.f;
        }
      };
      fetch(0);
      for (int t = 0; t < n_iter; ++t) {
        const int s = t % NS;
        const int hh = hk * g + t / n_live;
        const int r0 = (i_begin + t % n_live) * BQ;
        mbar_wait(empty(s), ((t / NS) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          lse_s[s * BQ + lane + 32 * i] = lv[i];
          dd_s[s * BQ + lane + 32 * i] = ev[i];
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * L::QB);
          for (int c = 0; c < NB; ++c) {
            tma_load(base + L::Q + s * L::QB + c * BQ * 128, &tq, full(s),
                     64 * c, hh, r0, b);
            tma_load(base + L::DO + s * L::QB + c * BQ * 128, &tdo, full(s),
                     64 * c, hh, r0, b);
          }
        } else {
          mbar_arrive(full(s));
        }
        if (t + 1 < n_iter) fetch(t + 1);
      }
    }
  } else {
    // Consumers: warpgroup w owns keys 64 w .. 64 w + 63 of the tile.
    setmaxnreg_inc<REG_CONSUMER>();
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int wcol0 = col0 + ROWS * w;
    // This thread's two keys (accumulator rows g and g + 8 of its warp).
    const int k_lo = wcol0 + warp * 16 + (lane >> 2);
    const float sl2 = scale * LOG2E;
    const int wk_lo = kv_off + wcol0, wk_hi = wk_lo + ROWS - 1;
    const bool full_keys = wcol0 + ROWS <= sk;
    const uint32_t ka = base + L::K, va = base + L::V;

    float acc_k[DMAX / 2], acc_v[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    if (n_iter > 0) mbar_wait(bar_kv, 0);

    for (int t = 0; t < n_iter; ++t) {
      const int s = t % NS;
      mbar_wait(full(s), (t / NS) & 1);
      const int r0 = (i_begin + t % n_live) * BQ;
      const int q_lo = q_off + r0, q_hi = q_lo + BQ - 1;
      if (!tile_dead(q_lo, q_hi, wk_lo, wk_hi, causal, window)) {
        const uint32_t qt = base + L::Q + s * L::QB;
        const uint32_t dt = base + L::DO + s * L::QB;
        const float* lt = lse_s + s * BQ;
        const float* et = dd_s + s * BQ;
        const uint32_t kw = opaque(ka), vw = opaque(va);
        float sc[BQ / 2], dp[BQ / 2];  // S^T and dP^T: key rows, q columns
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks)
          wgmma_ss(sc, kmajor(kw, BK, ROWS * w, ks), kmajor(qt, BQ, 0, ks),
                   ks);
        wg_commit();
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks)
          wgmma_ss(dp, kmajor(vw, BK, ROWS * w, ks), kmajor(dt, BQ, 0, ks),
                   ks);
        wg_commit();
        // S^T done; dP^T may still run while the exponentials are taken.
        wg_wait<1>();
        reg_fence(sc);

        const bool interior = full_keys && r0 + BQ <= sq &&
                              tile_interior(q_lo, q_hi, wk_lo, wk_hi, causal,
                                            window);
        // Off the interior, each of this thread's keys keeps the q columns
        // [lo, hi] of its own (offsets from its first column, r0 + 2 *
        // (lane % 4)): below sq, at or after the key's position, within
        // the window, and none for a key at or past sk.
        int lo[2] = {0, 0}, hi[2] = {BQ, BQ};
        if (!interior) {
          const int qb = r0 + 2 * (lane & 3);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = k_lo + 8 * r;
            const int diag = kv_off + key - q_off - qb;
            lo[r] = causal ? diag : 0;
            hi[r] = key < sk ? min(sq - 1 - qb, causal && window > 0
                                                    ? diag + window - 1
                                                    : BQ)
                             : -1;
          }
        }
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + jj * 8 + 2 * (lane & 3));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e, r = e >> 1, col = jj * 8 + (e & 1);
            const float p = ex2(fmaf(sc[i], sl2, -((e & 1) ? l2.y : l2.x)));
            sc[i] = col >= lo[r] && col <= hi[r] ? p : 0.f;
          }
        }
        wg_wait<0>();
        reg_fence(dp);
        // p^T and ds^T = p^T (dp^T - dd), rounded to bf16 and packed as
        // the A fragments of dV += P^T dO and dK += dS^T Q.
        uint32_t p_a[BQ / 16][4], ds_a[BQ / 16][4];
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * ks + 2 * j;
            const float2 e2 = *reinterpret_cast<const float2*>(
                et + (i >> 2) * 8 + 2 * (lane & 3));
            p_a[ks][j] = pack_bf16(sc[i], sc[i + 1]);
            ds_a[ks][j] = pack_bf16(sc[i] * (dp[i] - e2.x),
                                    sc[i + 1] * (dp[i + 1] - e2.y));
          }
        reg_fence(p_a);
        reg_fence(ds_a);
        reg_fence(acc_v);
        reg_fence(acc_k);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks)
          wgmma_rs(acc_v, p_a[ks], mnmajor(dt, BQ, ks), 1);
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks)
          wgmma_rs(acc_k, ds_a[ks], mnmajor(qt, BQ, ks), 1);
        wg_commit();
        wg_wait<0>();
        reg_fence(acc_v);
        reg_fence(acc_k);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this stage is refilled
    }

    const long long o = ((long long)b * sk * h_kv + hk) * d;
    const long long rs = (long long)h_kv * d;
    store_rows(dk + o, rs, acc_k, scale, k_lo, sk, d, lane);
    store_rows(dv + o, rs, acc_v, 1.f, k_lo, sk, d, lane);
  }
}

// The kernel of `part` (0 = dq, 1 = dk/dv) for head dim d and its dynamic
// shared memory; sets the attribute that allows that much.
cudaError_t pick(int part, int d, const void** fn, size_t* smem) {
  if (part == 0) {
    *fn = d <= 64 ? (const void*)flash_bwd_dq_tc_kernel<64>
                  : (const void*)flash_bwd_dq_tc_kernel<128>;
    *smem = d <= 64 ? DqSmem<64>::BYTES : DqSmem<128>::BYTES;
  } else {
    *fn = d <= 64 ? (const void*)flash_bwd_dkv_tc_kernel<64>
                  : (const void*)flash_bwd_dkv_tc_kernel<128>;
    *smem = d <= 64 ? DkvSmem<64>::BYTES : DkvSmem<128>::BYTES;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's
// entry-point query (the library does not link libcuda); null where the
// installed CUDA has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map over one (batch, seq, head, d) bf16 operand with element
// strides (sb, ss, sh): boxes of `rows` rows x 64 columns of one head,
// 128-byte swizzled, zero past every edge.  A dimension of size 1 is never
// stepped, so its stride is set as if the operand were packed.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int b, int s,
                     int heads, int d, long long sb, long long ss,
                     long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const long long given[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  long long span = d;
  for (int i = 0; i < 3; ++i) {
    const long long el = dims[i + 1] > 1 ? given[i] : span;
    strides[i] = (cuuint64_t)el * sizeof(bf16);
    span = el * (long long)dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SMs of the current device.
int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Heads per chunk of block_order for `heads` heads of `tiles` tiles, run
// `per_block` tiles to a block: about two blocks for every SM, the chunks
// of one size as near as can be (a last chunk of a head or two would end
// alone).
int head_chunk(int heads, int tiles, int per_block) {
  const int want = (2 * device_sms() * per_block + tiles - 1) / tiles;
  const int n = (heads + want - 1) / want;  // chunks
  return (heads + n - 1) / n;
}

// Items (q tiles of K3, KV tiles of K4) per block: two, so that a block
// loads its second item's own tile while it works on the first and the
// fixed cost of a block (its first loads, its last product and stores) is
// paid once for both, where that leaves at least two blocks for every SM;
// else one.
int items_per_block(long long items) {
  return items >= 4LL * device_sms() ? 2 : 1;
}

// The four operand maps: q and do in `q_rows`-row boxes, k and v in
// `k_rows`-row boxes.
cudaError_t operand_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                         const void* v, const void* dout, int b, int h,
                         int h_kv, int sq, int sk, int d, const Strides& st,
                         int q_rows, int k_rows) {
  cudaError_t e;
  if ((e = tile_map(&m[0], q, b, sq, h, d, st.q_b, st.q_s, st.q_h,
                    q_rows)) != cudaSuccess ||
      (e = tile_map(&m[1], k, b, sk, h_kv, d, st.k_b, st.k_s, st.k_h,
                    k_rows)) != cudaSuccess ||
      (e = tile_map(&m[2], v, b, sk, h_kv, d, st.v_b, st.v_s, st.v_h,
                    k_rows)) != cudaSuccess ||
      (e = tile_map(&m[3], dout, b, sq, h, d, st.o_b, st.o_s, st.o_h,
                    q_rows)) != cudaSuccess)
    return e;
  return cudaSuccess;
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
  const long long items = (long long)b * h * n_q;
  if (bad_shape(b, h, h_kv, sq, sk, d) || dh < 1 || dh > d ||
      items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  cudaError_t e = pick(0, d, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  Strides st = unpack(strides);
  CUtensorMap maps[4];
  e = operand_maps(maps, q, k, v, dout, b, h, h_kv, sq, sk, d, st, DQ_BQ,
                   DQ_BK);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)dh);
  int heads = b * h, per_block = items_per_block(items);
  int chunk = head_chunk(heads, n_q, per_block);
  const long long blocks = (items + per_block - 1) / per_block;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &lse,
                  &dd,      &dq,      &h,       &h_kv,    &sq,
                  &sk,      &d,       &st,      &q_off,   &kv_off,
                  &causal,  &window,  (void*)&scale, &heads, &chunk, &per_block};
  return (int)cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(NT), args,
                               smem, static_cast<cudaStream_t>(stream));
}

extern "C" int mpi4torch_flash_bwd_tc_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dd,
                                          void* dk, void* dv, int b, int h,
                                          int h_kv, int sq, int sk, int d,
                                          const long long* strides,
                                          int q_off, int kv_off, int causal,
                                          int window, int dh, void* stream) {
  const long long blocks =
      (long long)b * h_kv * ((sk + DKV_BK - 1) / DKV_BK);
  if (bad_shape(b, h, h_kv, sq, sk, d) || dh < 1 || dh > d ||
      blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  cudaError_t e = pick(1, d, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  Strides st = unpack(strides);
  CUtensorMap maps[4];
  e = operand_maps(maps, q, k, v, dout, b, h, h_kv, sq, sk, d, st, DKV_BQ,
                   DKV_BK);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)dh);
  int chunk = head_chunk(b * h_kv, (sk + DKV_BK - 1) / DKV_BK, 1);
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &lse,
                  &dd,      &dk,      &dv,      &h,       &h_kv,
                  &sq,      &sk,      &d,       &st,      &q_off,
                  &kv_off,  &causal,  &window,  (void*)&scale, &chunk};
  return (int)cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(NT), args,
                               smem, static_cast<cudaStream_t>(stream));
}

// What the compiler and the card made of a kernel: part 0 = dq, 1 = dk/dv,
// at head dim d.  Writes registers per thread (as launched, before
// setmaxnreg moves them to the consumers), local-memory bytes per thread
// (spills), static and dynamic shared memory per block, and the blocks
// that fit on one SM, to out[0..4].
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
