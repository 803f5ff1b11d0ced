// Encoder segmented attention (K1) and decoder causal prefill attention (K2)
// on Hopper's tensor cores.
//
// K1 replaces the Pallas kernel surya_tpu/ops/flash.py::segmented_block_attention
// (`_kernel`); K2 replaces surya_tpu/ops/flash.py::causal_flash_attention
// (`_causal_kernel`).
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense) is bytes.
// K1 at the whole-page shape (S = 32768 slots, 16 heads, D = 80) must move
// 336 MB (q, k, v read once, out written once: 0.100 ms) for the 29.5 GFLOP
// of the plan's query-key pairs (0.030 ms). K2 at 128 rows x 128 (12/4 heads,
// D = 128) moves 134 MB (0.040 ms) for 6.5 GFLOP (0.007 ms). So both stream
// q/k/v from device memory with the arithmetic hidden under the copies.
//
// Common to both: online softmax in fp32 per row (exp2 with log2(e) folded
// into the scale) with the finite NEG_INF sentinel of the Pallas kernels: a
// masked key has logit NEG_INF, so a row that has seen no valid key yet
// weighs it 1 and the first valid key scales that away exactly
// (exp2(NEG_INF - m) == 0), as in `_kernel`. P (the exponentiated logits)
// never leaves registers: the accumulator layout of Q K^T over two
// neighbouring key octets is the A-operand layout of P V. P goes in as two
// bf16 terms (its rounded value and the rounding error, split_bf16x2): P
// rounded once to bf16 moves the output by up to 2^-9 of its size, which
// with the output's own rounding can leave one bf16 spacing. Where the
// Pallas grid carried (m, l, acc) in VMEM scratch from one KV block to the
// next, that state lives in registers inside the CTA's own loop over KV
// tiles.
//
// K1 runs on the warp-level path: mma.sync.m16n8k16 with operands from
// shared memory by ldmatrix, each warp its own 16 query rows. That takes
// D = 80, a 160-byte row that no wgmma swizzle fits, and keeps each warp on
// its own span of keys. K/V tiles stream through a ring of STAGES tiles by
// cp.async (16 bytes a lane), the Q tile the same way; shared rows are
// padded by 16 bytes (176 bytes for D = 80, an odd number of 16-byte
// units), so the 8 row addresses of an ldmatrix hit 8 different bank groups.
// The output is staged through the warp's own Q rows and leaves as
// coalesced 16-byte stores.
//
// K2 runs on Hopper's own instructions:
// - Work items of (batch row, kv head, run of row blocks): a CTA serves the
//   kv head's 3 query heads from each K/V tile it loads, so a kv head's K
//   and V come from device memory once for all 3.
// - TMA: the producer's first lane issues every copy, 64 x 64 boxes of
//   4-D tensor maps over [B, L, heads, D] (made on the host at each call,
//   kernel parameters, so a CUDA graph keeps them), with 128-byte swizzle,
//   into a ring of K/V stages and per-head Q buffers that signal mbarriers.
//   Rows past L read as zeros and stores past L are dropped, so no lane
//   spends an instruction on an address or a bound.
// - wgmma on m64 tiles. S = Q K^T with both operands K-major from shared
//   memory (a 256-byte row is two 128-byte swizzled halves, k16 slice kk at
//   byte 32 (kk % 4) of half kk / 4); P V with P from registers and V
//   MN-major from shared memory (the descriptor transposes), one m64n128
//   product over both halves of D.
// - A consumer warpgroup per query head and a producer warpgroup, which
//   gives its registers to the consumers by setmaxnreg; one CTA an SM
//   (224 KB). At the main path's 128 x 128 prefill it is persistent: one
//   CTA an SM walks (batch row, kv head) items in turn, the producer
//   loading the next item's tiles into the other half of the ring while
//   the consumers compute and store the current one.
// - The output is written over the row block's Q tile in the swizzled
//   layout and leaves by TMA store.

#include "common.cuh"
#include "hopper.cuh"

using namespace surya;

namespace {

constexpr int STAGES = 2;         // depth of the K/V ring
constexpr int WARP_ROWS = 16;     // query rows of one warp: the m16 of mma.sync
constexpr int SEG_QT = 64;        // K1: query rows per CTA (4 warps)
constexpr int PLAN_CHUNK = 128;   // K1: query rows per kv_starts entry (FULL_ATTN_Q_CHUNK)
constexpr int SEG_BK = 64;        // K1: keys per shared-memory tile
constexpr int SEG_MIN_CTAS = 4;   // K1: CTAs an SM must hold (caps registers at 128)

__device__ __forceinline__ float inf_f() { return __uint_as_float(0x7f800000u); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// One warp's 16 query rows: where their Q tile sits in shared memory (row
// stride D + PAD; read by ldmatrix as mma A fragments at every KV tile, which
// leaves the registers to the accumulators), the fp32 output accumulator (one
// m16n8 fragment per 8 dims) and, for the lane's two rows (lane/4 and
// lane/4 + 8), the running max in the log2 domain and the lane's part of the
// running sum (its quad holds the rest).
template <int D>
struct WarpRows {
  const bf16* q_s;
  float o[D / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ explicit WarpRows(const bf16* rows) : q_s(rows) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }
};

// Online-softmax update of a warp's rows with one BK-key tile (k_s, v_s: row
// stride D + PAD). When MASKED, key(i, c) says what key c of the tile is to
// row lane/4 + 8i of the warp: 1 valid, 0 masked (logit NEG_INF, as in the
// Pallas kernels), -1 outside the keys the call attends (weight 0 always).
template <int D, int BK, bool MASKED, class KeyFn>
__device__ __forceinline__ void attend_tile(WarpRows<D>& w, const bf16* k_s, const bf16* v_s,
                                            float scale_log2, int lane, KeyFn key) {
  constexpr int SROW = D + PAD;
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // S = Q K^T: K's rows are the columns of the mma B operand, so ldmatrix
  // reads them as stored; one x4 load serves two key octets
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, w.q_s + (lane & 15) * SROW + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jn = 0; jn < BK / 16; ++jn) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (jn * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * SROW + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_16816(s[2 * jn], a, b[0], b[1]);
      mma_16816(s[2 * jn + 1], a, b[2], b[3]);
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        const int kind = key(e >> 1, j * 8 + 2 * t + (e & 1));
        s[j][e] = kind > 0 ? s[j][e] * scale_log2 : (kind == 0 ? NEG_INF : -inf_f());
      } else {
        s[j][e] *= scale_log2;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = w.m[i];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = exp2f(w.m[i] - mx);
    w.m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][2 * i] = exp2f(s[j][2 * i] - mx);
      s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - mx);
      sum += s[j][2 * i] + s[j][2 * i + 1];
    }
    w.l[i] = w.l[i] * corr + sum;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      w.o[dn][2 * i] *= corr;
      w.o[dn][2 * i + 1] *= corr;
    }
  }
  // O += P V: the fragments of key octets 2kk and 2kk+1 form the A operand of
  // k-step kk; V's rows are the k of the B operand, so ldmatrix transposes.
  // P goes in as two bf16 terms (see split_bf16x2): P rounded to bf16 alone
  // moves the output by up to 2^-9 of its size, which with the rounding of
  // the output itself can leave one bf16 spacing. The price is a second mma
  // for each step of P V.
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + dn * 16 +
                               ((lane >> 4) & 1) * 8);
      mma_16816(w.o[2 * dn], hi, b[0], b[1]);
      mma_16816(w.o[2 * dn], lo, b[0], b[1]);
      mma_16816(w.o[2 * dn + 1], hi, b[2], b[3]);
      mma_16816(w.o[2 * dn + 1], lo, b[2], b[3]);
    }
  }
}

// Normalise the warp's rows and write the first n_rows of them to dst (row r
// at dst + r * row_stride), staged through the warp's 16 shared rows `stage`.
template <int D>
__device__ __forceinline__ void store_rows(const WarpRows<D>& w, bf16* stage, bf16* dst,
                                           int64_t row_stride, int n_rows, int lane) {
  constexpr int SROW = D + PAD, CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = w.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * SROW + dn * 8 + 2 * t) =
          pack_bf16x2(w.o[dn][2 * i] * inv, w.o[dn][2 * i + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < WARP_ROWS * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    if (r < n_rows)
      reinterpret_cast<uint4*>(dst + r * row_stride)[ch] =
          *reinterpret_cast<const uint4*>(stage + r * SROW + ch * 8);
  }
}

// The keys [lo, hi) that query rows [r0, r0 + 16) can attend: from the
// start of the group run holding r0 to the end of the run holding r0 + 15,
// clipped to the window [kv0, kv1); the whole window where the rows do not
// lie inside it. This holds every key of the rows' groups only because each
// group is one contiguous run of slots (plan_layout refuses a plan where it
// is not). tests/test_torch_flash_tiles.py holds the same rule in plain
// torch. The warp scans seg outwards from its rows, 128 keys a step (4 loads
// a lane, then a ballot each), so a step costs one round trip to L2.
__device__ __forceinline__ int2 warp_span(const int* __restrict__ seg, int r0, int kv0, int kv1,
                                          int lane) {
  if (r0 < kv0 || r0 + WARP_ROWS > kv1) return make_int2(kv0, kv1);
  const int first = seg[r0], last = seg[r0 + WARP_ROWS - 1];
  int lo = kv0, hi = kv1;
  for (int base = r0; base > kv0; base -= 128) {  // keys base - 1, base - 2, ...
    int id[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base - 1 - 32 * u - lane;
      id[u] = j >= kv0 ? seg[j] : first;
    }
    int at = -1;
#pragma unroll
    for (int u = 3; u >= 0; --u) {  // the lowest lane of the lowest u is the nearest key
      const unsigned m = __ballot_sync(0xffffffffu, id[u] != first);
      if (m) at = base - 32 * u - (__ffs(m) - 1);
    }
    if (at >= 0) {
      lo = at;
      break;
    }
  }
  for (int base = r0 + WARP_ROWS; base < kv1; base += 128) {  // keys base, base + 1, ...
    int id[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + 32 * u + lane;
      id[u] = j < kv1 ? seg[j] : last;
    }
    int at = -1;
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const unsigned m = __ballot_sync(0xffffffffu, id[u] != last);
      if (m) at = base + 32 * u + (__ffs(m) - 1);
    }
    if (at >= 0) {
      hi = at;
      break;
    }
  }
  return make_int2(lo, hi);
}

// K1. q/k/v: [S, H, D] with row strides q_rs/k_rs/v_rs (elements), unit dim
// stride, heads D apart; out: [S, H, D] contiguous. Query rows of plan chunk
// c (128 rows) attend keys [kv0, kv0 + kv_range) with kv0 = kv_starts[c]
// clamped like a dynamic slice, masked by seg[query] == seg[key]. One CTA
// owns 64 query rows of one head. Each warp first finds the span of keys its
// 16 rows can attend (warp_span); the CTA walks the union of its 4 warps'
// spans, and a warp computes only the tiles that meet its own span. Keys
// past the union's end get weight 0.
//
// Bound and design: see the file header. The spans are what makes K1 cheap:
// a whole-page line crop is about 212 patches and a window group 16 to 64,
// so most 64-key tiles of a 1024-key window hold no key of a warp's groups.
// The spans are found in the kernel, while the Q tile loads: as a chain of
// torch operations the same computation took 0.7 to 1.9 times as long as
// the kernel itself (PERF.md).
template <int D>
__global__ void __launch_bounds__(SEG_QT / WARP_ROWS * 32, SEG_MIN_CTAS)
    segmented_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, int64_t q_rs, int64_t k_rs, int64_t v_rs,
                               const int* __restrict__ seg, const int* __restrict__ kv_starts,
                               bf16* __restrict__ out, int S, int H, int kv_range,
                               float scale_log2) {
  constexpr int BK = SEG_BK, SROW = D + PAD, CH = D / 8, NW = SEG_QT / WARP_ROWS, NT = NW * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                       // [SEG_QT][SROW]
  bf16* kv_s = q_s + SEG_QT * SROW;                                    // [STAGES][K, V][BK][SROW]
  int* seg_s = reinterpret_cast<int*>(kv_s + STAGES * 2 * BK * SROW);  // [STAGES][BK]
  __shared__ int2 span_s[NW];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * SEG_QT;
  const int64_t hoff = (int64_t)blockIdx.y * D;
  for (int c = tid; c < SEG_QT * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    cp_async16(q_s + r * SROW + ch * 8, q + (q0 + r) * q_rs + hoff + ch * 8, true);
  }
  cp_async_commit();

  const int kv0 = max(0, min(kv_starts[q0 / PLAN_CHUNK], S - kv_range));
  const int2 span = warp_span(seg, q0 + warp * WARP_ROWS, kv0, kv0 + kv_range, lane);
  if (lane == 0) span_s[warp] = span;
  __syncthreads();
  int lo = span_s[0].x, hi = span_s[0].y;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    lo = min(lo, span_s[i].x);
    hi = max(hi, span_s[i].y);
  }
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const int stage = tile % STAGES, base = lo + tile * BK;
    bf16* ks = kv_s + stage * 2 * BK * SROW;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, ch = c % CH, row = base + r;
      const int64_t src = min(row, hi - 1);
      cp_async16(ks + r * SROW + ch * 8, k + src * k_rs + hoff + ch * 8, row < hi);
      cp_async16(ks + (BK + r) * SROW + ch * 8, v + src * v_rs + hoff + ch * 8, row < hi);
    }
    for (int r = tid; r < BK; r += NT)
      cp_async4(seg_s + stage * BK + r, seg + min(base + r, hi - 1), base + r < hi);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const int row_g = q0 + warp * WARP_ROWS + (lane >> 2);
  const int seg0 = seg[row_g], seg1 = seg[row_g + 8];
  WarpRows<D> w(q_s + warp * WARP_ROWS * SROW);

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // K/V tile `tile` (and the Q tile)
    __syncthreads();
    const int kt = lo + tile * BK;
    if (kt < span.y && kt + BK > span.x) {
      const int stage = tile % STAGES;
      const bf16* ks = kv_s + stage * 2 * BK * SROW;
      const int* ss = seg_s + stage * BK;
      const int n_keys = hi - kt;  // tile rows at or past hi were zero-filled
      attend_tile<D, BK, true>(w, ks, ks + BK * SROW, scale_log2, lane, [&](int i, int c) {
        return c >= n_keys ? -1 : (ss[c] == (i ? seg1 : seg0) ? 1 : 0);
      });
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  store_rows<D>(w, q_s + warp * WARP_ROWS * SROW,
                out + (int64_t)(q0 + warp * WARP_ROWS) * H * D + hoff, (int64_t)H * D, WARP_ROWS,
                lane);
}

constexpr int CAUSAL_D = 128;  // K2: head dim of the recognition decoder (1536 / 12)
constexpr int CAUSAL_G = 3;    // K2: query heads per kv head (12 / 4), a consumer warpgroup each
constexpr int BLOCK = 64;      // K2: rows of a Q tile (wgmma's m64) and keys of a K/V tile
constexpr int HALF_ELEMS = BLOCK * 64;  // a 64 x 64 bf16 box: one 128-byte half of each row
constexpr int HALF_BYTES = HALF_ELEMS * 2;
constexpr int TILE_ELEMS = 2 * HALF_ELEMS;  // a 64 x 128 tile
constexpr int TILE_BYTES = 2 * HALF_BYTES;

constexpr int CAUSAL_STAGES = 4;     // K2: K/V tiles in the ring (a persistent CTA's items alternate halves)
constexpr int CAUSAL_QBUF = 2;       // K2: Q tiles a head
// the consumers and a producer warpgroup, which gives its registers to the
// consumers by setmaxnreg (ptxas gives a CTA of 416 threads 128 each)
constexpr int CAUSAL_THREADS = CAUSAL_G * 128 + 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;  // 128 x 24 + 384 x 160 <= 65536

struct CausalSmem {  // at a 1024-byte boundary (its tiles are 16 KB each)
  bf16 k[CAUSAL_STAGES][TILE_ELEMS];
  bf16 v[CAUSAL_STAGES][TILE_ELEMS];
  bf16 q[CAUSAL_G][CAUSAL_QBUF][TILE_ELEMS];
  uint64_t k_full[CAUSAL_STAGES], v_full[CAUSAL_STAGES], kv_empty[CAUSAL_STAGES];
  uint64_t q_full[CAUSAL_G][CAUSAL_QBUF], q_empty[CAUSAL_G][CAUSAL_QBUF];
};

// K2. q: [B, L, H, D], k/v: [B, L, KVH, D], out: [B, L, H, D], all
// contiguous bf16, H = G * KVH; query head h reads kv head h / G; key j is
// valid for row i when j <= i.
//
// Bound and design: see the file header. The work is items: row blocks
// [i0, i1) of batch row b for the G query heads of kv head kh, numbered by
// (batch row, kv head) and then by run, the run of most key tiles first. CTA x takes items x, x +
// gridDim.x, ...: one each where the grid has them all, else several in
// turn (persistent), the producer loading an item's tiles while the
// consumers finish the one before. Warps 0..4G-1 are the consumer
// warpgroups, warpgroup g for query head kh * G + g; the last warpgroup is
// the producer, whose first lane issues every TMA load. Row block i needs
// key tiles 0..i, in that order, the same for all G heads:
// - resident: tile j lands once in stage j (in half `set` of the ring when
//   persistent: items alternate halves) and stays for the item; a
//   persistent CTA's consumer warps free the half with kv_empty at the
//   item's end;
// - else the tiles stream through the ring, stage s % STAGES for the s-th
//   tile the CTA walks, and the 4G consumer warps free a stage with
//   kv_empty (a tile read again by a later row block comes from L2).
// Q tiles go through QBUF buffers per head; a finished row block's output
// is written over its Q tile and leaves by TMA store, which frees the
// buffer (q_empty) once it has been read, checked at the next store.
__global__ void __launch_bounds__(CAUSAL_THREADS, 1)
    causal_attention_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
                            int B, int L, int KVH, int rows_per_cta, float scale_log2) {
  constexpr int STAGES = CAUSAL_STAGES, QBUF = CAUSAL_QBUF;
  // aligned here, not by the declaration: a 1024-byte aligned dynamic
  // shared memory would pad K1's static shared memory to 1 KB in this file
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<CausalSmem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                            ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nb = (L + BLOCK - 1) / BLOCK, runs = (nb + rows_per_cta - 1) / rows_per_cta;
  const int n_items = runs * B * KVH;
  // persistent: every item a whole row (the host launches it so), tiles
  // resident in alternate halves of the ring
  const bool persistent = (int)gridDim.x < n_items;
  const int set = persistent ? STAGES / 2 : STAGES;
  struct Item {
    int b, kh, i0, i1;
    bool resident;
  };
  auto item_of = [&](int n) {  // a pair's runs next to each other: they share K/V tiles in L2
    Item it;
    const int pair = n / runs, run = n % runs;
    it.b = pair / KVH;
    it.kh = pair % KVH;
    it.i0 = (runs - 1 - run) * rows_per_cta;
    it.i1 = min(nb, it.i0 + rows_per_cta);
    it.resident = it.i1 <= set;
    return it;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.kv_empty[s], 4 * CAUSAL_G);
    }
    for (int g = 0; g < CAUSAL_G; ++g)
      for (int u = 0; u < QBUF; ++u) {
        mbar_init(&sm.q_full[g][u], 1);
        mbar_init(&sm.q_empty[g][u], 1);
      }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * CAUSAL_G) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 4 * CAUSAL_G || lane != 0) return;
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    auto load_tile = [&](int b, int kh, int j, int s) {
      mbar_expect_tx(&sm.k_full[s], TILE_BYTES);
      tma_load_4d(sm.k[s], &k_map, &sm.k_full[s], 0, kh, j * BLOCK, b);
      tma_load_4d(sm.k[s] + HALF_ELEMS, &k_map, &sm.k_full[s], 64, kh, j * BLOCK, b);
      mbar_expect_tx(&sm.v_full[s], TILE_BYTES);
      tma_load_4d(sm.v[s], &v_map, &sm.v_full[s], 0, kh, j * BLOCK, b);
      tma_load_4d(sm.v[s] + HALF_ELEMS, &v_map, &sm.v_full[s], 64, kh, j * BLOCK, b);
    };
    // resident tiles go before the row block's Q tiles, which may wait for
    // a buffer; streamed ones after them, as they wait for the consumers
    int step = 0, qi = 0, nl = 0;
    for (int n = blockIdx.x; n < n_items; n += gridDim.x, ++nl) {
      const Item it = item_of(n);
      const int base = persistent ? (nl & 1) * set : 0;
      for (int i = it.i0; i < it.i1; ++i, ++qi) {
        const int u = qi % QBUF;
        if (it.resident) {
          for (int j = i == it.i0 ? 0 : i; j <= i; ++j) {
            if (nl >= 2) mbar_wait(&sm.kv_empty[base + j], (nl / 2 - 1) & 1);
            load_tile(it.b, it.kh, j, base + j);
          }
        }
        for (int g = 0; g < CAUSAL_G; ++g) {
          if (qi >= QBUF) mbar_wait(&sm.q_empty[g][u], (qi / QBUF - 1) & 1);
          mbar_expect_tx(&sm.q_full[g][u], TILE_BYTES);
          tma_load_4d(sm.q[g][u], &q_map, &sm.q_full[g][u], 0, it.kh * CAUSAL_G + g, i * BLOCK, it.b);
          tma_load_4d(sm.q[g][u] + HALF_ELEMS, &q_map, &sm.q_full[g][u], 64, it.kh * CAUSAL_G + g, i * BLOCK,
                      it.b);
        }
        if (!it.resident) {
          for (int j = 0; j <= i; ++j, ++step) {
            const int s = step % STAGES;
            if (step >= STAGES) mbar_wait(&sm.kv_empty[s], (step / STAGES - 1) & 1);
            load_tile(it.b, it.kh, j, s);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 16w + lane / 4 (+ 8) of each row block in its accumulators
  setmaxnreg_inc<CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4, quad = lane & 3, r0 = 16 * w + (lane >> 2);
  int step = 0, qi = 0, nl = 0;
  int stored_g = -1, stored_u = 0;  // the Q buffer of the output store in flight
  for (int n = blockIdx.x; n < n_items; n += gridDim.x, ++nl) {
    const Item it = item_of(n);
    const int base = persistent ? (nl & 1) * set : 0;
    const uint32_t res_parity = persistent ? (nl / 2) & 1 : 0;
    for (int i = it.i0; i < it.i1; ++i, ++qi) {
      const int u = qi % QBUF;
      {
        float o[2][32], s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) o[0][e] = o[1][e] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
        const uint32_t q_s = smem_addr(sm.q[g][u]);
        mbar_wait(&sm.q_full[g][u], (qi / QBUF) & 1);
        for (int j = 0; j <= i; ++j) {
          const int st = it.resident ? base + j : step % STAGES;
          const uint32_t parity = it.resident ? res_parity : (step / STAGES) & 1;
          // S = Q K^T: both K-major, k16 slice kk at byte 32 (kk % 4) of half kk / 4
          mbar_wait(&sm.k_full[st], parity);
          const uint32_t k_s = smem_addr(sm.k[st]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < CAUSAL_D / 16; ++kk) {
            const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
            wgmma_64x64_ss(s, sw128_desc(q_s + off, 16, 1024), sw128_desc(k_s + off, 16, 1024), kk);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(s);
          // scale into the log2 domain; on the diagonal tile key c is valid for
          // row r when c <= r, the rest take the NEG_INF sentinel
          if (j == i) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int r = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * quad + (e & 1);
              s[e] = col <= r ? s[e] * scale_log2 : NEG_INF;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // row r0 + 8h: elements 4n + 2h, 4n + 2h + 1
            float mx = m[h];
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) mx = fmaxf(mx, fmaxf(s[4 * nn + 2 * h], s[4 * nn + 2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float corr = exp2f(m[h] - mx);
            m[h] = mx;
            float sum = 0.f;
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
              s[4 * nn + 2 * h] = exp2f(s[4 * nn + 2 * h] - mx);
              s[4 * nn + 2 * h + 1] = exp2f(s[4 * nn + 2 * h + 1] - mx);
              sum += s[4 * nn + 2 * h] + s[4 * nn + 2 * h + 1];
            }
            l[h] = l[h] * corr + sum;
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
              o[0][4 * nn + 2 * h] *= corr;
              o[0][4 * nn + 2 * h + 1] *= corr;
              o[1][4 * nn + 2 * h] *= corr;
              o[1][4 * nn + 2 * h + 1] *= corr;
            }
          }
          // O += P V: P from registers (the accumulator layout of key blocks
          // 2kk and 2kk + 1 is the A layout of k16 step kk), as its bf16 value
          // and its rounding error; V MN-major, 16 keys (2048 bytes) a step,
          // one m64n128 product over both 64-dim halves (8192 bytes apart: the
          // leading byte offset), o[0] and o[1] its two 64-column halves
          mbar_wait(&sm.v_full[st], parity);
          const uint32_t v_s = smem_addr(sm.v[st]);
          fence_regs(o[0]);
          fence_regs(o[1]);
          uint32_t hi[BLOCK / 16][4], lo[BLOCK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BLOCK / 16; ++kk) {
#pragma unroll
            for (int a = 0; a < 4; ++a) split_bf16x2(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], hi[kk][a], lo[kk][a]);
          }
          wgmma_fence();
          float(&o128)[64] = reinterpret_cast<float(&)[64]>(o);
#pragma unroll
          for (int kk = 0; kk < BLOCK / 16; ++kk) {
            const uint64_t vd = sw128_desc(v_s + kk * 2048, HALF_BYTES, 1024);
            wgmma_64x128_rs_tb(o128, hi[kk], vd);
            wgmma_64x128_rs_tb(o128, lo[kk], vd);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(o[0]);
          fence_regs(o[1]);
          if (!it.resident) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.kv_empty[st]);
            ++step;
          }
        }
        // normalise, write over the Q tile in the swizzled layout, store by TMA
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          l[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
        }
        unsigned char* tile = reinterpret_cast<unsigned char*>(sm.q[g][u]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              *reinterpret_cast<uint32_t*>(tile + half * HALF_BYTES + sw128(r, 16 * nn + 4 * quad)) =
                  pack_bf16x2(o[half][4 * nn + 2 * h] * l[h], o[half][4 * nn + 2 * h + 1] * l[h]);
            }
          }
        }
        fence_proxy_async();
        warpgroup_sync(1 + g);
        if (w == 0 && lane == 0) {
          tma_store_4d(&o_map, sm.q[g][u], 0, it.kh * CAUSAL_G + g, i * BLOCK, it.b);
          tma_store_4d(&o_map, sm.q[g][u] + HALF_ELEMS, 64, it.kh * CAUSAL_G + g, i * BLOCK, it.b);
          bulk_commit();
          // the previous store has read its tile: free that Q buffer (this
          // one's read goes on under the next head's products)
          bulk_wait_read<1>();
          if (stored_g >= 0) mbar_arrive(&sm.q_empty[stored_g][stored_u]);
          stored_g = g;
          stored_u = u;
        }
      }
    }
    if (persistent && it.resident) {  // the item's half of the ring is free
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < it.i1; ++j) mbar_arrive(&sm.kv_empty[base + j]);
    }
  }
  if (w == 0 && lane == 0) bulk_wait_read<0>();  // the last store has read its tile before the CTA ends
}

constexpr int SEG_D = 80;  // head dim of the recognition encoder (1280 / 16)

}  // namespace

// The wrapper (ops/flash.py) has checked shapes, dtype (bf16), alignment,
// S % 128 == 0 and 0 < kv_range <= S. Each entry returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a configuration it was not
// built for. Dynamic shared memory above 48 KB must be asked for on each
// device; each launch asks, which costs little next to the launch.
extern "C" int surya_segmented_attention(const void* q, const void* k, const void* v, int64_t q_rs,
                                         int64_t k_rs, int64_t v_rs, const void* seg,
                                         const void* kv_starts, void* out, int S, int H, int D,
                                         int kv_range, float scale, void* stream) {
  if (D != SEG_D || S % PLAN_CHUNK || kv_range <= 0 || kv_range > S) return (int)cudaErrorInvalidValue;
  constexpr int smem = (SEG_QT + STAGES * 2 * SEG_BK) * (SEG_D + PAD) * (int)sizeof(bf16) +
                       STAGES * SEG_BK * (int)sizeof(int);
  const auto kernel = segmented_attention_kernel<SEG_D>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3(S / SEG_QT, H), SEG_QT / WARP_ROWS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), q_rs,
      k_rs, v_rs, static_cast<const int*>(seg), static_cast<const int*>(kv_starts),
      static_cast<bf16*>(out), S, H, kv_range, scale * LOG2E);
  return (int)cudaGetLastError();
}

// K2's rows an item and CTAs, as measured on the H100 (PERF.md): an item takes all of a (batch row, kv head)'s row
// blocks where there are two waves of such items and its tiles stay
// resident, else one row block, so that few batch rows or a long L still
// fill the card; one CTA an SM walks the items (persistent) where they are
// whole rows whose tiles fit half the ring and outnumber the SMs, else one
// CTA an item.
struct CausalLaunch {
  int rows_per_cta, ctas;
};

static CausalLaunch causal_launch(int B, int L, int KVH) {
  const int sms = sm_count();
  const int nb = (L + BLOCK - 1) / BLOCK;
  const int64_t pairs = (int64_t)B * KVH;
  CausalLaunch c;
  c.rows_per_cta = pairs < 2 * sms || nb > CAUSAL_STAGES ? 1 : nb;
  const int items = (int)((nb + c.rows_per_cta - 1) / c.rows_per_cta * pairs);
  const bool can_persist = c.rows_per_cta == nb && 2 * nb <= CAUSAL_STAGES;
  c.ctas = can_persist && items > sms ? sms : items;
  return c;
}

static int launch_causal(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
                         const CUtensorMap& o_map, int B, int L, int KVH, const CausalLaunch& c, float scale_log2,
                         cudaStream_t stream) {
  constexpr int smem = (int)sizeof(CausalSmem) + 1024;  // and room to align it to 1024 bytes
  const cudaError_t attr =
      cudaFuncSetAttribute(causal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  causal_attention_kernel<<<c.ctas, CAUSAL_THREADS, smem, stream>>>(q_map, k_map, v_map, o_map, B, L, KVH,
                                                                    c.rows_per_cta, scale_log2);
  return (int)cudaGetLastError();
}

// How K2 launches at these shapes, into cfg: CTAs, row blocks an item,
// K/V stages, dynamic shared memory and threads of a CTA. Returns 0.
extern "C" int surya_causal_config(int B, int L, int KVH, int* cfg) {
  const CausalLaunch c = causal_launch(B, L, KVH);
  const int out[5] = {c.ctas, c.rows_per_cta, CAUSAL_STAGES, (int)sizeof(CausalSmem) + 1024, CAUSAL_THREADS};
  for (int i = 0; i < 5; ++i) cfg[i] = out[i];
  return 0;
}

extern "C" int surya_causal_attention(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
                                      int KVH, int D, float scale, void* stream) {
  if (D != CAUSAL_D || H != CAUSAL_G * KVH || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const CausalLaunch c = causal_launch(B, L, KVH);
  // [B, L, heads, D] as 4-D maps, innermost first; 64 x 64 boxes (one head)
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t k_dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint64_t k_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2, (cuuint64_t)L * KVH * D * 2};
  const cuuint32_t box[4] = {64, 1, BLOCK, 1};
  CUtensorMap q_map, k_map, v_map, o_map;
  constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&q_map, bf, 4, q, q_dims, q_strides, box) || !make_map(&k_map, bf, 4, k, k_dims, k_strides, box) ||
      !make_map(&v_map, bf, 4, v, k_dims, k_strides, box) || !make_map(&o_map, bf, 4, out, q_dims, q_strides, box))
    return (int)cudaErrorInvalidValue;
  return launch_causal(q_map, k_map, v_map, o_map, B, L, KVH, c, scale * LOG2E, static_cast<cudaStream_t>(stream));
}
