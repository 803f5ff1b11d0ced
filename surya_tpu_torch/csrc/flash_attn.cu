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
// q/k/v from device memory with the arithmetic hidden under the copies:
//
// - Both products run on the tensor cores as warp-level mma.sync.m16n8k16
//   (bf16 in, fp32 accumulate), operands from shared memory by ldmatrix.
//   mma.sync and not wgmma: by their bounds the kernels need a few percent
//   of the tensor cores' peak, and mma.sync keeps each warp on its own 16
//   query rows, takes D = 80 without a swizzle that a 160-byte row does not
//   fit, and lets the accumulator of Q K^T become the A operand of P V in
//   registers. At K2's main shape the mma.sync issue rate and the ldmatrix
//   reads do show (PERF.md): a wgmma K2 is the next step there.
// - P (the exponentiated logits, as a sum of two bf16 terms) never leaves
//   registers: the m16n8 accumulator layout of two neighbouring key octets
//   is the m16k16 A layout of P V.
// - Online softmax in fp32 per row (row max and sum over the 4 lanes of a
//   quad; exp2 with log2(e) folded into the scale), with the finite NEG_INF
//   sentinel of the Pallas kernels: a masked key has logit NEG_INF, so a row
//   that has seen no valid key yet weighs it 1 and the first valid key
//   scales that away exactly (exp2(NEG_INF - m) == 0), as in `_kernel`.
// - K/V tiles of BK keys stream through a ring of STAGES tiles in shared
//   memory by cp.async (16 bytes a lane), so the next tile loads while the
//   current one computes; the Q tile arrives the same way. Shared rows are
//   padded by 16 bytes (D + 8 elements: 176 bytes for D = 80, 272 for
//   D = 128, an odd number of 16-byte units), so the 8 row addresses of an
//   ldmatrix hit 8 different bank groups. The output is staged through the
//   warp's own Q rows and leaves as coalesced 16-byte stores.
//
// Where the Pallas grid carried (m, l, acc) in VMEM scratch from one KV
// block to the next, that state lives in each warp's registers inside the
// CTA's own loop over KV tiles.

#include "common.cuh"

using namespace surya;

namespace {

constexpr int STAGES = 2;         // depth of the K/V ring
constexpr int WARP_ROWS = 16;     // query rows of one warp: the m16 of mma.sync
constexpr int SEG_QT = 64;        // K1: query rows per CTA (4 warps)
constexpr int PLAN_CHUNK = 128;   // K1: query rows per kv_starts entry (FULL_ATTN_Q_CHUNK)
constexpr int SEG_BK = 64;        // K1: keys per shared-memory tile
constexpr int SEG_MIN_CTAS = 4;   // K1: CTAs an SM must hold (caps registers at 128)
constexpr int CAUSAL_QT = 64;     // K2: query rows per CTA (4 warps)
constexpr int CAUSAL_BK = 32;     // K2: keys per shared-memory tile
constexpr int CAUSAL_MIN_CTAS = 4;  // K2: CTAs an SM must hold (caps registers at 128)

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

// K2. q: [B, L, H, D], k/v: [B, L, KVH, D], out: [B, L, H, D], all
// contiguous. Query head h reads kv head h / (H / KVH); key j is valid for
// row i when j <= i.
//
// Bound and design: see the file header. One CTA owns CAUSAL_QT query rows
// of one query head (4 warps of 16 rows), so the 3 query heads of a kv head
// read its K/V tiles 3 times, the second and third time from L2. One CTA per
// kv head serving its 3 query heads from each tile it loads measured slower
// at the main shape (PERF.md). The CTA loads only the tiles up to its last
// row, so tiles above the diagonal are neither loaded nor computed; a warp
// skips the tiles past its own last row and masks only the tile that holds
// its diagonal. CTAs with the most tiles start first.
template <int D>
__global__ void __launch_bounds__(CAUSAL_QT / WARP_ROWS * 32, CAUSAL_MIN_CTAS)
    causal_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int L, int H,
                            int KVH, float scale_log2) {
  constexpr int QT = CAUSAL_QT, BK = CAUSAL_BK, SROW = D + PAD, CH = D / 8;
  constexpr int NT = QT / WARP_ROWS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QT][SROW]
  bf16* kv_s = q_s + QT * SROW;                   // [STAGES][K, V][BK][SROW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;
  const int n_tiles = (min(L, q0 + QT) + BK - 1) / BK;
  const int64_t q_rs = (int64_t)H * D, kv_rs = (int64_t)KVH * D;
  const bf16* qb = q + ((int64_t)b * L * H + h) * D;
  const int64_t kv_off = ((int64_t)b * L * KVH + h / (H / KVH)) * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  for (int c = tid; c < QT * CH; c += NT) {
    const int r = c / CH, ch = c % CH, row = q0 + r;
    cp_async16(q_s + r * SROW + ch * 8, qb + (int64_t)min(row, L - 1) * q_rs + ch * 8, row < L);
  }
  auto load_kv = [&](int tile) {
    bf16* ks = kv_s + (tile % STAGES) * 2 * BK * SROW;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, ch = c % CH, row = tile * BK + r;
      const int64_t off = (int64_t)min(row, L - 1) * kv_rs + ch * 8;
      cp_async16(ks + r * SROW + ch * 8, kb + off, row < L);
      cp_async16(ks + (BK + r) * SROW + ch * 8, vb + off, row < L);
    }
  };
  load_kv(0);
  cp_async_commit();  // the Q tile and K/V tile 0

  // the warp's first row in the tile: warp < QT / WARP_ROWS, so the % changes
  // nothing, but the bound it shows the compiler saves spills (PERF.md)
  const int wrow = (warp % (QT / WARP_ROWS)) * WARP_ROWS;
  const int row0 = q0 + wrow;
  const int g = lane >> 2;
  WarpRows<D> w(q_s + wrow * SROW);

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // K/V tile `tile` (and the Q tile)
    __syncthreads();
    const int kt = tile * BK;
    const bf16* ks = kv_s + (tile % STAGES) * 2 * BK * SROW;
    if (kt + BK - 1 <= row0) {
      attend_tile<D, BK, false>(w, ks, ks + BK * SROW, scale_log2, lane,
                                [](int, int) { return 1; });
    } else if (kt <= row0 + WARP_ROWS - 1) {
      // key kt + c is valid for row row0 + g + 8i when kt + c <= row0 + g + 8i
      const int d = row0 + g - kt;
      attend_tile<D, BK, true>(w, ks, ks + BK * SROW, scale_log2, lane,
                               [d](int i, int c) { return c <= d + 8 * i ? 1 : 0; });
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  store_rows<D>(w, q_s + wrow * SROW, out + (((int64_t)b * L + row0) * H + h) * D, q_rs, L - row0,
                lane);
}

constexpr int SEG_D = 80;      // head dim of the recognition encoder (1280 / 16)
constexpr int CAUSAL_D = 128;  // and of the recognition decoder (1536 / 12)

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

extern "C" int surya_causal_attention(const void* q, const void* k, const void* v, void* out, int B,
                                      int L, int H, int KVH, int D, float scale, void* stream) {
  if (D != CAUSAL_D || H % KVH) return (int)cudaErrorInvalidValue;
  constexpr int smem = (CAUSAL_QT + STAGES * 2 * CAUSAL_BK) * (CAUSAL_D + PAD) * (int)sizeof(bf16);
  const auto kernel = causal_attention_kernel<CAUSAL_D>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((L + CAUSAL_QT - 1) / CAUSAL_QT, H, B);
  kernel<<<grid, CAUSAL_QT / WARP_ROWS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), L, H, KVH, scale * LOG2E);
  return (int)cudaGetLastError();
}
