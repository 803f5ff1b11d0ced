// One-token GQA decode attention over the slot KV cache (K3 and K3q): each
// (slot, kv head) split over the card, its partials merged by the split
// that ends last.
//
// Replaces the Pallas kernel surya_tpu/ops/decode_attn.py::gqa_decode_pallas
// (`_decode_kernel`): K3 with a bf16 cache, K3q with an int8 cache and one
// bf16 scale per cache row (`quantized=True`). Each (slot, kv head) attends
// its valid cache rows (< lengths[slot]) and the chunk buffer's columns
// 0..step as one softmax, for its 3 query heads.
//
// What bounds it on an H100 is bytes: every valid K and V row is read once
// and serves 3 query heads, 4 flops per element and head, about 1.5 flops a
// byte in bf16 and 3 in int8, two orders below the tensor cores' ratio. The
// chunk buffer is bf16 in both kernels and is read in full up to `step` by
// every slot; on the pinned main path it is as large as the cache's valid
// rows. The earlier kernel walked each (slot, kv head) in one CTA, row after
// row, so the longest slot set the time (PERF.md). Here:
//
// - Split-KV. Each (slot, kv head) is cut into splits of DEC_TILE cache rows
//   or chunk columns: ceil(S / T) cache splits and ceil(K / T) chunk splits.
//   The grid is (slots, splits), one warp per kv head, so it depends only on
//   the shapes: no host sync, and a CUDA graph captures the call. A split
//   whose first row is at or past lengths[slot] (read on the device), or
//   whose first column is past `step`, exits at once; those come last in
//   the grid's order, after every slot's first chunk and cache split.
// - Streaming. A warp walks its split in sub-tiles of SUB rows (one
//   contiguous block of its (layer, slot, kv head) slab for K and one for V)
//   through its own ring of NSTAGE stages in shared memory, filled by
//   cp.async, so the next sub-tile lands while this one computes. The warps
//   of a CTA never wait for each other.
// - The products run on the tensor cores as mma.sync m16n8k16 with the 3
//   query heads as rows 0..2 of the A tile (13 of 16 rows are zero, which
//   the bytes leave room for), an online softmax over the sub-tiles in
//   registers, and P going from the accumulator of Q K^T straight into P V
//   as two bf16 terms (its rounded value and the rounding error; P rounded
//   once to bf16 put K2 outside tolerance, PERF.md).
// - K3q: the row scales stay out of the products. An int8 value is exact in
//   bf16, so a sub-tile's int8 rows are widened in shared memory by a
//   magic-number add (no int-to-float instruction); the logit is
//   ks_r (q . k_int) and P V takes p_r vs_r.
// - Merge. A split that is the only one of its (slot, kv head) writes the
//   output itself. Any other writes its partial (m, l, acc[3][128]) in fp32
//   to a workspace the wrapper allocates with torch.empty, then counts
//   itself in an int per (slot, kv head); the warp that counts the last
//   split merges the partials of the splits that ran (log-sum-exp; it finds
//   them from lengths and step by the same rule and reads no other) and
//   sets the count back to 0, so the wrapper's zeroed counts serve every
//   call and graph replay. One launch: a merge kernel of its own cost more
//   at the main path's short caches (PERF.md). Every split that runs has a
//   valid row, so its m is finite; the chunk's first split always runs
//   (column 0 <= step), so the sum is > 0.

#include "common.cuh"

using namespace surya;

namespace {

constexpr int HD = 128;         // head dim of the recognition decoder (1536 / 12)
constexpr int G = 3;            // query heads per kv head (12 / 4)
constexpr int DEC_TILE = 64;    // cache rows or chunk columns of one split
constexpr int SUB = 16;         // rows a warp computes at once: a sub-tile
constexpr int NSTAGE = 2;       // sub-tiles in a warp's ring
constexpr int MAX_KVH = 4;      // kv heads of a CTA, one warp each
constexpr int SROW = HD + PAD;  // shared row stride: 272 bytes, 17 units of 16

// One stage of a warp's ring: a sub-tile's K and V rows (an int8 row lands
// in bytes 128..255 of its 272-byte row and is widened to bf16 in place).
struct alignas(16) Stage {
  bf16 k[SUB][SROW];
  bf16 v[SUB][SROW];
};

// A warp's shared memory: its 3 query rows and its ring.
struct alignas(16) WarpSmem {
  bf16 q[G][HD];
  Stage ring[NSTAGE];
};

struct Args {
  const bf16* q;
  const void* k_cache;
  const void* v_cache;
  const bf16* k_scale;
  const bf16* v_scale;
  const int* lengths;
  const bf16* chunk_k;
  const bf16* chunk_v;
  bf16* out;
  float* ws;  // acc [B][KVH][NS][G][HD], then (m, l) [B][KVH][NS][G][2], fp32
  int* done;  // [B][KVH] splits that have ended; 0 before and after a call
  int B, KVH, S, K, NS, step, layer;
  float scale_log2;
};

// Rows of split x of one (slot, kv head): splits [0, nc) cover the cache
// (rows < len), the rest the chunk (columns <= step). <= 0: the split exits.
__device__ __forceinline__ int split_rows(int x, int nc, int len, int step) {
  return x < nc ? min(DEC_TILE, len - x * DEC_TILE) : min(DEC_TILE, step + 1 - (x - nc) * DEC_TILE);
}

// Splits of a slot that run: its cache splits, then its chunk splits.
__device__ __forceinline__ int splits_of(const Args& a, int len) {
  return (len + DEC_TILE - 1) / DEC_TILE + a.step / DEC_TILE + 1;
}

__device__ __forceinline__ int slot_len(const Args& a, int b) { return min(max(a.lengths[b], 0), a.S); }

// Bytes i and i + 1 of w as signed int8 -> a bf16 pair, exactly: the byte
// plus 128 becomes the low mantissa bits of 2^23, 2^23 + 128 is taken off,
// and as the result has at most 8 significant bits its bf16 is the top half
// of its fp32 bits.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int i) {
  const uint32_t u = w ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (i + 1))) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// The int8 K and V rows of a stage (bytes 128..255 of each row) -> bf16
// rows in place: each lane reads its 16-byte pieces, then the warp writes.
__device__ __forceinline__ void widen_int8_rows(Stage& st, int lane) {
  constexpr int PER = 2 * SUB * (HD / 16) / 32;
  uint4 w[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i, r = c / (HD / 16), ch = c % (HD / 16);
    const bf16* row = r < SUB ? st.k[r] : st.v[r - SUB];
    w[i] = *reinterpret_cast<const uint4*>(reinterpret_cast<const int8_t*>(row) + HD + ch * 16);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i, r = c / (HD / 16), ch = c % (HD / 16);
    bf16* row = r < SUB ? st.k[r] : st.v[r - SUB];
    const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = int8x2_to_bf16x2(words[e], 0);
      o[2 * e + 1] = int8x2_to_bf16x2(words[e], 2);
    }
    uint4* d = reinterpret_cast<uint4*>(row + ch * 16);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  __syncwarp();
}

// One warp's online-softmax state over a split: lane g = lane / 4 < G holds
// query head g (its bf16 query pairs at dims 16kk + 2t and 16kk + 2t + 8, t
// = lane % 4), its running max (log2 domain) and sum, and its output at
// dims 8j + 2t, +1 (rows G..15 of the mma tiles are zero).
struct SplitState {
  uint32_t qa[HD / 16][2];
  float m, l;
  float o[HD / 8][4];
};

// Start the copies of sub-tile j of a split of n rows from row r0 into st
// (rows past the split's last are zero-filled, not read). K3q cache rows
// (INT8_ROWS): lane r < 16 loads row r's K scale into sc, lane 16 + r its V
// scale.
template <bool INT8_ROWS>
__device__ __forceinline__ void issue_sub(Stage& st, const void* kbase, const void* vbase, const Args& a,
                                          int64_t r0, int n, int j, int lane, float& sc) {
  const int rows = min(SUB, n - j * SUB);
  const int64_t rj = r0 + j * SUB;
  if constexpr (INT8_ROWS) {
    const int8_t* kc = static_cast<const int8_t*>(kbase) + rj * HD;
    const int8_t* vc = static_cast<const int8_t*>(vbase) + rj * HD;
#pragma unroll
    for (int i = 0; i < SUB * (HD / 16) / 32; ++i) {
      const int c = lane + 32 * i, r = c / (HD / 16), ch = c % (HD / 16);
      const int64_t src = (r < rows ? r : 0) * HD + ch * 16;
      cp_async16(reinterpret_cast<int8_t*>(st.k[r]) + HD + ch * 16, kc + src, r < rows);
      cp_async16(reinterpret_cast<int8_t*>(st.v[r]) + HD + ch * 16, vc + src, r < rows);
    }
    const int r = lane % SUB;
    sc = r < rows ? __bfloat162float((lane < SUB ? a.k_scale : a.v_scale)[rj + r]) : 0.f;
  } else {
    const bf16* kp = static_cast<const bf16*>(kbase) + rj * HD;
    const bf16* vp = static_cast<const bf16*>(vbase) + rj * HD;
#pragma unroll
    for (int i = 0; i < SUB * (HD / 8) / 32; ++i) {
      const int c = lane + 32 * i, r = c / (HD / 8), ch = c % (HD / 8);
      const int64_t src = (r < rows ? r : 0) * HD + ch * 8;
      cp_async16(&st.k[r][ch * 8], kp + src, r < rows);
      cp_async16(&st.v[r][ch * 8], vp + src, r < rows);
    }
  }
}

// Q K^T, softmax update and P V for one sub-tile in `st` (rows >= 1 valid
// rows). INT8_ROWS: int8 rows, widened to bf16 (exact), sc as in issue_sub;
// the row scales stay out of the products: ks_r (q . k_int), and P V takes
// p_r vs_r.
template <bool INT8_ROWS>
__device__ __forceinline__ void attend_sub(SplitState& w, Stage& st, int rows, float sc, float scale_log2,
                                           int lane) {
  const int t = lane & 3;
  if constexpr (INT8_ROWS) widen_int8_rows(st, lane);
  // S = Q K^T over the 16 keys; even and odd k-steps accumulate apart,
  // which halves the chain of dependent mma
  float sc2[2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t a4[4] = {w.qa[kk][0], 0u, w.qa[kk][1], 0u};
    uint32_t b[4];
    ldmatrix_x4(b, &st.k[(lane & 7) + ((lane >> 4) & 1) * 8][kk * 16 + ((lane >> 3) & 1) * 8]);
    mma_16816(sc2[kk & 1][0], a4, b[0], b[1]);
    mma_16816(sc2[kk & 1][1], a4, b[2], b[3]);
  }
  // lane (g, t) holds keys 8jn + 2t + e of head g; its quad holds all 16
  float x[2][2], mx = w.m;
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = jn * 8 + 2 * t + e;
      float v = (sc2[0][jn][e] + sc2[1][jn][e]) * scale_log2;
      if constexpr (INT8_ROWS) v *= __shfl_sync(0xffffffffu, sc, key);
      x[jn][e] = key < rows ? v : -__uint_as_float(0x7f800000u);
      mx = fmaxf(mx, x[jn][e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float corr = exp2f(w.m - mx);  // 0 at a split's first sub-tile (w.m == NEG_INF)
  float sum = 0.f;
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[jn][e] = exp2f(x[jn][e] - mx);  // 0 past the last valid row
      sum += x[jn][e];
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  w.l = w.l * corr + sum;
  w.m = mx;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    w.o[dn][0] *= corr;
    w.o[dn][1] *= corr;
  }
  if constexpr (INT8_ROWS) {  // P V takes p_r vs_r
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) x[jn][e] *= __shfl_sync(0xffffffffu, sc, SUB + jn * 8 + 2 * t + e);
    }
  }
  // O += P V: the accumulator layout of the two key octets is the m16k16 A
  // layout; P as two bf16 terms (its rounding error apart), V by ldmatrix.trans
  uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
  split_bf16x2(x[0][0], x[0][1], hi[0], lo[0]);
  split_bf16x2(x[1][0], x[1][1], hi[2], lo[2]);
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &st.v[(lane & 7) + ((lane >> 3) & 1) * 8][dn * 16 + ((lane >> 4) & 1) * 8]);
    mma_16816(w.o[2 * dn], hi, b[0], b[1]);
    mma_16816(w.o[2 * dn], lo, b[0], b[1]);
    mma_16816(w.o[2 * dn + 1], hi, b[2], b[3]);
    mma_16816(w.o[2 * dn + 1], lo, b[2], b[3]);
  }
}

// A warp's walk over a split, n >= 1 rows from row r0 of kbase/vbase, for
// the query rows q, through its ring: sub-tile j computes from stage
// j % NSTAGE while the next NSTAGE - 1 load; sc[k] is the K3q row scale of
// sub-tile j + k. Leaves the split's state in w.
template <bool INT8_ROWS>
__device__ __forceinline__ void walk_split(SplitState& w, WarpSmem& sm, const bf16* q, const void* kbase,
                                           const void* vbase, const Args& a, int64_t r0, int n, int lane) {
  const int nsub = (n + SUB - 1) / SUB;
  w.m = NEG_INF;
  w.l = 0.f;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) w.o[dn][0] = w.o[dn][1] = w.o[dn][2] = w.o[dn][3] = 0.f;
  // the query rows: their copies join the first sub-tile's group
  for (int c = lane; c < G * HD / 8; c += 32) cp_async16(&sm.q[0][0] + c * 8, q + c * 8, true);
  float sc[NSTAGE] = {};
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nsub) issue_sub<INT8_ROWS>(sm.ring[k], kbase, vbase, a, r0, n, k, lane, sc[k]);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0; j < nsub; ++j) {
    const int jn = j + NSTAGE - 1;
    if (jn < nsub) issue_sub<INT8_ROWS>(sm.ring[jn % NSTAGE], kbase, vbase, a, r0, n, jn, lane, sc[NSTAGE - 1]);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // sub-tile j (and the query rows) have landed
    __syncwarp();
    if (j == 0) {
      const bf16* qrow = sm.q[min(g, G - 1)];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        w.qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 2 * t) : 0u;
        w.qa[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 2 * t + 8) : 0u;
      }
    }
    attend_sub<INT8_ROWS>(w, sm.ring[j % NSTAGE], min(SUB, n - j * SUB), sc[0], a.scale_log2, lane);
    __syncwarp();  // the stage is free before it is refilled
#pragma unroll
    for (int k = 0; k < NSTAGE - 1; ++k) sc[k] = sc[k + 1];
  }
}

// The merge of a (slot, kv head)'s partials by one warp, 32 splits at a
// time: lane x holds split x's (m, l) for the 3 heads, the running state is
// rescaled to the block's max, then each lane sums 4 of the 128 dims over
// the splits that ran (no other split's workspace is read), loading the
// partials of MERGE_BATCH splits at once. The first batch's loads go out
// before the (m, l) loads are waited for: the merge is the tail of the call.
constexpr int MERGE_BATCH = 4;

__device__ __forceinline__ void merge_partials(const Args& a, int b, int kh, int len, int lane) {
  const int nc = (a.S + DEC_TILE - 1) / DEC_TILE;
  const int64_t part0 = ((int64_t)b * a.KVH + kh) * a.NS;
  const float* ml = a.ws + (int64_t)a.B * a.KVH * a.NS * G * HD + part0 * G * 2;
  const float4* acc = reinterpret_cast<const float4*>(a.ws + part0 * G * HD) + lane;
  float M[G], L[G], O[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    M[g] = NEG_INF;
    L[g] = 0.f;
    O[g][0] = O[g][1] = O[g][2] = O[g][3] = 0.f;
  }
  for (int x0 = 0; x0 < a.NS; x0 += 32) {
    const int x = x0 + lane;
    const bool ran = x < a.NS && split_rows(x, nc, len, a.step) > 0;
    float mx[G], lx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mx[g] = ran ? __ldcg(ml + (x * G + g) * 2) : NEG_INF;
      lx[g] = ran ? __ldcg(ml + (x * G + g) * 2 + 1) : 0.f;
    }
    unsigned left = __ballot_sync(0xffffffffu, ran);
    int src[MERGE_BATCH];  // block-relative splits of this batch, -1: none
    float4 v[MERGE_BATCH][G];
    auto load_batch = [&]() {
#pragma unroll
      for (int i = 0; i < MERGE_BATCH; ++i) {
        src[i] = left ? __ffs(left) - 1 : -1;
        left &= left - 1;
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[i][g] = src[i] >= 0 ? __ldcg(acc + ((x0 + src[i]) * G + g) * (HD / 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    load_batch();
    float wx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float bm = mx[g];
#pragma unroll
      for (int off = 16; off; off >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float mn = fmaxf(M[g], bm), c = exp2f(M[g] - mn);
      L[g] *= c;
      O[g][0] *= c;
      O[g][1] *= c;
      O[g][2] *= c;
      O[g][3] *= c;
      M[g] = mn;
      wx[g] = exp2f(mx[g] - mn);  // 0 for a split that did not run
      L[g] = fmaf(lx[g], wx[g], L[g]);
    }
    for (;;) {
#pragma unroll
      for (int i = 0; i < MERGE_BATCH; ++i) {
        if (src[i] < 0) continue;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = __shfl_sync(0xffffffffu, wx[g], src[i]);
          O[g][0] = fmaf(v[i][g].x, w, O[g][0]);
          O[g][1] = fmaf(v[i][g].y, w, O[g][1]);
          O[g][2] = fmaf(v[i][g].z, w, O[g][2]);
          O[g][3] = fmaf(v[i][g].w, w, O[g][3]);
        }
      }
      if (!left) break;
      load_batch();
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off; off >>= 1) L[g] += __shfl_xor_sync(0xffffffffu, L[g], off);
    const float inv = 1.f / L[g];  // the chunk's first split always runs: L > 0
    uint2 packed;
    packed.x = pack_bf16x2(O[g][0] * inv, O[g][1] * inv);
    packed.y = pack_bf16x2(O[g][2] * inv, O[g][3] * inv);
    reinterpret_cast<uint2*>(a.out + ((int64_t)b * a.KVH * G + kh * G + g) * HD)[lane] = packed;
  }
}

// The end of a split: the normalised output when it is the only split of its
// (slot, kv head) that runs, else its partial for the merge.
__device__ __forceinline__ void finish_split(const Args& a, const SplitState& w, int b, int kh, int x, int splits,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (g >= G) return;
  if (splits == 1) {
    const float inv = 1.f / w.l;
    uint32_t* o = reinterpret_cast<uint32_t*>(a.out + ((int64_t)b * a.KVH * G + kh * G + g) * HD + 2 * t);
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) o[4 * dn] = pack_bf16x2(w.o[dn][0] * inv, w.o[dn][1] * inv);
    return;
  }
  const int64_t part = ((int64_t)b * a.KVH + kh) * a.NS + x;
  float* acc = a.ws + (part * G + g) * HD + 2 * t;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) *reinterpret_cast<float2*>(acc + 8 * dn) = make_float2(w.o[dn][0], w.o[dn][1]);
  if (t == 0) {
    float* ml = a.ws + (int64_t)a.B * a.KVH * a.NS * G * HD + (part * G + g) * 2;
    ml[0] = w.m;
    ml[1] = w.l;
  }
}

// q: [B, H, D]; k_cache/v_cache: [layers, B, KVH, S, D] (bf16, or int8 with
// k_scale/v_scale [layers, B, KVH, S] bf16 when QUANT); lengths: [B] int32;
// chunk_k/chunk_v: [layers, B, KVH, K, D] bf16; all contiguous. Grid
// (slots, splits): CTA (b, y) walks one split of slot b, warp kh for kv
// head kh (walk_split), and ends it (finish_split). blockIdx.x is the slot
// and y counts the chunk's splits first, so the splits most likely to run
// (the chunk's first, then the cache's first) reach the SMs first and those
// past most slots' lengths come last. The warp that ends the last split of
// its (slot, kv head) merges the partials. The kernel keeps the name and
// template arguments of the one it replaced, which profile_smoke.py matches.
template <int D, int GROUP, bool QUANT>
__global__ void __launch_bounds__(32 * MAX_KVH, 12 / MAX_KVH) gqa_decode_kernel(const Args a) {
  static_assert(D == HD && GROUP == G, "built for the recognition decoder's heads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kh = threadIdx.x / 32, lane = threadIdx.x % 32;
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem_raw)[kh];
  const int b = blockIdx.x, nc = (a.S + DEC_TILE - 1) / DEC_TILE, nk = a.NS - nc;
  const int x = blockIdx.y < nk ? nc + blockIdx.y : blockIdx.y - nk;
  const int len = slot_len(a, b);
  const bf16* q = a.q + ((int64_t)b * a.KVH + kh) * G * HD;
  const int64_t slab = ((int64_t)a.layer * a.B + b) * a.KVH + kh;
  const bool chunk = x >= nc;
  const int n = split_rows(x, nc, len, a.step);
  if (n <= 0) return;
  const int64_t r0 = chunk ? slab * a.K + (int64_t)(x - nc) * DEC_TILE : slab * a.S + (int64_t)x * DEC_TILE;
  SplitState w;
  if (QUANT && !chunk)
    walk_split<true>(w, sm, q, a.k_cache, a.v_cache, a, r0, n, lane);
  else
    walk_split<false>(w, sm, q, chunk ? a.chunk_k : a.k_cache, chunk ? a.chunk_v : a.v_cache, a, r0, n, lane);
  const int splits = splits_of(a, len);
  finish_split(a, w, b, kh, x, splits, lane);
  if (splits == 1) return;
  // the last of the (slot, kv head)'s splits to end merges: each lane's
  // partial is visible before lane 0 counts the split, and the count is
  // left at 0 for the next call
  __threadfence();
  __syncwarp();
  int* done = a.done + b * a.KVH + kh;
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(done, 1) == splits - 1;
    if (last) *done = 0;
  }
  if (__shfl_sync(0xffffffffu, last, 0)) merge_partials(a, b, kh, len, lane);
}

template <bool QUANT>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                  const void* v_scale, const void* lengths, const void* chunk_k, const void* chunk_v,
                  void* out, void* ws, int64_t ws_floats, void* done, int B, int KVH, int S, int K, int step,
                  int layer, float scale, cudaStream_t stream) {
  const int ns = (S + DEC_TILE - 1) / DEC_TILE + (K + DEC_TILE - 1) / DEC_TILE;
  if (KVH < 1 || KVH > MAX_KVH || ws_floats < (int64_t)B * KVH * ns * G * (HD + 2))
    return (int)cudaErrorInvalidValue;
  const auto kernel = gqa_decode_kernel<HD, G, QUANT>;
  const int smem = KVH * (int)sizeof(WarpSmem);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a{static_cast<const bf16*>(q), k_cache, v_cache, static_cast<const bf16*>(k_scale),
         static_cast<const bf16*>(v_scale), static_cast<const int*>(lengths),
         static_cast<const bf16*>(chunk_k), static_cast<const bf16*>(chunk_v), static_cast<bf16*>(out),
         static_cast<float*>(ws), static_cast<int*>(done), B, KVH, S, K, ns, step, layer, scale * LOG2E};
  kernel<<<dim3(B, ns), 32 * KVH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/decode_attn.py) has checked shapes, dtypes, contiguity and
// 0 <= step < K, 0 <= layer < layers, allocated the workspace (B * KVH *
// (ceil(S / 64) + ceil(K / 64)) * 3 * 130 floats) and passes `done`, B * KVH
// ints that are 0 and that the kernel leaves 0. Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it was not built for (the recognition decoder's head dim 128, 3 query heads
// per kv head, at most 4 kv heads) or a workspace too small.

// K3: bf16 cache.
extern "C" int surya_gqa_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* lengths, const void* chunk_k, const void* chunk_v,
                                void* out, void* ws, int64_t ws_floats, void* done, int B, int H, int KVH,
                                int D, int S, int K, int step, int layer, float scale, void* stream) {
  if (D != HD || H != G * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<false>(q, k_cache, v_cache, nullptr, nullptr, lengths, chunk_k, chunk_v, out,
                              ws, ws_floats, done, B, KVH, S, K, step, layer, scale,
                              static_cast<cudaStream_t>(stream));
}

// K3q: int8 cache with bf16 per-row scales.
extern "C" int surya_gqa_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                                     const void* k_scale, const void* v_scale, const void* lengths,
                                     const void* chunk_k, const void* chunk_v, void* out, void* ws,
                                     int64_t ws_floats, void* done, int B, int H, int KVH, int D, int S, int K,
                                     int step, int layer, float scale, void* stream) {
  if (D != HD || H != G * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<true>(q, k_cache, v_cache, k_scale, v_scale, lengths, chunk_k, chunk_v, out,
                             ws, ws_floats, done, B, KVH, S, K, step, layer, scale,
                             static_cast<cudaStream_t>(stream));
}
