// One-token GQA decode attention over the slot KV cache (K3 and K3q): each
// (slot, kv head)'s valid rows in 16-row sub-tiles by TMA, through a ring
// of shared-memory slots of each warp, shared where the card has room
// among the CTAs of a thread block cluster, whose partials meet in
// distributed shared memory.
//
// Replaces the Pallas kernel surya_tpu/ops/decode_attn.py::gqa_decode_pallas
// (`_decode_kernel`): K3 with a bf16 cache, K3q with an int8 cache and one
// bf16 scale per cache row (`quantized=True`). Each (slot, kv head) attends
// its valid cache rows (< lengths[slot]) and the chunk buffer's columns
// 0..step as one softmax, for its query heads. Head dim and query heads a
// kv head are template arguments, built for the Qwen2-style recognition
// decoder's (128, 3) and LFM2-MoE's attention layers' (64, 4); K3q for
// (128, 3) only.
//
// What bounds it on an H100 is bytes: every valid K and V row is read once
// and serves 3 query heads, 4 flops per element and head, about 1.5 flops a
// byte in bf16 and 3 in int8, two orders below the tensor cores' ratio. The
// chunk buffer is bf16 in both kernels and is read in full up to `step` by
// every slot; on the pinned main path it is as large as the cache's valid
// rows. At the main path's short caches a call lasts a few microseconds
// with a cold L2, so what counts is how many dependent round trips to
// memory it makes, and how many waves of CTAs the card needs. Here:
//
// - Sub-tiles. A (slot, kv head)'s rows are cut into 16-row sub-tiles: the
//   chunk's columns 0..step first, then the cache's rows < lengths[slot]
//   (both read on the device). Only sub-tiles that hold a valid row exist,
//   so shared memory and copies go to rows that are read, not to the S + K
//   a slot could hold.
// - Cluster. A (slot, kv head) is a cluster of C CTAs along the grid's x
//   (C = 1 unless its shape allows more sub-tiles than two rounds of a
//   CTA's ring and the card holds all C times as many CTAs at once: few
//   slots, or a long cache; decode_cluster_size); CTA rank r takes
//   sub-tiles r, r + C,
//   ... The grid (C, kv heads, slots) depends only on the shapes, so there
//   is no host sync and a CUDA graph captures the call. Sub-tile 0 (chunk
//   column 0 <= step) always exists, so rank 0 always has rows: it merges.
// - TMA, each warp its own ring. Warp w of 2 takes its CTA's sub-tiles w,
//   w + 2, ... through the 3 of the CTA's 6 slots that are its own; its
//   lane 0 issues each sub-tile's K and V as tensor copies of 16 x 64 (bf16)
//   or 16 x 128 (int8) boxes of 3-D maps over [slabs, rows, D] (made on the
//   host at each call), which land 128-byte swizzled and complete on the
//   slot's mbarrier. A CTA's first 6 sub-tiles (96 rows) are in flight at
//   once, the next loads into a slot as soon as its warp is done with it,
//   no warp waits for the other until the merge, and no lane spends an
//   instruction on an address. A CTA is 64 threads and 48 KB, so an SM
//   holds 4 and the main path's 516 (slot, kv head)s run in one wave. Rows past a slab's end read as zeros; rows
//   past a sub-tile's valid count are masked, and their bf16 V rows (which
//   may hold anything) are zeroed before the products.
// - The products run on the tensor cores as mma.sync m16n8k16, transposed:
//   S^T = K Q^T with a sub-tile's 16 keys as the rows and the 3 query heads
//   as 3 of 8 columns, and O^T += V^T P^T with 16 dims as the rows, so 24
//   products a sub-tile do what 48 did with the heads as rows of a 16-row
//   tile (13 rows empty; a wgmma m64 tile would leave 61 of 64). An online
//   softmax in registers; P goes from the accumulator of S^T into the B
//   operand of P V by movmatrix, as two bf16 terms (its rounded value and
//   the rounding error; P rounded once to bf16 put K2 outside tolerance,
//   PERF.md). ldmatrix reads the swizzled rows without bank conflicts.
// - K3q: the row scales stay out of the products. An int8 value is exact in
//   bf16, so a sub-tile's int8 rows stay int8 in shared memory (half the
//   bytes of a bf16 sub-tile) and are widened in registers as ldmatrix
//   delivers them, by a magic-number add (no int-to-float instruction); a
//   lane gets 4 neighbouring dims of a key for K, whose k-steps the
//   query's fragment takes in that order, and 2 dims of 2 keys for V,
//   whose products land in an accumulator of their own with the dims in
//   that order. The logit is ks_r (q . k_int) and P V takes p_r vs_r. A
//   warp loads its rows' scales while the sub-tile's copy is in flight.
// - Merge. The 2 warps' states meet in shared memory (log-sum-exp). With
//   C = 1 the CTA writes the output. Otherwise every CTA writes its partial
//   (m, l, acc[3][128], fp32) into its place in rank 0's shared memory and
//   arrives on rank 0's mbarrier (release, cluster scope); rank 0 waits for
//   all of them and writes the output. A rank without sub-tiles writes
//   l = 0, which the merge skips; like every CTA it first waits on the
//   cluster barrier that publishes rank 0's mbarrier, then may exit, as no
//   CTA reads another's shared memory. No workspace in device memory, no
//   atomic count, no second read of the partials.

#include <cstddef>

#include "common.cuh"
#include "hopper.cuh"

using namespace surya;

namespace {

constexpr int HD = 128;         // head dim of the recognition decoder (1536 / 12)
constexpr int G = 3;            // query heads per kv head (12 / 4)
constexpr int LFM2_HD = 64;     // head dim of LFM2-MoE's attention layers (2048 / 32)
constexpr int LFM2_G = 4;       // their query heads per kv head (32 / 8)
constexpr int SUB = 16;         // rows of a sub-tile: one TMA box, what a warp computes at once
constexpr int NWARP = 2;        // warps of a CTA
constexpr int NT = NWARP * 32;
constexpr int SLOTS = 3;        // slots of a warp's ring
constexpr int NSLOT = NWARP * SLOTS;  // slots of a CTA: warp w owns slots w, w + NWARP, ...
constexpr int MIN_CTAS = 4;     // CTAs an SM must hold: 4 x 132 covers the main path's slots x kv heads
constexpr int SUBS_PER_CTA = 2 * NSLOT;  // sub-tiles a CTA may walk (two rounds of its ring) before a
                                         // (slot, kv head) takes a cluster
constexpr int MAX_CLUSTER = 8;  // the portable cluster size: CTAs of a (slot, kv head)
constexpr int BOX = SUB * 128;  // a 16-row box of 128-byte rows: half a bf16 sub-tile's K or V

// A sub-tile's K and V rows as the products read them: bf16, each row as
// 128-byte swizzled halves (dims 0..63, then 64..127 where D = 128); int8
// (K3q's cache rows), the first half of k and of v, 128 bytes a row.
struct alignas(1024) Slot {
  unsigned char k[2 * BOX];
  unsigned char v[2 * BOX];
};

// A CTA's partial: its own warps' in its shared memory, every rank's in
// rank 0's.
template <int D, int GROUP>
struct Partial {
  float acc[GROUP][D];
  float m[GROUP], l[GROUP];
};

struct Args {
  const bf16* q;
  const bf16* k_scale;
  const bf16* v_scale;
  const int* lengths;
  bf16* out;
  int B, KVH, S, K, step, layer;
  float scale_log2;
};

// Shared memory: NSLOT Slots, then (C > 1) C Partials, then the mbarriers;
// the warps' partials overlay the slots once the products are done.
template <int D, int GROUP>
__host__ __device__ inline int barriers_offset(int cluster) {
  return NSLOT * (int)sizeof(Slot) + (cluster > 1 ? cluster * (int)sizeof(Partial<D, GROUP>) : 0);
}

// Bytes i and j of w as signed int8 -> a bf16 pair (byte i the low half),
// exactly: the byte plus 128 becomes the low mantissa bits of 2^23, 2^23 +
// 128 is taken off, and as the result has at most 8 significant bits its
// bf16 is the top half of its fp32 bits.
template <int I, int J>
__device__ __forceinline__ uint32_t int8_pair(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | I)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Zero the bf16 V rows [rows, 16) of a sub-tile: past its valid rows they
// may hold anything, and P V multiplies them by 0.
template <int D>
__device__ __forceinline__ void zero_v_rows(Slot& st, int rows, int lane) {
  constexpr int UNITS = D / 8;  // 16-byte units of a row
  for (int u = rows * UNITS + lane; u < SUB * UNITS; u += 32) {
    const int r = u / UNITS, c = u % UNITS;  // the 16-byte unit c of row r, in its half
    *reinterpret_cast<uint4*>(st.v + (c / 8) * BOX + sw128(r, 16 * (c % 8))) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();
}

// The address of the 16-byte unit of (row, dim .. dim + 7) in a swizzled bf16 K or V of a slot.
__device__ __forceinline__ const bf16* unit(const unsigned char* t, int row, int dim) {
  return reinterpret_cast<const bf16*>(t + (dim / 64) * BOX + sw128(row, 2 * (dim % 64)));
}

// One warp's online-softmax state over its rows, in the transposed
// products' layout (lane g = lane / 4, t = lane % 4): the bf16 query pairs
// of head g (< G; the B operand of S^T = K Q^T) at dims 16kk + 2t and 16kk
// + 2t + 8, and (K3q) at dims 16kk + 4t and 16kk + 4t + 2 for the int8
// rows; for heads 2t and 2t + 1 the running max (log2 domain) and sum; and
// O^T, dims as rows: o[dn] holds dims 16dn + g and 16dn + g + 8 of heads
// 2t, 2t + 1 (heads G.. are zero columns), and (K3q) o8[dn] the int8 rows'
// share at dims 16dn + 2g and 16dn + 2g + 1.
template <int HD, bool QUANT>
struct WarpState {
  uint32_t qa[HD / 16][2];
  uint32_t qp[QUANT ? HD / 16 : 1][2];
  float m[2], l[2];
  float o[HD / 16][4];
  float o8[QUANT ? HD / 16 : 1][4];
};

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// One sub-tile in `st` (rows >= 1 valid rows), with the keys as the 16 rows
// of the tensor-core tiles and the heads as 8 columns (3 used): S^T = K Q^T
// (8 m16n8k16 products), the softmax of each head over the keys, and O^T
// += V^T P^T (16 products: P as two bf16 terms, its rounded value and the
// rounding error), P^T moved into the B operand by movmatrix.
//
// INT8_ROWS: the rows are int8, K in the first 2 KB of st.k and V of
// st.v, and ldmatrix reads them as 16-bit units, which are widened in
// registers (exactly): for S^T a lane gets 4 neighbouring dims of a key,
// so the dims of a k-step are taken in that order (the query's qp
// matches); for V^T it gets dims 2g and 2g + 1 of two keys, which become
// rows g and g + 8 of o8. Lane r < 16 holds row r's K scale in sc, lane 16
// + r its V scale, and the scales stay out of the products: ks_r (q .
// k_int), and P V takes p_r vs_r.
template <int HD, bool INT8_ROWS, bool QUANT>
__device__ __forceinline__ void attend_sub(WarpState<HD, QUANT>& w, const Slot& st, int rows, float sc,
                                           float scale_log2, int lane) {
  const int g = lane >> 2;
  // S^T: lane (g, t) gets keys g and g + 8 of heads 2t, 2t + 1; even and
  // odd k-steps accumulate apart, which halves the chain of dependent mma
  float s2[2][4] = {};
  if constexpr (INT8_ROWS) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {  // 32 dims: keys 0-7 and 8-15 of bytes 32c.. and 32c + 16..
      uint32_t r[4];
      ldmatrix_x4(r, reinterpret_cast<const bf16*>(st.k + sw128((lane & 7) + ((lane >> 3) & 1) * 8,
                                                                  32 * c + ((lane >> 4) & 1) * 16)));
      const uint32_t a0[4] = {int8_pair<0, 1>(r[0]), int8_pair<0, 1>(r[1]), int8_pair<2, 3>(r[0]),
                              int8_pair<2, 3>(r[1])};
      const uint32_t a1[4] = {int8_pair<0, 1>(r[2]), int8_pair<0, 1>(r[3]), int8_pair<2, 3>(r[2]),
                              int8_pair<2, 3>(r[3])};
      if constexpr (QUANT) {
        mma_16816(s2[0], a0, w.qp[2 * c][0], w.qp[2 * c][1]);
        mma_16816(s2[1], a1, w.qp[2 * c + 1][0], w.qp[2 * c + 1][1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, unit(st.k, lane & 15, kk * 16 + (lane >> 4) * 8));
      mma_16816(s2[kk & 1], a, w.qa[kk][0], w.qa[kk][1]);
    }
  }
  float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f};  // the scales of keys g and g + 8
  if constexpr (INT8_ROWS) {
    ks[0] = __shfl_sync(0xffffffffu, sc, g);
    ks[1] = __shfl_sync(0xffffffffu, sc, g + 8);
    vs[0] = __shfl_sync(0xffffffffu, sc, SUB + g);
    vs[1] = __shfl_sync(0xffffffffu, sc, SUB + g + 8);
  }
  // x[e]: key g + 8 (e >> 1) of head 2t + (e & 1)
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = g + 8 * (e >> 1);
    x[e] = key < rows ? (s2[0][e] + s2[1][e]) * scale_log2 * ks[e >> 1] : -__uint_as_float(0x7f800000u);
  }
  float corr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // head 2t + j: its 16 keys over the 8 lanes of the same t
    float mx = fmaxf(w.m[j], fmaxf(x[j], x[2 + j]));
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    corr[j] = exp2f(w.m[j] - mx);  // 0 at the warp's first sub-tile (w.m == NEG_INF)
    x[j] = exp2f(x[j] - mx);  // 0 past the last valid row
    x[2 + j] = exp2f(x[2 + j] - mx);
    float sum = x[j] + x[2 + j];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    w.l[j] = w.l[j] * corr[j] + sum;
    w.m[j] = mx;
  }
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    w.o[dn][0] *= corr[0];
    w.o[dn][1] *= corr[1];
    w.o[dn][2] *= corr[0];
    w.o[dn][3] *= corr[1];
    if constexpr (QUANT) {
      w.o8[dn][0] *= corr[0];
      w.o8[dn][1] *= corr[1];
      w.o8[dn][2] *= corr[0];
      w.o8[dn][3] *= corr[1];
    }
  }
  // P^T as the B operand (keys 2t, 2t + 1 and 2t + 8, 2t + 9 of head g):
  // the transposes of the 8 x 8 blocks of keys 0..7 and 8..15
  uint32_t hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t h, l;
    split_bf16x2(x[2 * r] * vs[r], x[2 * r + 1] * vs[r], h, l);  // P V takes p_r vs_r
    hi[r] = movmatrix_trans(h);
    lo[r] = movmatrix_trans(l);
  }
  if constexpr (INT8_ROWS) {
    // O^T += V^T P^T, 32 dims a load: lane (g, t) gets dims 2g, 2g + 1 of
    // keys 2t, 2t + 1 (bytes 0, 1 and 2, 3), the keys 0-7 and 8-15 of
    // 16-byte units 2dp and 2dp + 1
#pragma unroll
    for (int dp = 0; dp < HD / 32; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(st.v + sw128((lane & 7) + ((lane >> 3) & 1) * 8,
                                                                        16 * (2 * dp + ((lane >> 4) & 1)))));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {int8_pair<0, 2>(r[2 * h]), int8_pair<1, 3>(r[2 * h]), int8_pair<0, 2>(r[2 * h + 1]),
                               int8_pair<1, 3>(r[2 * h + 1])};
        if constexpr (QUANT) {
          mma_16816(w.o8[2 * dp + h], a, hi[0], hi[1]);
          mma_16816(w.o8[2 * dp + h], a, lo[0], lo[1]);
        }
      }
    }
  } else {
    // O^T += V^T P^T, 16 dims a product: V^T by ldmatrix.trans of V's rows
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, unit(st.v, (lane & 7) + ((lane >> 4) & 1) * 8, dn * 16 + ((lane >> 3) & 1) * 8));
      mma_16816(w.o[dn], a, hi[0], hi[1]);
      mma_16816(w.o[dn], a, lo[0], lo[1]);
    }
  }
}

// q: [B, H, D]; the caches [layers, B, KVH, S, D] (bf16, or int8 with
// k_scale/v_scale [layers, B, KVH, S] bf16 when QUANT) and chunk buffers
// [layers, B, KVH, K, D] bf16 through their maps; lengths: [B] int32;
// out: [B, H, D]. Grid (C, KVH, B), clusters of C along x: CTA (r, kh, b)
// takes sub-tiles r, r + C, ... of slot b's kv head kh (see the file
// header). The kernel keeps the name and template arguments of the one it
// replaced, which profile_smoke.py matches.
template <int D, int GROUP, bool QUANT>
__global__ void __launch_bounds__(NT, MIN_CTAS) gqa_decode_kernel(const __grid_constant__ CUtensorMap kc_map,
                                                        const __grid_constant__ CUtensorMap vc_map,
                                                        const __grid_constant__ CUtensorMap ck_map,
                                                        const __grid_constant__ CUtensorMap cv_map, const Args a) {
  static_assert(D % 64 == 0 && GROUP <= 8 && (!QUANT || D == 128), "K3q reads 128-byte int8 rows");
  constexpr int HD = D, G = GROUP;
  using Part = Partial<D, GROUP>;
  extern __shared__ __align__(1024) unsigned char decode_smem[];
  const int C = gridDim.x;
  Slot* slots = reinterpret_cast<Slot*>(decode_smem);
  Part* parts = reinterpret_cast<Part*>(decode_smem + NSLOT * sizeof(Slot));
  uint64_t* full = reinterpret_cast<uint64_t*>(decode_smem + barriers_offset<D, GROUP>(C));
  uint64_t* merged = full + NSLOT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(a.lengths[b], 0), a.S);
  const int n_chunk = a.step / SUB + 1, n_all = n_chunk + (len + SUB - 1) / SUB;
  const int n_mine = rank < n_all ? (n_all - rank + C - 1) / C : 0;  // sub-tiles rank, rank + C, ...
  const int slab = (a.layer * a.B + b) * a.KVH + kh;
  // the CTA's sub-tile k: chunk sub-tile x, or cache sub-tile x, and its valid rows
  auto sub_of = [&](int k, bool& chunk, int& x, int& rows) {
    const int s = rank + k * C;
    chunk = s < n_chunk;
    x = chunk ? s : s - n_chunk;
    rows = min(SUB, (chunk ? a.step + 1 : len) - x * SUB);
  };
  auto issue = [&](int k) {  // sub-tile k into slot k % NSLOT
    bool chunk;
    int x, rows;
    sub_of(k, chunk, x, rows);
    Slot& dst = slots[k % NSLOT];
    uint64_t* bar = &full[k % NSLOT];
    if (QUANT && !chunk) {  // int8: one 16 x 128-byte box each of K and V
      mbar_expect_tx(bar, 2 * BOX);
      tma_load_3d(dst.k, &kc_map, bar, 0, x * SUB, slab);
      tma_load_3d(dst.v, &vc_map, bar, 0, x * SUB, slab);
    } else {
      const CUtensorMap* km = chunk ? &ck_map : &kc_map;
      const CUtensorMap* vm = chunk ? &cv_map : &vc_map;
      mbar_expect_tx(bar, 2 * (D / 64) * BOX);
      for (int h = 0; h < D / 64; ++h) {
        tma_load_3d(dst.k + h * BOX, km, bar, 64 * h, x * SUB, slab);
        tma_load_3d(dst.v + h * BOX, vm, bar, 64 * h, x * SUB, slab);
      }
    }
  };
  if (tid == 0) {
    if (smem_addr(decode_smem) & 1023) __trap();  // the swizzled slots need 1024-byte alignment
    for (int s = 0; s < NSLOT; ++s) mbar_init(&full[s], 1);
    if (C > 1) mbar_init(merged, C * NT);
    fence_mbar_init();
  }
  __syncthreads();
  if (C > 1) cluster_arrive();  // publishes rank 0's `merged`; waited for before the first remote arrive
  // each warp's lane 0 starts its first SLOTS sub-tiles
  if (lane == 0)
    for (int k = warp; k < min(n_mine, NSLOT); k += NWARP) issue(k);

  WarpState<D, QUANT> w;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    w.o[dn][0] = w.o[dn][1] = w.o[dn][2] = w.o[dn][3] = 0.f;
    if constexpr (QUANT) w.o8[dn][0] = w.o8[dn][1] = w.o8[dn][2] = w.o8[dn][3] = 0.f;
  }
  const int g = lane >> 2, t = lane & 3;
  if (warp < n_mine) {
    const unsigned* qrow =
        reinterpret_cast<const unsigned*>(a.q + ((int64_t)(b * a.KVH + kh) * G + min(g, G - 1)) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // 32-bit words: 2 dims each
      w.qa[kk][0] = g < G ? __ldg(qrow + kk * 8 + t) : 0u;
      w.qa[kk][1] = g < G ? __ldg(qrow + kk * 8 + t + 4) : 0u;
      if constexpr (QUANT) {
        w.qp[kk][0] = g < G ? __ldg(qrow + kk * 8 + 2 * t) : 0u;
        w.qp[kk][1] = g < G ? __ldg(qrow + kk * 8 + 2 * t + 1) : 0u;
      }
    }
  }
  for (int k = warp, i = 0; k < n_mine; k += NWARP, ++i) {
    bool chunk;
    int x, rows;
    sub_of(k, chunk, x, rows);
    Slot& st = slots[k % NSLOT];
    if (QUANT && !chunk) {
      // lane r < 16 row r's K scale, lane 16 + r its V scale, loaded under the copy
      const int r = lane % SUB;
      const int64_t row = (int64_t)slab * a.S + x * SUB + r;
      const float sc = r < rows ? __bfloat162float((lane < SUB ? a.k_scale : a.v_scale)[row]) : 0.f;
      mbar_wait(&full[k % NSLOT], (i / SLOTS) & 1);
      attend_sub<D, true, QUANT>(w, st, rows, sc, a.scale_log2, lane);  // int8 rows past `rows`: finite, p = 0
    } else {
      mbar_wait(&full[k % NSLOT], (i / SLOTS) & 1);
      if (rows < SUB) zero_v_rows<D>(st, rows, lane);
      attend_sub<D, false, QUANT>(w, st, rows, 0.f, a.scale_log2, lane);
    }
    __syncwarp();  // the slot is free
    if (lane == 0 && k + NSLOT < n_mine) {
      fence_proxy_async();  // the warp wrote it (zeroed rows); TMA writes it next
      issue(k + NSLOT);
    }
  }

  // the warps' states meet in shared memory (over the slots), thread t
  // combining dims t and t + NT of each head
  __syncthreads();
  Part* wp = reinterpret_cast<Part*>(slots);
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // lane (g, t): dims 16dn + g (+ 8) of head 2t + j
    const int h = 2 * t + j;
    if (h < G) {
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        wp[warp].acc[h][16 * dn + g] = w.o[dn][j];
        wp[warp].acc[h][16 * dn + g + 8] = w.o[dn][2 + j];
      }
      if (g == 0) {
        wp[warp].m[h] = w.m[j];
        wp[warp].l[h] = w.l[j];
      }
    }
  }
  if constexpr (QUANT) {  // the int8 rows' share: dims 16dn + 2g (+ 1)
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = 2 * t + j;
      if (h < G) {
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          wp[warp].acc[h][16 * dn + 2 * g] += w.o8[dn][j];
          wp[warp].acc[h][16 * dn + 2 * g + 1] += w.o8[dn][2 + j];
        }
      }
    }
  }
  __syncthreads();
  constexpr int PER = HD / NT;  // dims of a thread
  float M[G], L[G], A[G][PER];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    M[h] = wp[0].m[h];
#pragma unroll
    for (int v = 1; v < NWARP; ++v) M[h] = fmaxf(M[h], wp[v].m[h]);
    L[h] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) A[h][e] = 0.f;
#pragma unroll
    for (int v = 0; v < NWARP; ++v) {
      const float c = exp2f(wp[v].m[h] - M[h]);  // 1 for each warp without rows: its l and acc are 0
      L[h] = fmaf(wp[v].l[h], c, L[h]);
#pragma unroll
      for (int e = 0; e < PER; ++e) A[h][e] = fmaf(wp[v].acc[h][tid + NT * e], c, A[h][e]);
    }
  }
  bf16* out = a.out + (int64_t)(b * a.KVH + kh) * G * HD + tid;
  if (C == 1) {  // sub-tile 0 is this CTA's, so L > 0
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < PER; ++e) out[h * HD + NT * e] = __float2bfloat16(A[h][e] / L[h]);
    return;
  }
  cluster_wait();
  const uint32_t mine = smem_addr(&parts[rank]);
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < PER; ++e)
      st_cluster(map_to_rank(mine + (uint32_t)((h * HD + tid + NT * e) * sizeof(float)), 0), A[h][e]);
    if (tid == h) {
      st_cluster(map_to_rank(mine + (uint32_t)(offsetof(Part, m) + h * sizeof(float)), 0), M[h]);
      st_cluster(map_to_rank(mine + (uint32_t)(offsetof(Part, l) + h * sizeof(float)), 0), L[h]);
    }
  }
  mbar_arrive_remote(map_to_rank(smem_addr(merged), 0));
  if (rank != 0) return;

  // rank 0: every rank's partial has arrived; those with l = 0 had no sub-tiles
  mbar_wait_cluster(merged, 0);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float mx = NEG_INF;
    for (int r = 0; r < C; ++r)
      if (parts[r].l[h] > 0.f) mx = fmaxf(mx, parts[r].m[h]);
    float sum = 0.f, acc[PER] = {};
    for (int r = 0; r < C; ++r) {
      if (parts[r].l[h] > 0.f) {
        const float c = exp2f(parts[r].m[h] - mx);
        sum = fmaf(parts[r].l[h], c, sum);
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[e] = fmaf(parts[r].acc[h][tid + NT * e], c, acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) out[h * HD + NT * e] = __float2bfloat16(acc[e] / sum);  // rank 0 has rows: sum > 0
  }
}

template <int D, int GROUP>
int decode_smem_bytes(int cluster) {
  return barriers_offset<D, GROUP>(cluster) + (NSLOT + 1) * (int)sizeof(uint64_t);
}

// CTAs an SM holds at once with clusters of c: what its shared memory
// allows, with the bytes the card reserves for each CTA, and at most
// MIN_CTAS (what the registers are sized for). On the H100's 228 KB: 4 up
// to c = 5, 3 above.
template <int D, int GROUP>
int decode_ctas_per_sm(int c) {
  int dev = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) != cudaSuccess)
    return 1;
  return max(1, min(MIN_CTAS, per_sm / (decode_smem_bytes<D, GROUP>(c) + reserved)));
}

// CTAs of a (slot, kv head): enough that none walks more than
// SUBS_PER_CTA of the sub-tiles S cache rows and K chunk columns can make,
// as long as every CTA of the launch fits the card at once, and at most
// MAX_CLUSTER (PERF.md has the timings the constants come from).
template <int D, int GROUP>
int decode_cluster_size(int B, int KVH, int S, int K) {
  const int subs = (S + SUB - 1) / SUB + (K + SUB - 1) / SUB;
  const int64_t pairs = (int64_t)B * KVH, sms = sm_count();
  int c = min(MAX_CLUSTER, (subs + SUBS_PER_CTA - 1) / SUBS_PER_CTA);
  while (c > 1 && c * pairs > decode_ctas_per_sm<D, GROUP>(c) * sms) --c;
  return c;
}

template <int D, int GROUP, bool QUANT>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const void* k_scale, const void* v_scale,
                  const void* lengths, const void* chunk_k, const void* chunk_v, void* out, int layers, int B,
                  int KVH, int S, int K, int step, int layer, float scale, cudaStream_t stream) {
  if (KVH < 1 || B < 1 || S < 1 || K < 1 || layers < 1) return (int)cudaErrorInvalidValue;
  const int C = decode_cluster_size<D, GROUP>(B, KVH, S, K);
  // [layers * B * KVH slabs, rows, D] as 3-D maps, innermost first; boxes of
  // 16 rows by 128 bytes (64 bf16 dims, or all 128 int8 dims)
  const cuuint64_t slabs = (cuuint64_t)layers * B * KVH;
  const cuuint64_t esize = QUANT ? 1 : 2;
  const cuuint64_t cache_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, slabs};
  const cuuint64_t cache_strides[2] = {D * esize, (cuuint64_t)S * D * esize};
  const cuuint64_t chunk_dims[3] = {(cuuint64_t)D, (cuuint64_t)K, slabs};
  const cuuint64_t chunk_strides[2] = {D * 2, (cuuint64_t)K * D * 2};
  const cuuint32_t cache_box[3] = {(cuuint32_t)(128 / esize), SUB, 1}, chunk_box[3] = {64, SUB, 1};
  const CUtensorMapDataType cache_type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap kc, vc, ck, cv;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&kc, cache_type, 3, k_cache, cache_dims, cache_strides, cache_box, sw) ||
      !make_map(&vc, cache_type, 3, v_cache, cache_dims, cache_strides, cache_box, sw) ||
      !make_map(&ck, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, chunk_k, chunk_dims, chunk_strides, chunk_box, sw) ||
      !make_map(&cv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, chunk_v, chunk_dims, chunk_strides, chunk_box, sw))
    return (int)cudaErrorInvalidValue;
  const auto kernel = gqa_decode_kernel<D, GROUP, QUANT>;
  const int smem = decode_smem_bytes<D, GROUP>(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{static_cast<const bf16*>(q), static_cast<const bf16*>(k_scale), static_cast<const bf16*>(v_scale),
                  static_cast<const int*>(lengths), static_cast<bf16*>(out), B, KVH, S, K, step, layer,
                  scale * LOG2E};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, KVH, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, kc, vc, ck, cv, args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The wrapper (ops/decode_attn.py) has checked shapes, dtypes, contiguity and
// 0 <= step < K, 0 <= layer < layers. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it was not built for (K3:
// head dim 128 with 3 query heads per kv head, or 64 with 4; K3q: 128 with 3)
// or a tensor the driver will not map.

// K3: bf16 cache.
extern "C" int surya_gqa_decode(const void* q, const void* k_cache, const void* v_cache, const void* lengths,
                                const void* chunk_k, const void* chunk_v, void* out, int layers, int B, int H,
                                int KVH, int D, int S, int K, int step, int layer, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == HD && H == G * KVH)
    return launch_decode<HD, G, false>(q, k_cache, v_cache, nullptr, nullptr, lengths, chunk_k, chunk_v, out, layers,
                                       B, KVH, S, K, step, layer, scale, st);
  if (D == LFM2_HD && H == LFM2_G * KVH)
    return launch_decode<LFM2_HD, LFM2_G, false>(q, k_cache, v_cache, nullptr, nullptr, lengths, chunk_k, chunk_v,
                                                 out, layers, B, KVH, S, K, step, layer, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K3q: int8 cache with bf16 per-row scales.
extern "C" int surya_gqa_decode_int8(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                                     const void* v_scale, const void* lengths, const void* chunk_k,
                                     const void* chunk_v, void* out, int layers, int B, int H, int KVH, int D, int S,
                                     int K, int step, int layer, float scale, void* stream) {
  if (D != HD || H != G * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<HD, G, true>(q, k_cache, v_cache, k_scale, v_scale, lengths, chunk_k, chunk_v, out, layers, B, KVH,
                             S, K, step, layer, scale, static_cast<cudaStream_t>(stream));
}

// How K3 and K3q launch at these shapes, at head dim 128 and 3 query heads
// a kv head, into cfg: CTAs, cluster size, sub-tile slots, dynamic shared
// memory and threads of a CTA, and CTAs an SM holds at once. Returns 0.
extern "C" int surya_decode_config(int B, int KVH, int S, int K, int* cfg) {
  const int C = decode_cluster_size<HD, G>(B, KVH, S, K);
  const int out[6] = {C * KVH * B, C, NSLOT, decode_smem_bytes<HD, G>(C), NT, decode_ctas_per_sm<HD, G>(C)};
  for (int i = 0; i < 6; ++i) cfg[i] = out[i];
  return 0;
}
