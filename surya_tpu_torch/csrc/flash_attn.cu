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
// K1 runs on Hopper's own instructions too:
// - Persistent: one CTA an SM walks items, an item a 128-row plan chunk
//   (one kv_starts entry, so one window) of one head. Two consumer
//   warpgroups of 64 rows and a producer warpgroup, which gives its
//   registers to them by setmaxnreg.
// - Spans: the producer's planner warp finds each row's valid keys, its
//   group's run clipped to the window (two integers a row, from the group
//   ids around the chunk; no group id is read again), and each warpgroup's
//   span, an item or two ahead; the producer walks the union of the two
//   spans, and a warpgroup computes only the tiles that meet its own.
// - TMA: a row of D = 80 bf16 is 160 bytes, which no swizzle spans, so
//   every 64-row tile is two boxes of 3-D tensor maps over the strided
//   [S, H, D] views (made on the host at each call, kernel parameters):
//   dims 0..63 with the 128-byte swizzle and dims 64..79 with the 32-byte
//   swizzle. The producer's first lane issues every copy, into two Q
//   buffers and a ring of 8 K/V stages that signal mbarriers.
// - wgmma on m64 tiles. S = Q K^T, both K-major from shared memory: four
//   k16 steps over the 128-byte box and one over the 32-byte box, m64n64.
//   P V with P from registers and V MN-major (the descriptors transpose):
//   m64n64 over the 128-byte box and m64n16 over the 32-byte box. Tile t's
//   Q K^T is issued with tile t - 1's P V.
// - The output is written over the item's Q tiles in the two swizzled
//   layouts and leaves by TMA store.
// K1 moves more than its 336 MB: a K/V tile is read from L2 once for each
// item whose union holds it, and at 64-key tiles a warpgroup computes
// about 1.3 (full-attention blocks) to 3.5 (windowed) times the plan's
// query-key pairs, with P V twice over (PERF.md has what each costs).
//
// K2 runs on Hopper's own instructions, at head dim D and G query heads a
// kv head, both template arguments: built for the Qwen2-style recognition
// decoder's (128, 3) and LFM2-MoE's attention layers' (64, 4).
// - Work items of (batch row, kv head, run of row blocks): a CTA serves the
//   kv head's G query heads from each K/V tile it loads, so a kv head's K
//   and V come from device memory once for all G.
// - TMA: the producer's first lane issues every copy, 64 x 64 boxes of
//   4-D tensor maps over [B, L, heads, D] (made on the host at each call,
//   kernel parameters, so a CUDA graph keeps them), with 128-byte swizzle,
//   into a ring of K/V stages and per-head Q buffers that signal mbarriers.
//   Rows past L read as zeros and stores past L are dropped, so no lane
//   spends an instruction on an address or a bound.
// - wgmma on m64 tiles. S = Q K^T with both operands K-major from shared
//   memory (a row is D / 64 128-byte swizzled halves, k16 slice kk at
//   byte 32 (kk % 4) of half kk / 4); P V with P from registers and V
//   MN-major from shared memory (the descriptor transposes), one m64n128
//   product over both halves of D = 128, one m64n64 at D = 64.
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

constexpr int PLAN_CHUNK = 128;  // K1: query rows per kv_starts entry (FULL_ATTN_Q_CHUNK): an item's rows
constexpr int SEG_D = 80;        // K1: head dim of the recognition encoder (1280 / 16)
constexpr int SEG_BK = 64;       // K1: keys of a K/V tile (wgmma's n64)
constexpr int SEG_STAGES = 8;    // K1: K/V tiles in the ring
constexpr int SEG_QBUF = 2;      // K1: Q tile pairs (an item's), so the next item's load under this one's products
constexpr int SEG_WG = PLAN_CHUNK / 64;  // K1: consumer warpgroups, 64 query rows each (wgmma's m64)
// the consumers and a producer warpgroup, which gives its registers to the
// consumers by setmaxnreg (ptxas gives a CTA of 384 threads 168 each)
constexpr int SEG_THREADS = SEG_WG * 128 + 128;
constexpr int SEG_PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr int SEG_CONSUMER_REGS = 232;
// a 64-row tile of D = 80 bf16 is two boxes: dims 0..63 with the 128-byte
// swizzle (8192 bytes), dims 64..79 with the 32-byte swizzle (2048 bytes)
constexpr int SEG_A_ELEMS = 64 * 64;
constexpr int SEG_B_ELEMS = 64 * 16;
constexpr int SEG_TILE_BYTES = (SEG_A_ELEMS + SEG_B_ELEMS) * 2;

struct SegSmem {  // at a 1024-byte boundary: every 128-byte-swizzled box on one, every 32-byte one on 256
  bf16 q_a[SEG_QBUF][SEG_WG][SEG_A_ELEMS], k_a[SEG_STAGES][SEG_A_ELEMS], v_a[SEG_STAGES][SEG_A_ELEMS];
  bf16 q_b[SEG_QBUF][SEG_WG][SEG_B_ELEMS], k_b[SEG_STAGES][SEG_B_ELEMS], v_b[SEG_STAGES][SEG_B_ELEMS];
  uint64_t k_full[SEG_STAGES], v_full[SEG_STAGES], kv_empty[SEG_STAGES];
  uint64_t q_full[SEG_QBUF], q_empty[SEG_QBUF], item_full[2], item_empty[2];
  int key_lo[2][PLAN_CHUNK], key_hi[2][PLAN_CHUNK];  // each row's valid keys, an item slot each
  int2 span[2][SEG_WG];                              // each warpgroup's span of keys
};

__device__ __forceinline__ float inf_f() { return __uint_as_float(0x7f800000u); }

// The first key of the group run holding row r, or kv0 if that is later:
// the warp scans seg down from r - 1, 128 keys a step (4 loads a lane, then
// a ballot each), so a step costs one round trip to L2.
__device__ __forceinline__ int run_start(const int* __restrict__ seg, int r, int kv0, int lane) {
  if (r <= kv0) return kv0;
  const int id = seg[r];
  for (int base = r; base > kv0; base -= 128) {  // keys base - 1, base - 2, ...
    int got[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base - 1 - 32 * u - lane;
      got[u] = j >= kv0 ? seg[j] : id;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // the lowest lane of the lowest u is the nearest key
      const unsigned m = __ballot_sync(0xffffffffu, got[u] != id);
      if (m) return base - 32 * u - (__ffs(m) - 1);
    }
  }
  return kv0;
}

// The end of the group run holding row r, or kv1 if that is earlier; the
// same scan upwards from r + 1.
__device__ __forceinline__ int run_end(const int* __restrict__ seg, int r, int kv1, int lane) {
  if (r + 1 >= kv1) return kv1;
  const int id = seg[r];
  for (int base = r + 1; base < kv1; base += 128) {  // keys base, base + 1, ...
    int got[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + 32 * u + lane;
      got[u] = j < kv1 ? seg[j] : id;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, got[u] != id);
      if (m) return base + 32 * u + (__ffs(m) - 1);
    }
  }
  return kv1;
}

// 2^x, as the special function unit gives it (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one tile, issued and committed: both K-major, four k16 steps
// at byte 32 kk of the 128-byte rows (qa, ka), the fifth the 32-byte rows
__device__ __forceinline__ void seg_qk(float (&s)[32], uint32_t qa, uint32_t qb, uint32_t ka, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_64x64_ss(s, sw128_desc(qa + 32 * kk, 16, 1024), sw128_desc(ka + 32 * kk, 16, 1024), kk);
  wgmma_64x64_ss(s, sw32_desc(qb, 16, 256), sw32_desc(kb, 16, 256), 1);
  wgmma_commit();
}

// The online softmax of one tile's logits s, in place: into the log2
// domain, key kt + c valid for row h in [lo_h, hi_h), else NEG_INF, or -inf
// (weight 0) at or past `hi`, the union's end; the rows' running max m and
// sum l updated, corr the factor the accumulator takes for the new max.
// Rows r + 8h of the warpgroup: elements 4n + 2h, 4n + 2h + 1.
__device__ __forceinline__ void seg_softmax(float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2], int kt,
                                            int lo0, int hi0, int lo1, int hi1, int hi, int quad, float scale_log2) {
  if (kt >= max(lo0, lo1) && kt + SEG_BK <= min(hi0, hi1)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = kt + 8 * (e >> 2) + 2 * quad + (e & 1);
      const bool valid = (e & 2) ? key >= lo1 && key < hi1 : key >= lo0 && key < hi0;
      s[e] = valid ? s[e] * scale_log2 : (key < hi ? NEG_INF : -inf_f());
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) mx = fmaxf(mx, fmaxf(s[4 * nn + 2 * h], s[4 * nn + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[h] = ex2(m[h] - mx);
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      s[4 * nn + 2 * h] = ex2(s[4 * nn + 2 * h] - mx);
      s[4 * nn + 2 * h + 1] = ex2(s[4 * nn + 2 * h + 1] - mx);
      sum += s[4 * nn + 2 * h] + s[4 * nn + 2 * h + 1];
    }
    l[h] = l[h] * corr[h] + sum;
  }
}

// P as the A operand of P V: the accumulator layout of key blocks 2kk and
// 2kk + 1 is the A layout of k16 step kk; each value as its bf16 value and
// its rounding error
__device__ __forceinline__ void seg_split(const float (&p)[32], uint32_t (&phi)[4][4], uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int a = 0; a < 4; ++a) split_bf16x2(p[8 * kk + 2 * a], p[8 * kk + 2 * a + 1], phi[kk][a], plo[kk][a]);
  }
}

// O += P V of one tile, issued and committed: V MN-major, 16 keys a step, an
// m64n64 product over the 128-byte box (2048 bytes a step, 8-key groups 1024
// apart) and an m64n16 one over the 32-byte box (512 bytes a step, groups
// 256 apart), each for both terms of P
__device__ __forceinline__ void seg_pv(float (&oa)[32], float (&ob)[8], const uint32_t (&phi)[4][4],
                                       const uint32_t (&plo)[4][4], uint32_t va, uint32_t vb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(va + kk * 2048, 8192, 1024), db = sw32_desc(vb + kk * 512, 2048, 256);
    wgmma_64x64_rs_tb(oa, phi[kk], da);
    wgmma_64x64_rs_tb(oa, plo[kk], da);
    wgmma_64x16_rs_tb(ob, phi[kk], db);
    wgmma_64x16_rs_tb(ob, plo[kk], db);
  }
  wgmma_commit();
}

// K1. q/k/v: [S, H, D] (any row stride; heads D apart) and out ([S, H, D]
// contiguous) through tensor maps: for each, one with 64-dim boxes and the
// 128-byte swizzle (`*_a`) and one with 16-dim boxes and the 32-byte
// swizzle (`*_b`), both one head and 64 rows. Query rows of plan chunk c
// (128 rows) attend keys [kv0, kv0 + kv_range), kv0 = kv_starts[c] clamped
// like a dynamic slice, masked by seg[query] == seg[key].
//
// The work is items, (plan chunk, head), numbered chunk-first so that the
// items in flight at once share their windows' tiles in L2; CTA x takes
// items x, x + gridDim.x, ... (persistent, one CTA an SM). Warpgroups 0 and
// 1 compute an item's rows 0..63 and 64..127; warpgroup 2, the producer,
// gives its registers to them by setmaxnreg. Its warp 9, the planner, finds
// each row's valid keys: the run of its group (each group one contiguous
// run of slots; plan_layout refuses a plan where it is not) clipped to the
// window, [key_lo, key_hi) (empty for a row whose group the window misses),
// from the changes of group id among the item's rows and a scan outwards
// from each end. A warpgroup's span is the union of its rows' intervals
// (their runs follow each other, so the first row's start to the last
// row's end), or the whole window where its rows do not lie inside it (a
// row with no valid key averages the window, as in the plain version);
// tests/test_torch_flash_tiles.py holds the same rule in plain torch. The
// planner writes both into one of two item slots, up to two items ahead;
// the first lane of warp 8 takes each item from its slot, loads its Q tiles
// into one of two Q buffers and walks the union of the two spans in 64-key
// tiles through the ring. A warpgroup computes the tiles that meet its own
// span, and frees the others once they have landed. A key of a computed
// tile is valid for a row inside the row's interval; else it takes the
// NEG_INF sentinel, and past the union's end weight 0 (those rows belong to
// other groups, or are TMA's zeros past S). A warpgroup issues tile t's
// Q K^T together with tile t - 1's P V, and masks and scales tile t's
// logits while that product runs. An item's output is written over its Q
// tiles and leaves by TMA store, whose read of the buffer the warpgroup's
// first thread awaits after the next item's first tile before it frees
// the buffer (q_empty), so the item after that can load its Q tiles there.
//
// Bound and design: see the file header. The spans are what makes K1 cheap:
// a whole-page line crop is about 80 to 280 patches and a window group 16,
// so most 64-key tiles of a 1024-key window hold no key of a warpgroup's
// groups. The spans are found in the kernel, under the products of the
// items before: as a chain of torch operations the same computation took
// 0.7 to 1.9 times as long as the kernel itself (PERF.md).
__global__ void __launch_bounds__(SEG_THREADS, 1)
    segmented_attention_kernel(const __grid_constant__ CUtensorMap q_a_map, const __grid_constant__ CUtensorMap q_b_map,
                               const __grid_constant__ CUtensorMap k_a_map, const __grid_constant__ CUtensorMap k_b_map,
                               const __grid_constant__ CUtensorMap v_a_map, const __grid_constant__ CUtensorMap v_b_map,
                               const __grid_constant__ CUtensorMap o_a_map, const __grid_constant__ CUtensorMap o_b_map,
                               const int* __restrict__ seg, const int* __restrict__ kv_starts, int S, int H,
                               int kv_range, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<SegSmem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_chunks = S / PLAN_CHUNK, n_items = n_chunks * H;

  if (tid == 0) {
    for (int s = 0; s < SEG_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.kv_empty[s], SEG_WG * 4);
    }
    for (int u = 0; u < SEG_QBUF; ++u) {
      mbar_init(&sm.q_full[u], 1);
      mbar_init(&sm.q_empty[u], SEG_WG);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.item_full[b], 32);
      mbar_init(&sm.item_empty[b], SEG_WG * 4 + 1);  // the consumers' warps and the copying lane
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= SEG_WG * 4) {  // the producer warpgroup: a planner warp and a copying lane
    setmaxnreg_dec<SEG_PRODUCER_REGS>();
    if (warp == SEG_WG * 4 + 1) {  // the planner: each item's rows' intervals and spans into an item slot
      int j = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
        const int b = j & 1, c = item % n_chunks, q0 = c * PLAN_CHUNK;
        // every load at once: the window's start, the rows' group ids (rows
        // 32u + lane, u < 4) and those of the 128 keys on either side
        const int start = kv_starts[c];
        int id[4], below[4], above[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jb = q0 - 1 - 32 * u - lane, ja = q0 + PLAN_CHUNK + 32 * u + lane;
          id[u] = seg[q0 + 32 * u + lane];
          below[u] = jb >= 0 ? seg[jb] : 0;
          above[u] = ja < S ? seg[ja] : 0;
        }
        const int kv0 = max(0, min(start, S - kv_range)), kv1 = kv0 + kv_range;
        const int first = __shfl_sync(0xffffffffu, id[0], 0), last = __shfl_sync(0xffffffffu, id[3], 31);
        // the start of row 0's run and the end of row 127's, clipped to the
        // window; the scans go on past those 128 keys only where a run does
        int a = kv0, e = kv1, at = -1;
        if (q0 > kv0) {
#pragma unroll
          for (int u = 3; u >= 0; --u) {  // the lowest lane of the lowest u is the nearest key
            const unsigned m = __ballot_sync(0xffffffffu, q0 - 1 - 32 * u - lane >= kv0 && below[u] != first);
            if (m) at = q0 - 32 * u - (__ffs(m) - 1);
          }
          a = at >= 0 ? at : (q0 - 128 > kv0 ? run_start(seg, q0 - 128, kv0, lane) : kv0);
        }
        at = -1;
        if (q0 + PLAN_CHUNK < kv1) {
#pragma unroll
          for (int u = 3; u >= 0; --u) {
            const unsigned m = __ballot_sync(0xffffffffu, q0 + PLAN_CHUNK + 32 * u + lane < kv1 && above[u] != last);
            if (m) at = q0 + PLAN_CHUNK + 32 * u + (__ffs(m) - 1);
          }
          e = at >= 0 ? at : (q0 + 2 * PLAN_CHUNK < kv1 ? run_end(seg, q0 + 2 * PLAN_CHUNK - 1, kv1, lane) : kv1);
        }
        unsigned starts[4];  // where a group run starts among the rows, 32 rows a mask
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int up = __shfl_up_sync(0xffffffffu, id[u], 1);
          const int prev = __shfl_sync(0xffffffffu, id[u > 0 ? u - 1 : 0], 31);
          starts[u] = __ballot_sync(0xffffffffu, (lane > 0 ? up : prev) != id[u] && (u > 0 || lane > 0));
        }
        int key_lo[4], key_hi[4];
        const unsigned upto = (2u << lane) - 1;  // lanes 0..lane
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int rs = a, re = e;
#pragma unroll
          for (int x = 0; x <= u; ++x) {  // the last run start at or before the row
            const unsigned m = starts[x] & (x == u ? upto : ~0u);
            if (m) rs = q0 + 32 * x + 31 - __clz(m);
          }
#pragma unroll
          for (int x = 3; x >= u; --x) {  // the first after it
            const unsigned m = starts[x] & (x == u ? ~upto : ~0u);
            if (m) re = q0 + 32 * x + __ffs(m) - 1;
          }
          key_lo[u] = max(rs, kv0);
          key_hi[u] = min(re, kv1);
        }
        if (j >= 2) mbar_wait(&sm.item_empty[b], ((j >> 1) - 1) & 1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sm.key_lo[b][32 * u + lane] = key_lo[u];
          sm.key_hi[b][32 * u + lane] = key_hi[u];
        }
#pragma unroll
        for (int g = 0; g < SEG_WG; ++g) {  // rows 64g and 64g + 63: lane 0 of u = 2g and lane 31 of u = 2g + 1
          const int r0 = q0 + 64 * g, end = __shfl_sync(0xffffffffu, key_hi[2 * g + 1], 31);
          if (lane == 0)
            sm.span[b][g] = r0 >= kv0 && r0 + 64 <= kv1 ? make_int2(key_lo[2 * g], end) : make_int2(kv0, kv1);
        }
        mbar_arrive(&sm.item_full[b]);  // every lane, after its own writes
      }
      return;
    }
    if (warp != SEG_WG * 4 || lane != 0) return;
    // the copying lane: each item's Q tiles into one of two buffers, then the
    // union of its spans in 64-key tiles through the ring
    prefetch_map(&q_a_map);
    prefetch_map(&q_b_map);
    prefetch_map(&k_a_map);
    prefetch_map(&k_b_map);
    prefetch_map(&v_a_map);
    prefetch_map(&v_b_map);
    int step = 0, j = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
      const int b = j & 1, c = item % n_chunks, head = item / n_chunks, q0 = c * PLAN_CHUNK;
      mbar_wait(&sm.item_full[b], (j >> 1) & 1);
      const int2 s0 = sm.span[b][0], s1 = sm.span[b][1];
      mbar_arrive(&sm.item_empty[b]);
      const int lo = min(s0.x, s1.x), hi = max(s0.y, s1.y);
      const int n_tiles = (hi - lo + SEG_BK - 1) / SEG_BK;  // the spans meet, so every tile is some warpgroup's
      // the Q tiles, once the store of item j - SEG_QBUF has read the buffer
      const int u = j % SEG_QBUF;
      if (j >= SEG_QBUF) mbar_wait(&sm.q_empty[u], (j / SEG_QBUF - 1) & 1);
      mbar_expect_tx(&sm.q_full[u], SEG_WG * SEG_TILE_BYTES);
      for (int g = 0; g < SEG_WG; ++g) {
        tma_load_3d(sm.q_a[u][g], &q_a_map, &sm.q_full[u], 0, head, q0 + 64 * g);
        tma_load_3d(sm.q_b[u][g], &q_b_map, &sm.q_full[u], 64, head, q0 + 64 * g);
      }
      for (int t = 0; t < n_tiles; ++t, ++step) {
        const int s = step % SEG_STAGES, row = lo + t * SEG_BK;
        if (step >= SEG_STAGES) mbar_wait(&sm.kv_empty[s], (step / SEG_STAGES - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], SEG_TILE_BYTES);
        tma_load_3d(sm.k_a[s], &k_a_map, &sm.k_full[s], 0, head, row);
        tma_load_3d(sm.k_b[s], &k_b_map, &sm.k_full[s], 64, head, row);
        mbar_expect_tx(&sm.v_full[s], SEG_TILE_BYTES);
        tma_load_3d(sm.v_a[s], &v_a_map, &sm.v_full[s], 0, head, row);
        tma_load_3d(sm.v_b[s], &v_b_map, &sm.v_full[s], 64, head, row);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 16w + lane / 4 (+ 8) of its 64 in the accumulators
  setmaxnreg_inc<SEG_CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4, quad = lane & 3, r = 16 * w + (lane >> 2);
  const bool leader = w == 0 && lane == 0;  // issues the warpgroup's stores
  auto release = [&](int step) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kv_empty[step % SEG_STAGES]);
  };
  // a tile of the union that misses this warpgroup's span: freed once it has
  // landed (so that an arrival never counts towards the stage's previous round)
  auto pass = [&](int step) {
    const int s = step % SEG_STAGES;
    const uint32_t parity = (step / SEG_STAGES) & 1;
    mbar_wait(&sm.k_full[s], parity);
    mbar_wait(&sm.v_full[s], parity);
    release(step);
  };
  auto k_ready = [&](int step) {
    mbar_wait(&sm.k_full[step % SEG_STAGES], (step / SEG_STAGES) & 1);
    return step % SEG_STAGES;
  };
  auto v_ready = [&](int step) {
    mbar_wait(&sm.v_full[step % SEG_STAGES], (step / SEG_STAGES) & 1);
    return step % SEG_STAGES;
  };
  int step = 0, j = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
    const int b = j & 1, c = item % n_chunks, head = item / n_chunks, q0 = c * PLAN_CHUNK;
    mbar_wait(&sm.item_full[b], (j >> 1) & 1);
    const int lo0 = sm.key_lo[b][64 * g + r], hi0 = sm.key_hi[b][64 * g + r];
    const int lo1 = sm.key_lo[b][64 * g + r + 8], hi1 = sm.key_hi[b][64 * g + r + 8];
    const int2 s0 = sm.span[b][0], s1 = sm.span[b][1];
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.item_empty[b]);
    const int2 own = g == 0 ? s0 : s1;
    const int lo = min(s0.x, s1.x), hi = max(s0.y, s1.y), n_tiles = (hi - lo + SEG_BK - 1) / SEG_BK;
    const int t_first = (own.x - lo) / SEG_BK, t_last = (own.y - 1 - lo) / SEG_BK;
    for (int t = 0; t < t_first; ++t) pass(step + t);

    // Tile t's Q K^T and softmax run while tile t - 1's P V does: its
    // accumulator takes the new max's factor once that product is done.
    float oa[32], ob[8], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int e = 0; e < 32; ++e) oa[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ob[e] = 0.f;
    const int u = j % SEG_QBUF;
    const uint32_t qa = smem_addr(sm.q_a[u][g]), qb = smem_addr(sm.q_b[u][g]);
    mbar_wait(&sm.q_full[u], (j / SEG_QBUF) & 1);
    int st = k_ready(step + t_first);
    seg_qk(s, qa, qb, smem_addr(sm.k_a[st]), smem_addr(sm.k_b[st]));
    wgmma_wait<0>();
    fence_regs(s);
    seg_softmax(s, m, l, corr, lo + t_first * SEG_BK, lo0, hi0, lo1, hi1, hi, quad, scale_log2);
    seg_split(s, phi, plo);
    // the store of the item before has long read its Q buffer when this
    // warpgroup has done its first tile: free that buffer
    auto free_q = [&]() {
      if (leader && j > 0) {
        bulk_wait_read<0>();
        mbar_arrive(&sm.q_empty[(j - 1) % SEG_QBUF]);
      }
    };
    for (int t = t_first + 1; t <= t_last; ++t) {
      st = k_ready(step + t);
      seg_qk(s, qa, qb, smem_addr(sm.k_a[st]), smem_addr(sm.k_b[st]));
      st = v_ready(step + t - 1);
      fence_regs(oa);
      fence_regs(ob);
      seg_pv(oa, ob, phi, plo, smem_addr(sm.v_a[st]), smem_addr(sm.v_b[st]));
      wgmma_wait<1>();
      fence_regs(s);
      seg_softmax(s, m, l, corr, lo + t * SEG_BK, lo0, hi0, lo1, hi1, hi, quad, scale_log2);
      wgmma_wait<0>();
      fence_regs(oa);
      fence_regs(ob);
      release(step + t - 1);
      if (t == t_first + 1) free_q();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          oa[4 * nn + 2 * h] *= corr[h];
          oa[4 * nn + 2 * h + 1] *= corr[h];
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          ob[4 * nn + 2 * h] *= corr[h];
          ob[4 * nn + 2 * h + 1] *= corr[h];
        }
      }
      seg_split(s, phi, plo);
    }
    st = v_ready(step + t_last);
    fence_regs(oa);
    fence_regs(ob);
    seg_pv(oa, ob, phi, plo, smem_addr(sm.v_a[st]), smem_addr(sm.v_b[st]));
    wgmma_wait<0>();
    fence_regs(oa);
    fence_regs(ob);
    release(step + t_last);
    if (t_last == t_first) free_q();

    // normalise, write over the Q tile in its two swizzled layouts, store by TMA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    }
    unsigned char* tile_a = reinterpret_cast<unsigned char*>(sm.q_a[u][g]);
    unsigned char* tile_b = reinterpret_cast<unsigned char*>(sm.q_b[u][g]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
        *reinterpret_cast<uint32_t*>(tile_a + sw128(r + 8 * h, 16 * nn + 4 * quad)) =
            pack_bf16x2(oa[4 * nn + 2 * h] * l[h], oa[4 * nn + 2 * h + 1] * l[h]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        *reinterpret_cast<uint32_t*>(tile_b + sw32(r + 8 * h, 16 * nn + 4 * quad)) =
            pack_bf16x2(ob[4 * nn + 2 * h] * l[h], ob[4 * nn + 2 * h + 1] * l[h]);
    }
    fence_proxy_async();
    warpgroup_sync(1 + g);
    if (leader) {
      tma_store_3d(&o_a_map, sm.q_a[u][g], 0, head, q0 + 64 * g);
      tma_store_3d(&o_b_map, sm.q_b[u][g], 64, head, q0 + 64 * g);
      bulk_commit();
    }
    for (int t = t_last + 1; t < n_tiles; ++t) pass(step + t);
    step += n_tiles;
  }
  if (leader) bulk_wait_read<0>();  // the last store has read its tiles before the CTA ends
}

// K2's head dim and query heads a kv head are template arguments, built for
// the Qwen2-style recognition decoder's and for LFM2-MoE's attention layers'
constexpr int CAUSAL_D = 128;  // K2: head dim of the recognition decoder (1536 / 12)
constexpr int CAUSAL_G = 3;    // K2: query heads per kv head (12 / 4), a consumer warpgroup each
constexpr int LFM2_D = 64;     // K2: head dim of LFM2-MoE's attention layers (2048 / 32)
constexpr int LFM2_G = 4;      // K2: their query heads per kv head (32 / 8)
constexpr int BLOCK = 64;      // K2: rows of a Q tile (wgmma's m64) and keys of a K/V tile
constexpr int HALF_ELEMS = BLOCK * 64;  // a 64 x 64 bf16 box: one 128-byte half of each row
constexpr int HALF_BYTES = HALF_ELEMS * 2;

constexpr int CAUSAL_STAGES = 4;     // K2: K/V tiles in the ring (a persistent CTA's items alternate halves)
constexpr int CAUSAL_QBUF = 2;       // K2: Q tiles a head
constexpr int PRODUCER_REGS = 24;    // K2: the producer warpgroup's registers a thread

// K2 at head dim D with G query heads a kv head: a tile is 64 rows of D
// dims, D / 64 boxes of 128-byte rows; the G consumer warpgroups and a
// producer warpgroup, which gives its registers to the consumers by
// setmaxnreg. The consumers can take no more than the CTA was given at its
// launch, THREADS x the registers a thread that ptxas gives a CTA of
// THREADS (65536 / THREADS, down to a multiple of 8): 128 x 24 + 384 x 160
// <= 512 x 128 at G = 3, 128 x 24 + 512 x 112 <= 640 x 96 at G = 4 (a
// consumer that asks for more waits for ever)
template <int D, int G>
struct Causal {
  static constexpr int HALVES = D / 64;
  static constexpr int TILE_ELEMS = HALVES * HALF_ELEMS;
  static constexpr int TILE_BYTES = HALVES * HALF_BYTES;
  static constexpr int THREADS = G * 128 + 128;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int CONSUMER_REGS = (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / (G * 128) / 8 * 8;
  static_assert(CONSUMER_REGS >= LAUNCH_REGS && 128 * PRODUCER_REGS + G * 128 * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
                "setmaxnreg moves registers inside the CTA only");
  struct Smem {  // at a 1024-byte boundary (its tiles are 8 or 16 KB each)
    bf16 k[CAUSAL_STAGES][TILE_ELEMS];
    bf16 v[CAUSAL_STAGES][TILE_ELEMS];
    bf16 q[G][CAUSAL_QBUF][TILE_ELEMS];
    uint64_t k_full[CAUSAL_STAGES], v_full[CAUSAL_STAGES], kv_empty[CAUSAL_STAGES];
    uint64_t q_full[G][CAUSAL_QBUF], q_empty[G][CAUSAL_QBUF];
  };
  static constexpr int SMEM = (int)sizeof(Smem) + 1024;  // and room to align it to 1024 bytes
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
template <int D, int G>
__global__ void __launch_bounds__(Causal<D, G>::THREADS, 1)
    causal_attention_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
                            int B, int L, int KVH, int rows_per_cta, float scale_log2) {
  constexpr int STAGES = CAUSAL_STAGES, QBUF = CAUSAL_QBUF, CAUSAL_G = G, CAUSAL_D = D;
  constexpr int HALVES = Causal<D, G>::HALVES, TILE_BYTES = Causal<D, G>::TILE_BYTES;
  using CausalSmem = typename Causal<D, G>::Smem;
  // aligned here, not by the declaration: an aligned extern __shared__
  // declaration applies to every kernel of this file
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
      for (int h = 0; h < HALVES; ++h)
        tma_load_4d(sm.k[s] + h * HALF_ELEMS, &k_map, &sm.k_full[s], 64 * h, kh, j * BLOCK, b);
      mbar_expect_tx(&sm.v_full[s], TILE_BYTES);
      for (int h = 0; h < HALVES; ++h)
        tma_load_4d(sm.v[s] + h * HALF_ELEMS, &v_map, &sm.v_full[s], 64 * h, kh, j * BLOCK, b);
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
          for (int h = 0; h < HALVES; ++h)
            tma_load_4d(sm.q[g][u] + h * HALF_ELEMS, &q_map, &sm.q_full[g][u], 64 * h, it.kh * CAUSAL_G + g,
                        i * BLOCK, it.b);
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
  setmaxnreg_inc<Causal<D, G>::CONSUMER_REGS>();
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
        float o[HALVES][32], s[32];
#pragma unroll
        for (int half = 0; half < HALVES; ++half)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[half][e] = 0.f;
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
            for (int half = 0; half < HALVES; ++half)
#pragma unroll
              for (int nn = 0; nn < 8; ++nn) {
                o[half][4 * nn + 2 * h] *= corr;
                o[half][4 * nn + 2 * h + 1] *= corr;
              }
          }
          // O += P V: P from registers (the accumulator layout of key blocks
          // 2kk and 2kk + 1 is the A layout of k16 step kk), as its bf16 value
          // and its rounding error; V MN-major, 16 keys (2048 bytes) a step:
          // at D = 128 one m64n128 product over both 64-dim halves (8192 bytes
          // apart: the leading byte offset), o[0] and o[1] its two 64-column
          // halves; at D = 64 one m64n64 product into o[0]
          mbar_wait(&sm.v_full[st], parity);
          const uint32_t v_s = smem_addr(sm.v[st]);
#pragma unroll
          for (int half = 0; half < HALVES; ++half) fence_regs(o[half]);
          uint32_t hi[BLOCK / 16][4], lo[BLOCK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BLOCK / 16; ++kk) {
#pragma unroll
            for (int a = 0; a < 4; ++a) split_bf16x2(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], hi[kk][a], lo[kk][a]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BLOCK / 16; ++kk) {
            const uint64_t vd = sw128_desc(v_s + kk * 2048, HALF_BYTES, 1024);
            if constexpr (HALVES == 2) {
              float(&o128)[64] = reinterpret_cast<float(&)[64]>(o);
              wgmma_64x128_rs_tb(o128, hi[kk], vd);
              wgmma_64x128_rs_tb(o128, lo[kk], vd);
            } else {
              wgmma_64x64_rs_tb(o[0], hi[kk], vd);
              wgmma_64x64_rs_tb(o[0], lo[kk], vd);
            }
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int half = 0; half < HALVES; ++half) fence_regs(o[half]);
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
        for (int half = 0; half < HALVES; ++half) {
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
          for (int h = 0; h < HALVES; ++h)
            tma_store_4d(&o_map, sm.q[g][u] + h * HALF_ELEMS, 64 * h, it.kh * CAUSAL_G + g, i * BLOCK, it.b);
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

}  // namespace

// The wrapper (ops/flash.py) has checked shapes, dtype (bf16), alignment,
// S % 128 == 0 and 0 < kv_range <= S. Each entry returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a configuration it was not
// built for or a tensor the driver will not map. Dynamic shared memory above
// 48 KB must be asked for on each device; each launch asks, which costs
// little next to the launch.

constexpr int SEG_SMEM = (int)sizeof(SegSmem) + 1024;  // and room to align it to 1024 bytes

// K1's CTAs: one an SM, each walking its items (fewer where there are fewer items)
static int segmented_ctas(int S, int H) {
  const int64_t items = (int64_t)S / PLAN_CHUNK * H, sms = sm_count();
  return (int)(items < sms ? items : sms);
}

extern "C" int surya_segmented_attention(const void* q, const void* k, const void* v, int64_t q_rs,
                                         int64_t k_rs, int64_t v_rs, const void* seg,
                                         const void* kv_starts, void* out, int S, int H, int D,
                                         int kv_range, float scale, void* stream) {
  if (D != SEG_D || H < 1 || S % PLAN_CHUNK || kv_range <= 0 || kv_range > S) return (int)cudaErrorInvalidValue;
  // [S, H, D] as 3-D maps, innermost first; boxes of 64 rows of one head
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S};
  const cuuint64_t q_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)q_rs * 2};
  const cuuint64_t k_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)k_rs * 2};
  const cuuint64_t v_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)v_rs * 2};
  const cuuint64_t o_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2};
  const cuuint32_t box_a[3] = {64, 1, 64}, box_b[3] = {16, 1, 64};
  constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle sw_a = CU_TENSOR_MAP_SWIZZLE_128B, sw_b = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qa, qb, ka, kb, va, vb, oa, ob;
  if (!make_map(&qa, bf, 3, q, dims, q_strides, box_a, sw_a) || !make_map(&qb, bf, 3, q, dims, q_strides, box_b, sw_b) ||
      !make_map(&ka, bf, 3, k, dims, k_strides, box_a, sw_a) || !make_map(&kb, bf, 3, k, dims, k_strides, box_b, sw_b) ||
      !make_map(&va, bf, 3, v, dims, v_strides, box_a, sw_a) || !make_map(&vb, bf, 3, v, dims, v_strides, box_b, sw_b) ||
      !make_map(&oa, bf, 3, out, dims, o_strides, box_a, sw_a) ||
      !make_map(&ob, bf, 3, out, dims, o_strides, box_b, sw_b))
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(segmented_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SEG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  segmented_attention_kernel<<<segmented_ctas(S, H), SEG_THREADS, SEG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      qa, qb, ka, kb, va, vb, oa, ob, static_cast<const int*>(seg), static_cast<const int*>(kv_starts), S, H, kv_range,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// How K1 launches at these shapes, into cfg: CTAs, threads and K/V stages of
// a CTA, its dynamic shared memory, and the CTAs an SM holds at once (0 if
// the runtime cannot say). Returns 0.
extern "C" int surya_segmented_config(int S, int H, int* cfg) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(segmented_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SEG_SMEM) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segmented_attention_kernel, SEG_THREADS, SEG_SMEM) !=
          cudaSuccess)
    per_sm = 0;
  const int out[5] = {segmented_ctas(S, H), SEG_THREADS, SEG_STAGES, SEG_SMEM, per_sm};
  for (int i = 0; i < 5; ++i) cfg[i] = out[i];
  return 0;
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

template <int D, int G>
static int launch_causal(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
                         const CUtensorMap& o_map, int B, int L, int KVH, const CausalLaunch& c, float scale_log2,
                         cudaStream_t stream) {
  constexpr int smem = Causal<D, G>::SMEM;
  const auto kernel = causal_attention_kernel<D, G>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<c.ctas, Causal<D, G>::THREADS, smem, stream>>>(q_map, k_map, v_map, o_map, B, L, KVH, c.rows_per_cta,
                                                          scale_log2);
  return (int)cudaGetLastError();
}

// How K2 launches at these shapes (head dim 128, 3 query heads a kv head),
// into cfg: CTAs, row blocks an item, K/V stages, dynamic shared memory and
// threads of a CTA. Returns 0.
extern "C" int surya_causal_config(int B, int L, int KVH, int* cfg) {
  using C = Causal<CAUSAL_D, CAUSAL_G>;
  const CausalLaunch c = causal_launch(B, L, KVH);
  const int out[5] = {c.ctas, c.rows_per_cta, CAUSAL_STAGES, C::SMEM, C::THREADS};
  for (int i = 0; i < 5; ++i) cfg[i] = out[i];
  return 0;
}

extern "C" int surya_causal_attention(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
                                      int KVH, int D, float scale, void* stream) {
  const bool qwen2 = D == CAUSAL_D && H == CAUSAL_G * KVH, lfm2 = D == LFM2_D && H == LFM2_G * KVH;
  if (!(qwen2 || lfm2) || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const CausalLaunch c = causal_launch(B, L, KVH);
  // [B, L, heads, D] as 4-D maps, innermost first; 64 x 64 boxes (one head)
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t k_dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint64_t k_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2, (cuuint64_t)L * KVH * D * 2};
  const cuuint32_t box[4] = {64, 1, BLOCK, 1};
  CUtensorMap q_map, k_map, v_map, o_map;
  constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&q_map, bf, 4, q, q_dims, q_strides, box, sw) || !make_map(&k_map, bf, 4, k, k_dims, k_strides, box, sw) ||
      !make_map(&v_map, bf, 4, v, k_dims, k_strides, box, sw) || !make_map(&o_map, bf, 4, out, q_dims, q_strides, box, sw))
    return (int)cudaErrorInvalidValue;
  const auto launch = qwen2 ? &launch_causal<CAUSAL_D, CAUSAL_G> : &launch_causal<LFM2_D, LFM2_G>;
  return launch(q_map, k_map, v_map, o_map, B, L, KVH, c, scale * LOG2E, static_cast<cudaStream_t>(stream));
}
