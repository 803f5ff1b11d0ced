// One-token GQA decode attention over the slot KV cache (K3 and K3q).
//
// Replaces the Pallas kernel surya_tpu/ops/decode_attn.py::gqa_decode_pallas
// (`_decode_kernel`): K3 with a bf16 cache, K3q with an int8 cache and one
// bf16 scale per cache row (`quantized=True`). On an H100 both are bound by
// the HBM bytes of the cache: each (slot, kv head) reads its valid K and V
// rows once and does only 2 * G flops per element. So the design reads
// nothing it does not need: one CTA per (slot, kv head) walks the frozen
// cache rows < lengths[slot] only (the CUDA form of the Pallas index-map
// length clamping) and then the chunk buffer columns 0..step; the G query
// heads of the group share every K/V row it loads. The layer is picked
// inside the kernel from the full multi-layer arrays, so no per-layer copy
// of the cache is made.
//
// Inside the CTA, a key row of D elements is spread over D/8 lanes of 8
// elements each: a bf16 row as one 16-byte load a lane, an int8 row as one
// 8-byte load a lane plus the row's bf16 scale, dequantized in registers to
// fp32 (value * scale, as the Pallas kernel dequantizes in VMEM; K3q reads
// half the cache bytes of K3). The chunk buffer is always bf16. NGRP =
// 128 / (D/8) rows are in flight at once, DEC_UNROLL deep, each lane group
// running its own fp32 online softmax. The Pallas kernel carried that state
// across grid steps in VMEM; here the groups' states are merged through
// shared memory at the end of the CTA's own loop.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md):
// K3q takes about as long as K3 at ragged lengths, though it reads half the
// bytes. The serial chain of the longest slot's CTA sets most of the time:
// with every slot at 512 rows (twice the bytes, the same longest slot) both
// take under 10 % longer than ragged, and with every slot at the mean (the
// same bytes, half the longest chain) about 30 % less. Splitting long slots
// over several CTAs, with a merge pass, is the cure for a later change.

#include <type_traits>

#include "common.cuh"

using namespace surya;

namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_UNROLL = 4;

// 8 int8 values (one 8-byte load) times their row's scale -> 8 floats.
__device__ __forceinline__ void int8x8_to_float(const uint2& u, float s, float* f) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = i < 4 ? u.x : u.y;
    f[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu)) * s;
  }
}

// Online softmax of the G query heads (held as 8-dim slices per lane) over
// rows [0, n) of one K/V piece (rows of CH chunks of 8 elements). QUANT:
// the rows are int8 and ks/vs hold one bf16 scale per row.
template <int CH, int NGRP, int G, bool QUANT>
__device__ __forceinline__ void attend_rows(const void* __restrict__ k, const void* __restrict__ v,
                                            const __nv_bfloat16* __restrict__ ks,
                                            const __nv_bfloat16* __restrict__ vs, int n, int grp, int c,
                                            const float (&qf)[G][8], float (&m)[G], float (&l)[G],
                                            float (&acc)[G][8]) {
  using Chunk = std::conditional_t<QUANT, uint2, uint4>;
  const Chunk* kc = static_cast<const Chunk*>(k);
  const Chunk* vc = static_cast<const Chunk*>(v);
  // the trip count is uniform over the CTA, so every lane reaches the shuffles
  for (int base = 0; base < n; base += NGRP * DEC_UNROLL) {
    Chunk kr[DEC_UNROLL], vr[DEC_UNROLL];
    float ksr[DEC_UNROLL], vsr[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int r = base + grp + NGRP * u;
      ksr[u] = vsr[u] = 0.f;
      if (r < n) {
        kr[u] = kc[(int64_t)r * CH + c];
        vr[u] = vc[(int64_t)r * CH + c];
        if constexpr (QUANT) {
          ksr[u] = __bfloat162float(ks[r]);
          vsr[u] = __bfloat162float(vs[r]);
        }
      } else {
        kr[u] = Chunk{};
        vr[u] = Chunk{};
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const bool valid = base + grp + NGRP * u < n;
      float kf[8], vf[8];
      if constexpr (QUANT) {
        int8x8_to_float(kr[u], ksr[u], kf);
        int8x8_to_float(vr[u], vsr[u], vf);
      } else {
        bf16x8_to_float(kr[u], kf);
        bf16x8_to_float(vr[u], vf);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qf[gi][e], kf[e], s);
        s = group_sum<CH>(s);
        if (valid) {
          if (s > m[gi]) {
            const float corr = __expf(m[gi] - s);
            l[gi] *= corr;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[gi][e] *= corr;
            m[gi] = s;
          }
          const float p = __expf(s - m[gi]);
          l[gi] += p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
        }
      }
    }
  }
}

// q: [B, H, D]; k_cache/v_cache: [layers, B, KVH, S, D] (bf16, or int8 with
// k_scale/v_scale [layers, B, KVH, S] bf16 when QUANT); lengths: [B] int32;
// chunk_k/chunk_v: [layers, B, KVH, K, D] bf16; out: [B, H, D] bf16. All
// contiguous.
template <int D, int G, bool QUANT>
__global__ void __launch_bounds__(DEC_THREADS)
    gqa_decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                      const void* __restrict__ v_cache, const __nv_bfloat16* __restrict__ k_scale,
                      const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ lengths,
                      const __nv_bfloat16* __restrict__ chunk_k,
                      const __nv_bfloat16* __restrict__ chunk_v, __nv_bfloat16* __restrict__ out,
                      int B, int KVH, int S, int K, int step, int layer, float scale) {
  using CacheT = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  constexpr int CH = D / 8;
  constexpr int NGRP = DEC_THREADS / CH;
  __shared__ float m_s[NGRP][G];
  __shared__ float l_s[NGRP][G];
  __shared__ float acc_s[NGRP][G][D];

  const int tid = threadIdx.x;
  const int grp = tid / CH, c = tid % CH;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int H = KVH * G;

  float qf[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4* qrow = reinterpret_cast<const uint4*>(q + ((int64_t)b * H + kh * G + gi) * D);
    bf16x8_to_float(qrow[c], qf[gi]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[gi][e] *= scale;
      acc[gi][e] = 0.f;
    }
    m[gi] = NEG_INF;
    l[gi] = 0.f;
  }

  const int64_t slab = ((int64_t)layer * B + b) * KVH + kh;
  const int n_cache = min(max(lengths[b], 0), S);
  const int n_chunk = min(step + 1, K);
  const __nv_bfloat16* ks = nullptr;
  const __nv_bfloat16* vs = nullptr;
  if constexpr (QUANT) {
    ks = k_scale + slab * S;
    vs = v_scale + slab * S;
  }
  attend_rows<CH, NGRP, G, QUANT>(static_cast<const CacheT*>(k_cache) + slab * S * D,
                                  static_cast<const CacheT*>(v_cache) + slab * S * D, ks, vs, n_cache,
                                  grp, c, qf, m, l, acc);
  attend_rows<CH, NGRP, G, false>(chunk_k + slab * K * D, chunk_v + slab * K * D, nullptr, nullptr,
                                  n_chunk, grp, c, qf, m, l, acc);

  // merge the NGRP partial softmax states (a group that saw no row holds
  // m = NEG_INF, l = 0 and weighs exp(NEG_INF - M) == 0)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (c == 0) {
      m_s[grp][gi] = m[gi];
      l_s[grp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[grp][gi][c * 8 + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += DEC_THREADS) {
    const int gi = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int g = 0; g < NGRP; ++g) M = fmaxf(M, m_s[g][gi]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int g = 0; g < NGRP; ++g) {
      const float w = __expf(m_s[g][gi] - M);
      Lsum = fmaf(l_s[g][gi], w, Lsum);
      O = fmaf(acc_s[g][gi][d], w, O);
    }
    out[((int64_t)b * H + kh * G + gi) * D + d] = __float2bfloat16(O / Lsum);
  }
}

template <int D, int G, bool QUANT>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                  const void* v_scale, const void* lengths, const void* chunk_k, const void* chunk_v,
                  void* out, int B, int KVH, int S, int K, int step, int layer, float scale,
                  cudaStream_t stream) {
  gqa_decode_kernel<D, G, QUANT><<<dim3(B, KVH), DEC_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(lengths), static_cast<const __nv_bfloat16*>(chunk_k),
      static_cast<const __nv_bfloat16*>(chunk_v), static_cast<__nv_bfloat16*>(out), B, KVH, S, K,
      step, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/decode_attn.py) has checked shapes, dtypes, contiguity and
// 0 <= step < K, 0 <= layer < layers. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it was not built for:
// the recognition decoder's head dim 128, 12 query heads over 4 kv heads.

// K3: bf16 cache.
extern "C" int surya_gqa_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* lengths, const void* chunk_k, const void* chunk_v,
                                void* out, int B, int H, int KVH, int D, int S, int K, int step,
                                int layer, float scale, void* stream) {
  if (D != 128 || H != 3 * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<128, 3, false>(q, k_cache, v_cache, nullptr, nullptr, lengths, chunk_k,
                                      chunk_v, out, B, KVH, S, K, step, layer, scale,
                                      static_cast<cudaStream_t>(stream));
}

// K3q: int8 cache with bf16 per-row scales.
extern "C" int surya_gqa_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                                     const void* k_scale, const void* v_scale, const void* lengths,
                                     const void* chunk_k, const void* chunk_v, void* out, int B,
                                     int H, int KVH, int D, int S, int K, int step, int layer,
                                     float scale, void* stream) {
  if (D != 128 || H != 3 * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<128, 3, true>(q, k_cache, v_cache, k_scale, v_scale, lengths, chunk_k,
                                     chunk_v, out, B, KVH, S, K, step, layer, scale,
                                     static_cast<cudaStream_t>(stream));
}
