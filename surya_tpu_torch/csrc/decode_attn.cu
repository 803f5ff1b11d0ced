// One-token GQA decode attention over the slot KV cache (K3).
//
// Replaces the Pallas kernel surya_tpu/ops/decode_attn.py::gqa_decode_pallas
// (`_decode_kernel`), bf16 cache. On an H100 it is bound by the HBM bytes of
// the cache: each (slot, kv head) reads its valid K and V rows once and does
// only 2 * G flops per byte. So the design reads nothing it does not need:
// one CTA per (slot, kv head) walks the frozen cache rows < lengths[slot] only
// (the CUDA form of the Pallas index-map length clamping) and then the chunk
// buffer columns 0..step; the G query heads of the group share every K/V row
// it loads. The layer is picked inside the kernel from the full multi-layer
// arrays, so no per-layer copy of the cache is made.
//
// Inside the CTA, a key row (D bf16 = D/8 sixteen-byte chunks) is spread over
// D/8 lanes; NGRP = 128 / (D/8) rows are in flight at once, DEC_UNROLL deep,
// each lane group running its own fp32 online softmax. The Pallas kernel
// carried that state across grid steps in VMEM; here the groups' states are
// merged through shared memory at the end of the CTA's own loop.

#include "common.cuh"

using namespace surya;

namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_UNROLL = 4;

// Online softmax of the G query heads (held as 8-dim slices per lane) over
// rows [0, n) of one K/V piece (rows of D/8 uint4 chunks).
template <int CH, int NGRP, int G>
__device__ __forceinline__ void attend_rows(const uint4* __restrict__ k, const uint4* __restrict__ v,
                                            int n, int grp, int c, const float (&qf)[G][8],
                                            float (&m)[G], float (&l)[G], float (&acc)[G][8]) {
  // the trip count is uniform over the CTA, so every lane reaches the shuffles
  for (int base = 0; base < n; base += NGRP * DEC_UNROLL) {
    uint4 kr[DEC_UNROLL], vr[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int r = base + grp + NGRP * u;
      if (r < n) {
        kr[u] = k[(int64_t)r * CH + c];
        vr[u] = v[(int64_t)r * CH + c];
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const bool valid = base + grp + NGRP * u < n;
      float kf[8], vf[8];
      bf16x8_to_float(kr[u], kf);
      bf16x8_to_float(vr[u], vf);
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

// q: [B, H, D]; k_cache/v_cache: [layers, B, KVH, S, D]; lengths: [B] int32;
// chunk_k/chunk_v: [layers, B, KVH, K, D]; out: [B, H, D]. All contiguous bf16.
template <int D, int G>
__global__ void __launch_bounds__(DEC_THREADS)
    gqa_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_cache,
                      const __nv_bfloat16* __restrict__ v_cache, const int* __restrict__ lengths,
                      const __nv_bfloat16* __restrict__ chunk_k,
                      const __nv_bfloat16* __restrict__ chunk_v, __nv_bfloat16* __restrict__ out,
                      int B, int KVH, int S, int K, int step, int layer, float scale) {
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
  attend_rows<CH, NGRP, G>(reinterpret_cast<const uint4*>(k_cache + slab * S * D),
                           reinterpret_cast<const uint4*>(v_cache + slab * S * D), n_cache, grp, c,
                           qf, m, l, acc);
  attend_rows<CH, NGRP, G>(reinterpret_cast<const uint4*>(chunk_k + slab * K * D),
                           reinterpret_cast<const uint4*>(chunk_v + slab * K * D), n_chunk, grp, c,
                           qf, m, l, acc);

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

template <int D, int G>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const void* lengths,
                  const void* chunk_k, const void* chunk_v, void* out, int B, int KVH, int S, int K,
                  int step, int layer, float scale, cudaStream_t stream) {
  gqa_decode_kernel<D, G><<<dim3(B, KVH), DEC_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const int*>(lengths),
      static_cast<const __nv_bfloat16*>(chunk_k), static_cast<const __nv_bfloat16*>(chunk_v),
      static_cast<__nv_bfloat16*>(out), B, KVH, S, K, step, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/decode_attn.py) has checked shapes, dtype (bf16),
// contiguity and 0 <= step < K, 0 <= layer < layers. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it was not built for.
extern "C" int surya_gqa_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* lengths, const void* chunk_k, const void* chunk_v,
                                void* out, int B, int H, int KVH, int D, int S, int K, int step,
                                int layer, float scale, void* stream) {
  // the recognition decoder: head dim 128, 12 query heads over 4 kv heads
  if (D != 128 || H != 3 * KVH) return (int)cudaErrorInvalidValue;
  return launch_decode<128, 3>(q, k_cache, v_cache, lengths, chunk_k, chunk_v, out, B, KVH, S, K,
                               step, layer, scale, static_cast<cudaStream_t>(stream));
}
