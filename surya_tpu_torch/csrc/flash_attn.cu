// Encoder segmented attention (K1) and decoder causal prefill attention (K2).
//
// K1 replaces the Pallas kernel surya_tpu/ops/flash.py::segmented_block_attention
// (`_kernel`); K2 replaces surya_tpu/ops/flash.py::causal_flash_attention
// (`_causal_kernel`). Both are compute-bound at large tiles on an H100: every
// key row of a tile is read once from shared memory and reused by all the
// query rows of the block, and the logits never leave registers.
//
// Design (simple first, no wgmma/TMA yet): one CTA owns BQ query rows of one
// head. Each query row is held by TPR neighbouring lanes, each lane keeping
// D/TPR of the row's dims of q (pre-scaled) and of the fp32 accumulator; a dot
// product is a per-lane partial sum reduced with warp shuffles. Key and value
// rows stream through shared memory in BK-row bf16 tiles and every lane runs
// the online softmax in fp32, key by key. Where the Pallas grid carried
// (m, l, acc) in VMEM scratch from one KV block to the next, here that state
// lives in registers inside the CTA's own loop over KV tiles.

#include "common.cuh"

using namespace surya;

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // key rows per shared-memory tile
constexpr int PLAN_CHUNK = 128;  // query rows per kv_starts entry (qwen_encoder.FULL_ATTN_Q_CHUNK)

// lanes per query row: D/8 sixteen-byte chunks are split evenly over them
template <int D>
constexpr int lanes_per_row() {
  return (D / 8) % 4 == 0 && D >= 128 ? 4 : 2;
}

// Online-softmax update of one query row with one key row from shared memory.
// Every lane of the warp must call it (the dot product is reduced by shuffles).
template <int NC, int TPR>
__device__ __forceinline__ void attend_key(const float* qf, const uint4* krow, const uint4* vrow,
                                           bool valid, int t, float& m, float& l, float* acc) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float kf[8];
    bf16x8_to_float(krow[t + TPR * i], kf);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(qf[8 * i + e], kf[e], s);
  }
  s = group_sum<TPR>(s);
  // A masked key carries the logit NEG_INF, as in the Pallas kernels. Once the
  // row has seen a valid key its weight exp(NEG_INF - m) is exactly 0, so it is
  // skipped; before that it adds the same placeholder weight 1 that the first
  // valid key then scales away (exp(NEG_INF - s) == 0).
  if (!valid && m != NEG_INF) return;
  if (!valid) s = NEG_INF;
  if (s > m) {
    const float c = __expf(m - s);
    l *= c;
#pragma unroll
    for (int e = 0; e < NC * 8; ++e) acc[e] *= c;
    m = s;
  }
  const float p = __expf(s - m);
  l += p;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float vf[8];
    bf16x8_to_float(vrow[t + TPR * i], vf);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[8 * i + e] = fmaf(p, vf[e], acc[8 * i + e]);
  }
}

template <int NC, int TPR>
__device__ __forceinline__ void load_row_scaled(const __nv_bfloat16* src, int t, float scale,
                                                float* dst) {
  const uint4* row = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    bf16x8_to_float(row[t + TPR * i], dst + 8 * i);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[8 * i + e] *= scale;
  }
}

template <int NC, int TPR>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, int t, const float* acc, float l) {
  uint4* row = reinterpret_cast<uint4*>(dst);
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = acc[8 * i + e] * inv;
    row[t + TPR * i] = float_to_bf16x8(o);
  }
}

// K1. q/k/v: [S, H, D] with row strides q_rs/k_rs/v_rs (elements) and unit
// dim stride, heads D apart; out: [S, H, D] contiguous. Query rows of plan
// chunk c attend keys [kv0, kv0 + kv_range) with kv0 = kv_starts[c] clamped
// like a dynamic slice, masked by seg[query] == seg[key].
template <int D, int TPR>
__global__ void __launch_bounds__(BQ* TPR)
    segmented_attention_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, int64_t q_rs, int64_t k_rs,
                               int64_t v_rs, const int* __restrict__ seg,
                               const int* __restrict__ kv_starts, __nv_bfloat16* __restrict__ out,
                               int S, int H, int kv_range, float scale) {
  constexpr int CH = D / 8;
  constexpr int NC = CH / TPR;
  constexpr int NT = BQ * TPR;
  __shared__ uint4 k_s[BK * CH];
  __shared__ uint4 v_s[BK * CH];
  __shared__ int seg_s[BK];

  const int tid = threadIdx.x;
  const int t = tid % TPR;
  const int row = blockIdx.x * BQ + tid / TPR;
  const int64_t hoff = (int64_t)blockIdx.y * D;
  const int kv0 = max(0, min(kv_starts[(blockIdx.x * BQ) / PLAN_CHUNK], S - kv_range));

  float qf[NC * 8], acc[NC * 8];
  load_row_scaled<NC, TPR>(q + row * q_rs + hoff, t, scale, qf);
#pragma unroll
  for (int e = 0; e < NC * 8; ++e) acc[e] = 0.f;
  const int my_seg = seg[row];
  float m = NEG_INF, l = 0.f;

  for (int kt = kv0; kt < kv0 + kv_range; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * CH; idx += NT) {
      const int64_t r = kt + idx / CH;
      const int c = idx % CH;
      k_s[idx] = reinterpret_cast<const uint4*>(k + r * k_rs + hoff)[c];
      v_s[idx] = reinterpret_cast<const uint4*>(v + r * v_rs + hoff)[c];
    }
    for (int idx = tid; idx < BK; idx += NT) seg_s[idx] = seg[kt + idx];
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j)
      attend_key<NC, TPR>(qf, k_s + j * CH, v_s + j * CH, seg_s[j] == my_seg, t, m, l, acc);
  }
  store_row<NC, TPR>(out + (int64_t)row * H * D + hoff, t, acc, l);
}

// K2. q: [B, L, H, D], k/v: [B, L, KVH, D], out: [B, L, H, D], all contiguous.
// Query head h reads kv head h / (H / KVH); key j is valid for row i when
// j <= i. The KV loop stops at the tile holding the block's last row, so
// tiles above the diagonal are neither loaded nor computed.
template <int D, int TPR>
__global__ void __launch_bounds__(BQ* TPR)
    causal_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            int L, int H, int KVH, float scale) {
  constexpr int CH = D / 8;
  constexpr int NC = CH / TPR;
  constexpr int NT = BQ * TPR;
  __shared__ uint4 k_s[BK * CH];
  __shared__ uint4 v_s[BK * CH];

  const int tid = threadIdx.x;
  const int t = tid % TPR;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * BQ + tid / TPR;
  const bool row_ok = row < L;
  const int q_end = min(L, (int)(blockIdx.x + 1) * BQ);
  const int64_t kv_rs = (int64_t)KVH * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * L * KVH + h / (H / KVH)) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * L * KVH + h / (H / KVH)) * D;
  const int64_t qo_off = (((int64_t)b * L + row) * H + h) * D;

  float qf[NC * 8], acc[NC * 8];
  if (row_ok) {
    load_row_scaled<NC, TPR>(q + qo_off, t, scale, qf);
  } else {
#pragma unroll
    for (int e = 0; e < NC * 8; ++e) qf[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NC * 8; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kt = 0; kt < q_end; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * CH; idx += NT) {
      const int r = kt + idx / CH;
      const int c = idx % CH;
      if (r < L) {
        k_s[idx] = reinterpret_cast<const uint4*>(kb + r * kv_rs)[c];
        v_s[idx] = reinterpret_cast<const uint4*>(vb + r * kv_rs)[c];
      } else {
        k_s[idx] = make_uint4(0, 0, 0, 0);
        v_s[idx] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j)
      attend_key<NC, TPR>(qf, k_s + j * CH, v_s + j * CH, kt + j <= row, t, m, l, acc);
  }
  if (row_ok) store_row<NC, TPR>(out + qo_off, t, acc, l);
}

template <int D>
int launch_segmented(const void* q, const void* k, const void* v, int64_t q_rs, int64_t k_rs,
                     int64_t v_rs, const void* seg, const void* kv_starts, void* out, int S, int H,
                     int kv_range, float scale, cudaStream_t stream) {
  constexpr int TPR = lanes_per_row<D>();
  const dim3 grid(S / BQ, H);
  segmented_attention_kernel<D, TPR><<<grid, BQ * TPR, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_rs, k_rs, v_rs, static_cast<const int*>(seg),
      static_cast<const int*>(kv_starts), static_cast<__nv_bfloat16*>(out), S, H, kv_range, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_causal(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
                  int KVH, float scale, cudaStream_t stream) {
  constexpr int TPR = lanes_per_row<D>();
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  causal_attention_kernel<D, TPR><<<grid, BQ * TPR, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), L, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/flash.py) has checked shapes, dtype (bf16), alignment,
// S % 128 == 0 and kv_range % 64 == 0. Each entry returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a head dim it was not built for.
extern "C" int surya_segmented_attention(const void* q, const void* k, const void* v, int64_t q_rs,
                                         int64_t k_rs, int64_t v_rs, const void* seg,
                                         const void* kv_starts, void* out, int S, int H, int D,
                                         int kv_range, float scale, void* stream) {
  // head dim of the recognition encoder (1280 / 16)
  if (D != 80) return (int)cudaErrorInvalidValue;
  return launch_segmented<80>(q, k, v, q_rs, k_rs, v_rs, seg, kv_starts, out, S, H, kv_range, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int surya_causal_attention(const void* q, const void* k, const void* v, void* out, int B,
                                      int L, int H, int KVH, int D, float scale, void* stream) {
  // head dim of the recognition decoder (1536 / 12)
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch_causal<128>(q, k, v, out, B, L, H, KVH, scale, static_cast<cudaStream_t>(stream));
}
