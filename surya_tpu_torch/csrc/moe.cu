// The sparse-expert layer's glue (surya_tpu_torch/ops/moe.py): the four
// kernels around its two grouped GEMMs, for LFM2-MoE's 32 experts with 4
// chosen a token. None replaces a kernel of the JAX package, which has no
// sparse layer; ops/moe.py's docstring says what bounds each on the H100
// and what its design does about it.
//
//   route    x [T, H] and the router [32, H] -> chosen [T, 4] int32 (32 for a
//            token that is not valid), weights [T, 4] fp32, and the rows of
//            each expert in each block of 8 tokens, hist [ceil(T / 8), 32]
//   permute  a stable counting sort of the T x 4 token-expert rows by
//            expert from hist: offs [32] (the running counts), each row's
//            place in the sorted order (inverse [T x 4], -1 for a token that
//            is not valid), x's rows gathered to their places, and the
//            layer's counters
//   swiglu   h [rows, 2I] -> silu(h[:, :I]) * h[:, I:] [rows, I], the rows
//            below offs[31] only
//   combine  out[t] = sum over j = 0..3 of y[inverse[4t + j]] weights[t, j],
//            in fp32, in that order; zeros for a token that is not valid
//
// No kernel uses atomics: every run gives the same bits. None reads a value
// on the host, so a CUDA graph captures the layer.

#include <math_constants.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NE = 32;                               // experts: one lane each
constexpr int TOPK = 4;                              // experts a token
constexpr int ROUTE_TOKENS = 8;                      // tokens a route block
constexpr int BLOCK_ROWS = ROUTE_TOKENS * TOPK;      // its token-expert rows: one warp's lanes
constexpr int ROUTE_CTA_TOKENS = 2 * ROUTE_TOKENS;  // a route CTA's tokens: the tensor cores' 16 rows
constexpr int ROUTE_WARPS = 8;                       // each an eighth of the columns
constexpr int ROUTE_THREADS = 32 * ROUTE_WARPS;
constexpr int PERMUTE_THREADS = 512;
constexpr int PERMUTE_WARPS = PERMUTE_THREADS / 32;
constexpr int HIST_GROUPS = PERMUTE_THREADS / 8;     // route blocks' histograms read at once, 8 threads each
constexpr int MAX_BLOCKS_PER_CTA = 32;               // route blocks a permute CTA sorts and gathers
constexpr int SWIGLU_THREADS = 256;
constexpr int COMBINE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// A CTA of 16 tokens (two route blocks), an m16 tile of the tensor
// cores: warp w sums the products over an eighth of the columns, for all
// 32 experts, by mma.sync (bf16 in, fp32 accumulators): a lane loads 16
// bytes of each of its two token rows and of four experts' rows for each
// 32 columns (the sum's order does not matter, so lane q's 8 columns are
// the columns 2q, 2q + 1 and 2q + 8, 2q + 9 of two m16n8k16 steps in A and
// in B alike), 24 loads in flight before the products. The eight partial
// tiles are added in shared memory in the warps' order, then warp w
// chooses for tokens w and w + 8: the sigmoid, the bias added for the
// choice, four rounds of a warp arg-max (the lower expert on a tie), the
// chosen scores normalised and scaled.
__global__ void __launch_bounds__(ROUTE_THREADS, 2) moe_route_reduce_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gate, const void* __restrict__ bias, int bias_bf16,
    const bool* __restrict__ valid, int* __restrict__ chosen, float* __restrict__ weights, int* __restrict__ hist,
    int T, int H, int norm, float eps, float scale) {
  __shared__ float spart[ROUTE_WARPS][ROUTE_CTA_TOKENS][NE];
  __shared__ float slogit[ROUTE_CTA_TOKENS][NE];
  __shared__ int ssel[ROUTE_CTA_TOKENS][TOPK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tok0 = blockIdx.x * ROUTE_CTA_TOKENS;
  const int ntok = min(ROUTE_CTA_TOKENS, T - tok0);
  const int nvec = H / 8, wvec = nvec / ROUTE_WARPS;
  // rows past T load a copy of the last token's
  const uint4* xlo = reinterpret_cast<const uint4*>(x) + static_cast<size_t>(tok0 + min(g, ntok - 1)) * nvec;
  const uint4* xhi = reinterpret_cast<const uint4*>(x) + static_cast<size_t>(tok0 + min(g + 8, ntok - 1)) * nvec;
  const uint4* gw = reinterpret_cast<const uint4*>(gate) + static_cast<size_t>(g) * nvec;  // expert 8n + g: + 8n rows

  float acc[NE / 8][4];  // [n tile][c0..c3]: tokens g, g + 8 by experts 8n + 2q, 8n + 2q + 1
#pragma unroll
  for (int n = 0; n < NE / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  for (int v0 = warp * wvec + q; v0 < (warp + 1) * wvec; v0 += 16) {
    uint4 lo[4], hi[4], b[4][NE / 8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = __ldg(xlo + v0 + 4 * c);
      hi[c] = __ldg(xhi + v0 + 4 * c);
#pragma unroll
      for (int n = 0; n < NE / 8; ++n) b[c][n] = __ldg(gw + static_cast<size_t>(8 * n) * nvec + v0 + 4 * c);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t a01[4] = {lo[c].x, hi[c].x, lo[c].y, hi[c].y};
      const uint32_t a23[4] = {lo[c].z, hi[c].z, lo[c].w, hi[c].w};
#pragma unroll
      for (int n = 0; n < NE / 8; ++n) {
        surya::mma_16816(acc[n], a01, b[c][n].x, b[c][n].y);
        surya::mma_16816(acc[n], a23, b[c][n].z, b[c][n].w);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NE / 8; ++n) {
    spart[warp][g][8 * n + 2 * q] = acc[n][0];
    spart[warp][g][8 * n + 2 * q + 1] = acc[n][1];
    spart[warp][g + 8][8 * n + 2 * q] = acc[n][2];
    spart[warp][g + 8][8 * n + 2 * q + 1] = acc[n][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROUTE_CTA_TOKENS * NE; i += ROUTE_THREADS) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < ROUTE_WARPS; ++w) sum += spart[w][i / NE][i % NE];
    slogit[i / NE][i % NE] = sum;
  }
  __syncthreads();

  for (int t = warp; t < ROUTE_CTA_TOKENS; t += ROUTE_WARPS) {
    const int tok = tok0 + t;
    if (t >= ntok) {
      if (lane < TOPK) ssel[t][lane] = -1;
      continue;
    }
    const float score = 1.0f / (1.0f + expf(-slogit[t][lane]));
    const float b = bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[lane])
                              : static_cast<const float*>(bias)[lane];
    float key = score + b;
    const bool ok = valid == nullptr || valid[tok];
    int pick[TOPK];
    float w[TOPK];
#pragma unroll
    for (int j = 0; j < TOPK; ++j) {
      float best = key;
      int idx = lane;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int oi = __shfl_xor_sync(FULL, idx, off);
        if (ob > best || (ob == best && oi < idx)) {
          best = ob;
          idx = oi;
        }
      }
      pick[j] = idx;
      w[j] = __shfl_sync(FULL, score, idx);
      if (lane == idx) key = -CUDART_INF_F;
    }
    if (norm) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TOPK; ++j) sum += w[j];
#pragma unroll
      for (int j = 0; j < TOPK; ++j) w[j] = w[j] / (sum + eps);
    }
    int mine = pick[0];
    float mine_w = w[0];
#pragma unroll
    for (int j = 1; j < TOPK; ++j)
      if (lane == j) {
        mine = pick[j];
        mine_w = w[j];
      }
    if (lane < TOPK) {
      chosen[tok * TOPK + lane] = ok ? mine : NE;
      weights[tok * TOPK + lane] = mine_w * scale;
      ssel[t][lane] = ok ? mine : -1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * NE) {  // each route block's rows by expert
    const int half = threadIdx.x / NE, e = threadIdx.x % NE;
    const int block = blockIdx.x * 2 + half;
    int n = 0;
#pragma unroll
    for (int i = 0; i < ROUTE_TOKENS * TOPK; ++i) n += (&ssel[half * ROUTE_TOKENS][0])[i] == e;
    if (block * ROUTE_TOKENS < T) hist[block * NE + e] = n;
  }
}

// A CTA takes route blocks [first, first + nblk). It sums every route
// block's histogram (all of them, and those before its own) to each
// expert's first place, gives each of its rows its place (the rows of one
// route block are one warp's lanes: __match_any_sync groups the lanes of
// an expert, and a lane's rank among them keeps the tokens' order), and
// copies the rows of x to their places, a warp a row, 4 KB in flight a
// warp. CTA 0 writes offs and adds to the counters.
__global__ void __launch_bounds__(PERMUTE_THREADS) moe_permute_gather_kernel(
    const bf16* __restrict__ x, const int* __restrict__ chosen, const int* __restrict__ hist, bf16* __restrict__ rows,
    int* __restrict__ inverse, int* __restrict__ offs, long long* __restrict__ counts, int T, int H, int R,
    int per_cta) {
  __shared__ int stot[HIST_GROUPS][NE];
  __shared__ int spre[HIST_GROUPS][NE];
  __shared__ int sbase[MAX_BLOCKS_PER_CTA][NE];
  __shared__ int spos[MAX_BLOCKS_PER_CTA * BLOCK_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = blockIdx.x * per_cta;
  const int nblk = min(per_cta, R - first);

  {  // thread (g, q): experts 4q..4q+3 of route blocks g, g + HIST_GROUPS, ...
    const int q = tid & 7, g = tid >> 3;
    int tot[4] = {0, 0, 0, 0}, pre[4] = {0, 0, 0, 0};
    const int4* h4 = reinterpret_cast<const int4*>(hist);
    for (int r = g; r < R; r += HIST_GROUPS) {
      const int4 h = __ldg(h4 + r * (NE / 4) + q);
      const int hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[i] += hv[i];
        pre[i] += r < first ? hv[i] : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      stot[g][4 * q + i] = tot[i];
      spre[g][4 * q + i] = pre[i];
    }
  }
  __syncthreads();
  if (warp == 0) {  // lane e: expert e
    int tot = 0, pre = 0;
    for (int g = 0; g < HIST_GROUPS; ++g) {
      tot += stot[g][lane];
      pre += spre[g][lane];
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += n;
    }
    if (blockIdx.x == 0) {
      offs[lane] = incl;
      const int total = __shfl_sync(FULL, incl, 31);
      const int hit = __popc(__ballot_sync(FULL, tot > 0));
      int most = tot;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) most = max(most, __shfl_xor_sync(FULL, most, off));
      if (lane == 0 && counts != nullptr) {
        counts[0] += total;
        counts[1] += hit;
        counts[2] += most;
      }
    }
    int base = incl - tot + pre;
    for (int b = 0; b < nblk; ++b) {
      sbase[b][lane] = base;
      base += hist[(first + b) * NE + lane];
    }
  }
  __syncthreads();

  const int nrows = T * TOPK;
  for (int b = warp; b < nblk; b += PERMUTE_WARPS) {
    const int row = (first + b) * BLOCK_ROWS + lane;
    const int e = row < nrows ? chosen[row] : -1;
    const unsigned peers = __match_any_sync(FULL, e);
    const int pos = e >= 0 && e < NE ? sbase[b][e] + __popc(peers & ((1u << lane) - 1u)) : -1;
    if (row < nrows) inverse[row] = pos;
    spos[b * BLOCK_ROWS + lane] = pos;
  }
  __syncthreads();

  const int nvec = H / 8;
  for (int i = warp; i < nblk * BLOCK_ROWS; i += PERMUTE_WARPS) {
    const int pos = spos[i];
    if (pos < 0) continue;
    const uint4* src = reinterpret_cast<const uint4*>(x) + static_cast<size_t>((first * BLOCK_ROWS + i) / TOPK) * nvec;
    uint4* dst = reinterpret_cast<uint4*>(rows) + static_cast<size_t>(pos) * nvec;
    for (int v0 = lane; v0 < nvec; v0 += 8 * 32) {
      uint4 buf[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (v0 + k * 32 < nvec) buf[k] = __ldg(src + v0 + k * 32);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (v0 + k * 32 < nvec) dst[v0 + k * 32] = buf[k];
    }
  }
}

// 8 outputs a thread, over the rows below offs[last] (read on the device),
// a grid-stride loop; silu and the product in fp32, rounded once.
__global__ void __launch_bounds__(SWIGLU_THREADS) moe_swiglu_elementwise_kernel(
    const bf16* __restrict__ h, const int* __restrict__ offs, bf16* __restrict__ out, int I, int last) {
  const int per_row = I / 8;
  const long long n = static_cast<long long>(offs[last]) * per_row;
  const uint4* hv = reinterpret_cast<const uint4*>(h);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = static_cast<long long>(blockIdx.x) * SWIGLU_THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * SWIGLU_THREADS) {
    const long long row = i / per_row;
    const int v = static_cast<int>(i - row * per_row);
    float g[8], u[8], r[8];
    unpack8(__ldg(hv + row * 2 * per_row + v), g);
    unpack8(__ldg(hv + row * 2 * per_row + per_row + v), u);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = __fmul_rn(g[k] / (1.0f + expf(-g[k])), u[k]);
    ov[i] = pack8(r);
  }
}

// A CTA a token, 8 columns a thread: its 4 rows of y weighted and added in
// fp32 (products and sums rounded apart, j = 0..3), rounded once to bf16.
__global__ void __launch_bounds__(COMBINE_THREADS) moe_combine_gather_kernel(
    const bf16* __restrict__ y, const int* __restrict__ inverse, const float* __restrict__ weights,
    const bool* __restrict__ valid, bf16* __restrict__ out, int H) {
  const int t = blockIdx.x;
  const int nvec = H / 8;
  uint4* dst = reinterpret_cast<uint4*>(out) + static_cast<size_t>(t) * nvec;
  if (valid != nullptr && !valid[t]) {
    for (int v = threadIdx.x; v < nvec; v += COMBINE_THREADS) dst[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  int pos[TOPK];
  float w[TOPK];
#pragma unroll
  for (int j = 0; j < TOPK; ++j) {
    pos[j] = __ldg(inverse + t * TOPK + j);
    w[j] = __ldg(weights + t * TOPK + j);
  }
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  for (int v = threadIdx.x; v < nvec; v += COMBINE_THREADS) {
    uint4 rv[TOPK];
#pragma unroll
    for (int j = 0; j < TOPK; ++j) rv[j] = __ldg(yv + static_cast<size_t>(pos[j]) * nvec + v);
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < TOPK; ++j) {
      float f[8];
      unpack8(rv[j], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], w[j]));
    }
    dst[v] = pack8(acc);
  }
}

}  // namespace

// Each entry checks what its kernel assumes, launches it on `stream` and
// returns the launch's cudaError (cudaErrorInvalidValue for a shape it
// does not take).

extern "C" int surya_moe_route(const void* x, const void* gate, const void* bias, int bias_bf16, const void* valid,
                               void* chosen, void* weights, void* hist, int T, int H, int norm, float eps,
                               float scale, void* stream) {
  if (T <= 0 || H <= 0 || H % (8 * 16 * ROUTE_WARPS)) return (int)cudaErrorInvalidValue;
  moe_route_reduce_kernel<<<(T + ROUTE_CTA_TOKENS - 1) / ROUTE_CTA_TOKENS, ROUTE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gate), bias, bias_bf16, static_cast<const bool*>(valid),
      static_cast<int*>(chosen), static_cast<float*>(weights), static_cast<int*>(hist), T, H, norm, eps, scale);
  return (int)cudaGetLastError();
}

extern "C" int surya_moe_permute(const void* x, const void* chosen, const void* hist, void* rows, void* inverse,
                                 void* offs, void* counts, int T, int H, int per_cta, void* stream) {
  if (T <= 0 || H <= 0 || H % 8 || per_cta <= 0 || per_cta > MAX_BLOCKS_PER_CTA) return (int)cudaErrorInvalidValue;
  const int R = (T + ROUTE_TOKENS - 1) / ROUTE_TOKENS;
  moe_permute_gather_kernel<<<(R + per_cta - 1) / per_cta, PERMUTE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(chosen), static_cast<const int*>(hist),
      static_cast<bf16*>(rows), static_cast<int*>(inverse), static_cast<int*>(offs), static_cast<long long*>(counts), T,
      H, R, per_cta);
  return (int)cudaGetLastError();
}

extern "C" int surya_moe_swiglu(const void* h, const void* offs, void* out, int rows, int I, int blocks, void* stream) {
  if (rows <= 0 || I <= 0 || I % 8 || blocks <= 0) return (int)cudaErrorInvalidValue;
  moe_swiglu_elementwise_kernel<<<blocks, SWIGLU_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const int*>(offs), static_cast<bf16*>(out), I, NE - 1);
  return (int)cudaGetLastError();
}

extern "C" int surya_moe_combine(const void* y, const void* inverse, const void* weights, const void* valid,
                                 void* out, int T, int H, void* stream) {
  if (T <= 0 || H <= 0 || H % 8) return (int)cudaErrorInvalidValue;
  moe_combine_gather_kernel<<<T, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(inverse), static_cast<const float*>(weights),
      static_cast<const bool*>(valid), static_cast<bf16*>(out), H);
  return (int)cudaGetLastError();
}
