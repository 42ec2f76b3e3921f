// Decode attention for Hopper (sm_90a): one new query token per sequence
// against the KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// _decode_kernel (pl.pallas_call at :91): scores of one token against the
// first valid_len[b] cache rows, online softmax in fp32, and for an int8
// cache dequantization in the kernel with fp32 scales per (token, head).
//
// What bounds it: each cache byte is used for 2*R flops (R q heads per
// cache head), far below the card's ~295 flops/byte ridge, so the kernel is
// bound by the bytes of the cache it must read. The design reads each valid
// cache row once and nothing past valid_len: one CTA per (cache head, batch
// row) serves all R q heads of the group, where the Pallas grid (B, Hq,
// S-blocks) reads the group's cache R times. Splitting S over more CTAs with
// a second reduce pass is the next step for short batches.
//
// Design: 8 warps split the valid rows; a warp takes 4 rows at a time, its
// lanes holding D/32 (rounded up to a power of two) consecutive elements of
// each row (one vector load per lane), so the k and v loads of a row are one
// coalesced transaction. Dot
// products reduce over the warp with shuffles; each warp keeps its own
// (m, l, acc) per q head, and the warps' states merge through shared memory
// at the end.
//
// Layout: q/o (B, Hq, D); k/v (B, Hc, S, D) and scales (B, Hc, S, 1) given by
// strides in elements, so the per-layer (B, S, Hc, D) view of the model's
// (L, B, S, Hc, D) cache is read in place.
#include "common.cuh"

namespace repro {
namespace {

constexpr int NW = 8;  // warps per CTA
constexpr int G = 4;   // cache rows per warp step

// Row elements per lane: ceil(D / 32) rounded up to a power of two, so that
// D is a multiple of it and a lane's elements are one aligned vector load
// (D = 80: 4 elements on 20 lanes; D = 160: 8 on 20 lanes).
__host__ __device__ constexpr int lane_elems(int D) {
  int e = 1;
  while (32 * e < D) e *= 2;
  return e;
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 only
  const float* vs;
  const int* valid_len;
  void* o;
  int64_t sqb, sqh;
  int64_t skb, skh, skt;
  int64_t svb, svh, svt;
  int64_t sksb, sksh, skst;
  int64_t svsb, svsh, svst;
  int64_t sob, soh;
  int Hq, Hc, S;
  float scale;
};

template <typename TQ, typename TKV, int D, int RMAX>
__global__ void __launch_bounds__(NW * 32) decode_kernel(const DecodeArgs a) {
  static_assert(D % lane_elems(D) == 0, "a lane's elements must not cross the row end");
  constexpr int EPL = lane_elems(D);  // row elements per lane
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;

  __shared__ float sm_m[NW][RMAX];
  __shared__ float sm_l[NW][RMAX];
  __shared__ float sm_acc[NW][RMAX][D];

  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int R = a.Hq / a.Hc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e0 = lane * EPL;
  const bool lane_on = e0 < D;  // D = 16, 80 or 160 leave lanes idle
  const int valid = max(0, min(a.valid_len[b], a.S));

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.sqb;
  const TKV* kp = static_cast<const TKV*>(a.k) + b * a.skb + hc * a.skh + e0;
  const TKV* vp = static_cast<const TKV*>(a.v) + b * a.svb + hc * a.svh + e0;
  const float* ksp = kInt8 ? a.ks + b * a.sksb + hc * a.sksh : nullptr;
  const float* vsp = kInt8 ? a.vs + b * a.svsb + hc * a.svsh : nullptr;

  float q[RMAX][EPL], m[RMAX], l[RMAX], acc[RMAX][EPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      q[r][e] = 0.f;
    }
    if (r < R && lane_on) load_row<TQ, EPL>(qp + (hc * R + r) * a.sqh + e0, q[r]);
  }

  for (int t0 = warp * G; t0 < valid; t0 += NW * G) {
    float kf[G][EPL], vf[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = t0 + g;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[g][e] = vf[g][e] = 0.f;
      if (t < valid && lane_on) {
        load_row<TKV, EPL>(kp + t * a.skt, kf[g]);
        load_row<TKV, EPL>(vp + t * a.svt, vf[g]);
        if constexpr (kInt8) {
          const float kscale = ksp[t * a.skst];
          const float vscale = vsp[t * a.svst];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kf[g][e] *= kscale;
            vf[g][e] *= vscale;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(q[r][e], kf[g][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g] = t0 + g < valid ? dot * a.scale : kNegInf;
      }
      float mx = s[0];
#pragma unroll
      for (int g = 1; g < G; ++g) mx = fmaxf(mx, s[g]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float p[G], psum = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        p[g] = t0 + g < valid ? expf(s[g] - m_new) : 0.f;
        psum += p[g];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[r][e] * alpha;
#pragma unroll
        for (int g = 0; g < G; ++g) x = fmaf(p[g], vf[g][e], x);
        acc[r][e] = x;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][r][e0 + e] = acc[r][e];
    }
  }
  __syncthreads();

  TQ* op = static_cast<TQ*>(a.o) + b * a.sob;
  for (int i = threadIdx.x; i < R * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      lsum = fmaf(sm_l[w][r], c, lsum);
      o = fmaf(sm_acc[w][r][d], c, o);
    }
    op[(hc * R + r) * a.soh + d] = from_f<TQ>(o / fmaxf(lsum, 1e-20f));
  }
}

template <typename TQ, typename TKV, int D, int RMAX>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  dim3 grid(a.Hc, B);
  decode_kernel<TQ, TKV, D, RMAX><<<grid, NW * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int dispatch_r(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int R = a.Hq / a.Hc;
  if (R <= 1) return launch<TQ, TKV, D, 1>(a, B, stream);
  if (R <= 2) return launch<TQ, TKV, D, 2>(a, B, stream);
  if (R <= 4) return launch<TQ, TKV, D, 4>(a, B, stream);
  if (R <= 8) return launch<TQ, TKV, D, 8>(a, B, stream);
  return -1;
}

template <typename TQ, typename TKV>
int dispatch_d(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_r<TQ, TKV, 16>(a, B, stream);
    case 32: return dispatch_r<TQ, TKV, 32>(a, B, stream);
    case 64: return dispatch_r<TQ, TKV, 64>(a, B, stream);
    case 80: return dispatch_r<TQ, TKV, 80>(a, B, stream);
    case 128: return dispatch_r<TQ, TKV, 128>(a, B, stream);
    case 160: return dispatch_r<TQ, TKV, 160>(a, B, stream);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

// strides: 16 int64 in elements: q (b, h); k (b, h, t); v (b, h, t);
// k_scale (b, h, t); v_scale (b, h, t); o (b, h). Scales are read only for
// an int8 cache. Returns 0, a cudaError_t code, or -1 for a head dim, group
// size or dtype pair it does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* k_scale, const float* v_scale,
                                    const int* valid_len, void* o,
                                    const int64_t* strides, int B, int Hq, int Hc,
                                    int S, int D, int q_dtype, int kv_dtype,
                                    float scale, void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.ks = k_scale; a.vs = v_scale;
  a.valid_len = valid_len; a.o = o;
  a.sqb = strides[0]; a.sqh = strides[1];
  a.skb = strides[2]; a.skh = strides[3]; a.skt = strides[4];
  a.svb = strides[5]; a.svh = strides[6]; a.svt = strides[7];
  a.sksb = strides[8]; a.sksh = strides[9]; a.skst = strides[10];
  a.svsb = strides[11]; a.svsh = strides[12]; a.svst = strides[13];
  a.sob = strides[14]; a.soh = strides[15];
  a.Hq = Hq; a.Hc = Hc; a.S = S;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return dispatch_d<float, float>(a, B, D, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, s);
  if (q_dtype == kF32 && kv_dtype == kI8) return dispatch_d<float, int8_t>(a, B, D, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return dispatch_d<__nv_bfloat16, int8_t>(a, B, D, s);
  return -1;
}
