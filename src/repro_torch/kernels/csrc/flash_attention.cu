// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pl.pallas_call at :104): causal, sliding-window or
// non-causal attention with GQA (q head h reads kv head h / R) and an online
// softmax whose state (m, l, acc) stays in fp32 registers.
//
// What bounds it: at prefill lengths the work is 4*D flops per unmasked
// (query, key) pair against 2*D*(Tq + 2*Tk) bytes, far above the card's
// ~295 flops/byte ridge, so the kernel is bound by operations. This first
// version does both products (Q K^T and P V) in fp32 FMAs out of shared
// memory, as the JAX reference does them in fp32; warpgroup tensor-core
// products (wgmma) and TMA staging are the next step.
//
// Design: one CTA of 256 threads per (64-row q tile, q head, batch row).
// The Q tile is staged once in shared memory as fp32; K and V tiles of 64
// rows stream through shared memory. Thread (ty, tx) owns rows ty + 16 i and
// key columns tx + 16 j of the score tile (interleaved, so shared-memory
// reads are conflict-free with a +1 row pitch), and the output columns
// tx + 16 j. Row max and row sum reduce over the 16 lanes of a half warp.
// Any head dim that is a multiple of 16 fits this layout (the row pitch D + 1
// is odd); the instantiated ones are 16, 32, 64, 80 (zamba2), 128 and 160
// (stablelm-12b), the last at 140 KB of shared memory.
// K tiles past the causal diagonal (or before the window) are never loaded.
// Tails of any length are masked; nothing needs T to divide the tiles.
//
// Layout: q/o (B, Hq, Tq, D) and k/v (B, Hkv, Tk, D) given by strides in
// elements, with the D axis contiguous, so the model's (B, T, H, D) tensors
// are read in place.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sqb, sqh, sqt;
  int64_t skb, skh, skt;
  int64_t svb, svh, svt;
  int64_t sob, soh, sot;
  int Hq, Hkv, Tq, Tk;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FlashArgs a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int RPT = BQ / 16;  // score rows per thread
  constexpr int CPT = BK / 16;  // score columns per thread
  constexpr int DPT = D / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  T* op = static_cast<T*>(a.o) + b * a.sob + h * a.soh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * (D + 1) + d] = t < a.Tq ? to_f<T>(qp[t * a.sqt + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // the key range this q tile needs: causal stops at its last row, a
  // window starts at its first row's window
  const int last_row = min(q0 + BQ, a.Tq) - 1;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, last_row + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is staged; the last tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const int t = k0 + c;
      const bool ok = t < a.Tk;
      Ks[c * (D + 1) + d] = ok ? to_f<T>(kp[t * a.skt + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f<T>(vp[t * a.svt + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;  // query row i sits at key i
      bool keep[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = row < a.Tq && kpos < a.Tk;
        if (a.causal) ok = ok && row >= kpos;
        if (a.window > 0) ok = ok && kpos > row - a.window;
        keep[j] = ok;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;  // masked rows stay 0
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      op[row * a.sot + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 160: return launch<T, 160>(a, B, stream);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

// strides: 12 int64 in elements, (b, h, t) for q, k, v, o in that order.
// Returns 0, a cudaError_t code, or -1 for a head dim or dtype it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int64_t* strides, int B, int Hq,
                                   int Hkv, int Tq, int Tk, int D, int dtype,
                                   int causal, int window, float scale,
                                   void* stream) {
  using namespace repro;
  if (Tq == 0 || B == 0) return 0;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqt = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skt = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svt = strides[8];
  a.sob = strides[9]; a.soh = strides[10]; a.sot = strides[11];
  a.Hq = Hq; a.Hkv = Hkv; a.Tq = Tq; a.Tk = Tk;
  a.causal = causal; a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, B, D, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return -1;
}
