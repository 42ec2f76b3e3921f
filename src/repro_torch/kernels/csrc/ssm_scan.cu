// Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::_ssd_kernel
// (pl.pallas_call at :84). For each (batch, head) and over the chunks of Q
// steps in order, with la the in-chunk cumsum of dt * A:
//   y_t = sum_{s <= t} (C_t . B_s) exp(clip(la_t - la_s, -60, 0)) dt_s x_s
//         + (C_t . S) exp(la_t)
//   S  <- exp(la_end) S + sum_s x_s (B_s exp(clip(la_end - la_s, -60, 0)) dt_s)
// with y written in x's dtype and the final state S (P x N) in fp32. The
// model adds the D skip itself, so the kernel has none.
//
// What bounds it: per chunk the work is about 2 Q^2 (N + P) / 2 flops of
// causal products against (P + 2 N) Q input elements and P Q output
// elements, tens of flops per byte; this first version multiplies in fp32 on
// the CUDA cores, so its FMA rate and shared-memory traffic bound it.
//
// Design: where the TPU grid walks the chunks in order with S in VMEM, here
// one CTA of 256 threads per (head, batch row) walks them in a loop, and S
// stays in shared memory for the whole sequence: HBM sees x, dt, B and C
// once, y once and S once. A chunk's B and x are staged in shared memory as
// fp32 (pitch N + 1 for B, so the score products read it without bank
// conflicts), la is a warp prefix scan, and the intra-chunk term runs in
// blocks of 32 rows: the 32 x s_end score block (only keys up to the block's
// last row are computed) goes to shared memory with its decay, dt and causal
// mask applied, and is then applied to x together with the inter-chunk term.
// The state update follows once every row of the chunk has read the old S.
// Grid (H, B): 80 CTAs for one zamba2 sequence is less than one wave on 132
// SMs; splitting P over more CTAs is the next step.
//
// Layout: x and y (B, H, T, P), dt (B, H, T), B/C (B, G, T, N) given by
// strides in elements with the last axis contiguous, so the model's
// (B, T, H, P) tensors are read and written in place; A (H,) and dt are
// fp32. Limits: Q <= 256, P <= 64, N <= 64 (zamba2: Q = 256, P = N = 64).
#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256;
constexpr int RB = 32;                 // rows per intra-chunk block
constexpr int QMAX = 256;
constexpr int KJ = QMAX / 32;          // key tiles of 32 per row block
constexpr int PMAX = 64;
constexpr int NMAX = 64;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  void* y;
  float* s_out;
  int64_t sxb, sxh, sxt;
  int64_t sdb, sdh, sdt;
  int64_t sbb, sbg, sbt;
  int64_t scb, scg, sct;
  int64_t syb, syh, syt;
  int H, G, T, P, N, Q;
};

// at the limits (Q = 256, P = N = 64): 48,192 floats, 192,768 bytes
constexpr int smem_floats(int Q, int P, int N) {
  return Q * (N + 1) + Q * P + P * (N + 1) + RB * N + RB * Q + 3 * Q;
}

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(const SsdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, Q = a.Q, NP = N + 1;
  float* bs = sm;               // [Q][N + 1]  B of the chunk
  float* xs = bs + Q * NP;      // [Q][P]      x of the chunk
  float* ss = xs + Q * P;       // [P][N + 1]  the carried state S
  float* cs = ss + P * NP;      // [RB][N]     C of a row block
  float* ws = cs + RB * N;      // [RB][Q]     masked, decayed scores of a row block
  float* las = ws + RB * Q;     // [Q]         la
  float* dts = las + Q;         // [Q]         dt
  float* wst = dts + Q;         // [Q]         exp(clip(la_end - la)) dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;    // 8 warps: row (or p) group
  const float A = a.A[h];

  const T* xp = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const float* dtp = a.dt + b * a.sdb + h * a.sdh;
  const T* bp = static_cast<const T*>(a.bm) + b * a.sbb + g * a.sbg;
  const T* cp = static_cast<const T*>(a.cm) + b * a.scb + g * a.scg;
  T* yp = static_cast<T*>(a.y) + b * a.syb + h * a.syh;

  for (int i = tid; i < P * NP; i += NT) ss[i] = 0.f;

  for (int c0 = 0; c0 < a.T; c0 += Q) {
    __syncthreads();  // the last chunk's B, x and S are consumed
    for (int i = tid; i < Q * N; i += NT) {
      const int s = i / N, n = i % N;
      bs[s * NP + n] = to_f<T>(bp[(c0 + s) * a.sbt + n]);
    }
    for (int i = tid; i < Q * P; i += NT) {
      const int s = i / P, p = i % P;
      xs[i] = to_f<T>(xp[(c0 + s) * a.sxt + p]);
    }
    for (int i = tid; i < Q; i += NT) dts[i] = dtp[(c0 + i) * a.sdt];
    __syncthreads();
    if (warp == 0) {  // la = cumsum(dt * A), 32 steps at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int s = base + lane;
        float v = s < Q ? dts[s] * A : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (s < Q) las[s] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float la_end = las[Q - 1];
    for (int i = tid; i < Q; i += NT) wst[i] = clip_exp(la_end - las[i]) * dts[i];

    for (int t0 = 0; t0 < Q; t0 += RB) {
      const int s_end = min(t0 + RB, Q);  // causal: keys up to the block's last row
      __syncthreads();  // the last block's C and scores are consumed
      for (int i = tid; i < RB * N; i += NT) {
        const int r = i / N, n = i % N;
        cs[i] = t0 + r < Q ? to_f<T>(cp[(c0 + t0 + r) * a.sct + n]) : 0.f;
      }
      __syncthreads();

      // scores of rows warp + 8 i against keys lane + 32 j
      {
        float acc[RB / 8][KJ];
#pragma unroll
        for (int i = 0; i < RB / 8; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RB / 8];
#pragma unroll
          for (int i = 0; i < RB / 8; ++i) cv[i] = cs[(warp + 8 * i) * N + n];
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            if (32 * j < s_end) {  // the same for the whole warp
              const int s = lane + 32 * j;
              const float bv = s < s_end ? bs[s * NP + n] : 0.f;
#pragma unroll
              for (int i = 0; i < RB / 8; ++i) acc[i][j] = fmaf(cv[i], bv, acc[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RB / 8; ++i) {
          const int r = warp + 8 * i;
          const int t = t0 + r;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int s = lane + 32 * j;
            if (s < s_end)
              ws[r * Q + s] = t < Q && s <= t
                                  ? acc[i][j] * clip_exp(las[t] - las[s]) * dts[s] : 0.f;
          }
        }
      }
      __syncthreads();

      // y of rows warp + 8 i, columns lane + 32 j: intra + inter-chunk terms
      {
        constexpr int PJ = PMAX / 32;
        float yi[RB / 8][PJ], yo[RB / 8][PJ];
#pragma unroll
        for (int i = 0; i < RB / 8; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yi[i][j] = yo[i][j] = 0.f;
        for (int s = 0; s < s_end; ++s) {
          float wv[RB / 8], xv[PJ];
#pragma unroll
          for (int i = 0; i < RB / 8; ++i) wv[i] = ws[(warp + 8 * i) * Q + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = lane + 32 * j;
            xv[j] = p < P ? xs[s * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RB / 8; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) yi[i][j] = fmaf(wv[i], xv[j], yi[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[RB / 8], sv[PJ];
#pragma unroll
          for (int i = 0; i < RB / 8; ++i) cv[i] = cs[(warp + 8 * i) * N + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = lane + 32 * j;
            sv[j] = p < P ? ss[p * NP + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RB / 8; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) yo[i][j] = fmaf(cv[i], sv[j], yo[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RB / 8; ++i) {
          const int t = t0 + warp + 8 * i;
          if (t >= Q) continue;
          const float el = expf(las[t]);
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = lane + 32 * j;
            if (p < P) yp[(c0 + t) * a.syt + p] = from_f<T>(yi[i][j] + yo[i][j] * el);
          }
        }
      }
    }
    __syncthreads();  // every row has read the old S

    // S <- exp(la_end) S + x^T (B * wst): p = warp + 8 i, n = lane + 32 j
    {
      constexpr int PI = PMAX / 8;
      constexpr int NJ = NMAX / 32;
      float acc[PI][NJ];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < Q; ++s) {
        float xv[PI], bv[NJ];
#pragma unroll
        for (int i = 0; i < PI; ++i) {
          const int p = warp + 8 * i;
          xv[i] = p < P ? xs[s * P + p] : 0.f;
        }
        const float w = wst[s];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = lane + 32 * j;
          bv[j] = n < N ? bs[s * NP + n] * w : 0.f;
        }
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = expf(la_end);
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const int p = warp + 8 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = lane + 32 * j;
          // each thread reads and writes only its own elements of S here
          if (p < P && n < N) ss[p * NP + n] = decay * ss[p * NP + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* sp = a.s_out + (static_cast<int64_t>(b) * a.H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) sp[i] = ss[(i / N) * NP + i % N];
}

template <typename T>
int launch(const SsdArgs& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats(a.Q, a.P, a.N) * static_cast<int>(sizeof(float));
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.H, B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// strides: 15 int64 in elements, (b, h|g, t) for x, dt, B, C and y in that
// order; the last axis of x, B, C and y is contiguous. s_out is a contiguous
// (B, H, P, N) fp32 buffer. Returns 0, a cudaError_t code, or -1 for a shape
// or dtype it does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* bm, const void* cm, void* y, float* s_out,
                            const int64_t* strides, int B, int H, int G, int T,
                            int P, int N, int Q, int dtype, void* stream) {
  using namespace repro;
  if (Q < 1 || Q > QMAX || P > PMAX || N > NMAX || T % Q || H % G) return -1;
  if (B == 0 || T == 0) return 0;
  SsdArgs a;
  a.x = x; a.dt = dt; a.A = A; a.bm = bm; a.cm = cm; a.y = y; a.s_out = s_out;
  a.sxb = strides[0]; a.sxh = strides[1]; a.sxt = strides[2];
  a.sdb = strides[3]; a.sdh = strides[4]; a.sdt = strides[5];
  a.sbb = strides[6]; a.sbg = strides[7]; a.sbt = strides[8];
  a.scb = strides[9]; a.scg = strides[10]; a.sct = strides[11];
  a.syb = strides[12]; a.syh = strides[13]; a.syt = strides[14];
  a.H = H; a.G = G; a.T = T; a.P = P; a.N = N; a.Q = Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(a, B, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, B, s);
  return -1;
}
