// Grouped expert matmul for Hopper (sm_90a): out[e] = x[e] @ w[e].
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::_gmm_kernel
// (pl.pallas_call at :52): x (E, C, d) @ w (E, d, f) -> (E, C, f), summed in
// fp32 and written in x's dtype, for bf16 and fp32.
//
// What bounds it: each weight element serves 2*C flops. At the decode
// capacity (C = 4) that is a few flops per byte, so a call is bound by reading
// every expert's weights once; at the prefill capacity of a 1024-token prompt
// (C = 160) it is still below the card's ~295 flops/byte bf16 ridge. This
// first version multiplies in fp32 on the CUDA cores (as the JAX reference
// does), so at prefill capacities its own FMA rate bounds it; warpgroup
// tensor-core products (wgmma) fed by TMA are the next step.
//
// Design: one of two kernels, chosen by C.
//  * rows (C <= 32: every decode step, and prompts up to ~200 tokens): one CTA
//    per (tile of MT rows, 256 columns of f, expert), MT = 4, 8 or 16 as C
//    asks (never a 64-row tile, which at decode would be mostly padding). Its
//    8 warps split the contraction d; each lane owns 8 consecutive columns
//    and loads them with one 16-byte vector load (bf16) or two (fp32), so a
//    warp reads 512 or 1024 contiguous bytes of a weight row. The MT rows'
//    sums stay in registers; x streams through shared memory in chunks of d;
//    the warps' partial sums are added through shared memory at the end. For
//    C <= 16 there is one row tile and each weight element is read from HBM
//    once per call; for two row tiles they are the grid's fastest axis, so
//    the two CTAs that read the same weights run together and share them
//    through L2.
//  * tiled (C > 32): one CTA of 256 threads per (128 columns, 64 rows,
//    expert) output tile; 16-deep K tiles of x (transposed) and w are staged
//    in shared memory as fp32, and thread (ty, tx) owns rows ty + 16 i and
//    columns tx + 16 j (interleaved, so the shared-memory reads are
//    conflict-free or broadcast).
// The switch at C = 32 is where the two cross on the H100 (phase 3d's
// capacity sweep in chip_smoke.py): at 20 and 32 rows the row kernel is the
// faster, from 48 rows on the tiled one, as the row kernel re-reads the
// weights once per 16 rows. Tails of C, d and f are masked: no dimension
// needs to divide a tile, where the Pallas kernel asserts divisibility.
//
// Layout: x (E, C, d), w (E, d, f) and out (E, C, f) given by strides in
// elements, with the last axis contiguous.
#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

struct GmmArgs {
  const void* x;
  const void* w;
  void* o;
  int64_t sxe, sxc;  // x (e, c)
  int64_t swe, swk;  // w (e, k)
  int64_t soe, soc;  // out (e, c)
  int C, d, f;
  int vec;  // 1: w rows allow 16-byte loads of a lane's 8 columns
};

// ---------------------------------------------------------------- rows

constexpr int SK_CPL = 8;              // columns per lane
constexpr int SK_BN = 32 * SK_CPL;     // columns per CTA
constexpr int SK_KC = 256;             // x chunk along d
constexpr int ROWS_MAX_C = 32;         // larger C goes to the tiled kernel

template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float* out,
                                          int n_left, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  if (vec && n_left >= SK_CPL) {
#pragma unroll
    for (int i = 0; i < SK_CPL; i += V) load_row<T, V>(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < SK_CPL; ++i) out[i] = i < n_left ? to_f<T>(p[i]) : 0.f;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT) gmm_rows(const GmmArgs a) {
  __shared__ float xs[MT][SK_KC];
  __shared__ float red[MT][SK_CPL][32];  // [row][column in lane][lane]

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * MT;
  const int rows = min(MT, a.C - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * SK_BN + lane * SK_CPL;
  const int n_left = a.f - n0;
  const T* xp = static_cast<const T*>(a.x) + e * a.sxe + m0 * a.sxc;
  const T* wp = static_cast<const T*>(a.w) + e * a.swe + n0;

  float acc[MT][SK_CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < SK_CPL; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < a.d; k0 += SK_KC) {
    __syncthreads();  // the last chunk of x is consumed
    for (int i = threadIdx.x; i < MT * SK_KC; i += NT) {
      const int m = i / SK_KC, k = i % SK_KC;
      xs[m][k] = m < rows && k0 + k < a.d ? to_f<T>(xp[m * a.sxc + k0 + k]) : 0.f;
    }
    __syncthreads();
    const int kn = min(SK_KC, a.d - k0);
    if (n_left > 0) {
#pragma unroll 4
      for (int k = warp; k < kn; k += NW) {
        float wv[SK_CPL];
        load_cols<T>(wp + static_cast<int64_t>(k0 + k) * a.swk, wv, n_left, a.vec);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][k];  // one address per warp: a broadcast
#pragma unroll
          for (int j = 0; j < SK_CPL; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }
  }

  // add the warps' partial sums, one warp at a time
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < SK_CPL; ++j)
          red[m][j][lane] = w == 0 ? acc[m][j] : red[m][j][lane] + acc[m][j];
    }
    __syncthreads();
  }

  T* op = static_cast<T*>(a.o) + e * a.soe + m0 * a.soc;
  for (int i = threadIdx.x; i < MT * SK_BN; i += NT) {
    const int m = i / SK_BN, c = i % SK_BN;
    const int n = blockIdx.y * SK_BN + c;
    if (m < rows && n < a.f)
      op[m * a.soc + n] = from_f<T>(red[m][c % SK_CPL][c / SK_CPL]);
  }
}

// ---------------------------------------------------------------- tiled

constexpr int TB_M = 64;
constexpr int TB_N = 128;
constexpr int TB_K = 16;

template <typename T>
__global__ void __launch_bounds__(NT) gmm_tiled(const GmmArgs a) {
  constexpr int RPT = TB_M / 16;  // rows per thread
  constexpr int CPT = TB_N / 16;  // columns per thread
  __shared__ float xs[TB_K][TB_M + 1];  // x tile, transposed
  __shared__ float ws[TB_K][TB_N];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TB_M;
  const int n0 = blockIdx.x * TB_N;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* xp = static_cast<const T*>(a.x) + e * a.sxe;
  const T* wp = static_cast<const T*>(a.w) + e * a.swe;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.d; k0 += TB_K) {
    __syncthreads();  // the last tiles are consumed
    for (int i = threadIdx.x; i < TB_M * TB_K; i += NT) {
      const int m = i / TB_K, k = i % TB_K;
      xs[k][m] = m0 + m < a.C && k0 + k < a.d
                     ? to_f<T>(xp[(m0 + m) * a.sxc + k0 + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < TB_K * TB_N; i += NT) {
      const int k = i / TB_N, n = i % TB_N;
      ws[k][n] = k0 + k < a.d && n0 + n < a.f
                     ? to_f<T>(wp[static_cast<int64_t>(k0 + k) * a.swk + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TB_K; ++k) {
      float xv[RPT], wv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) xv[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

  T* op = static_cast<T*>(a.o) + e * a.soe;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.C) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.f) op[m * a.soc + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int MT>
int launch_rows(const GmmArgs& a, int E, cudaStream_t stream) {
  dim3 grid((a.C + MT - 1) / MT, (a.f + SK_BN - 1) / SK_BN, E);
  gmm_rows<T, MT><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const GmmArgs& a, int E, cudaStream_t stream) {
  if (a.C <= 4) return launch_rows<T, 4>(a, E, stream);
  if (a.C <= 8) return launch_rows<T, 8>(a, E, stream);
  if (a.C <= ROWS_MAX_C) return launch_rows<T, 16>(a, E, stream);
  dim3 grid((a.f + TB_N - 1) / TB_N, (a.C + TB_M - 1) / TB_M, E);
  gmm_tiled<T><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// strides: 6 int64 in elements: x (e, c), w (e, k), out (e, c); the last
// axis of each is contiguous. vec = 1 when f % 8 == 0 and w's base and
// strides allow 16-byte loads. Returns 0, a cudaError_t code, or -1 for a
// dtype it does not take.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* o,
                           const int64_t* strides, int E, int C, int d, int f,
                           int dtype, int vec, void* stream) {
  using namespace repro;
  if (E == 0 || C == 0 || f == 0) return 0;
  GmmArgs a;
  a.x = x; a.w = w; a.o = o;
  a.sxe = strides[0]; a.sxc = strides[1];
  a.swe = strides[2]; a.swk = strides[3];
  a.soe = strides[4]; a.soc = strides[5];
  a.C = C; a.d = d; a.f = f;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(a, E, s);
  if (dtype == kBF16) return dispatch<__nv_bfloat16>(a, E, s);
  return -1;
}
