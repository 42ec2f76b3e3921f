// Grouped expert matmul for Hopper (sm_90a): out[e] = x[e] @ w[e].
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::_gmm_kernel
// (pl.pallas_call at :52): x (E, C, d) @ w (E, d, f) -> (E, C, f), summed in
// fp32 and written in x's dtype, for bf16 and fp32.
//
// What bounds it: every expert's weights are read once per call, and each
// weight element serves 2*C flops. At phi3.5-moe's decode capacity (C = 4,
// E = 16, 4096 -> 6400) a call is 839 MB of weights for 3.4 GFLOP: 0.25 ms
// at the HBM rate, bound by bytes. At the prefill capacity of a 1024-token
// prompt (C = 160) it is 134 GFLOP on the same bytes, 160 flops a byte,
// still under the card's ~295 bf16 ridge: 0.27 ms by bytes, but only if
// the products run on the tensor cores (fp32 CUDA-core FMAs at 67 TFLOP/s
// would take 2 ms).
//
// Design: three kernels; the wrapper (kernels/moe_gmm.py::route) picks one
// from the dtype, C and the TMA constraints before the launch and passes it
// here as `path`. Nothing falls back after a failure.
//  * wgmma (bf16, every stride a multiple of 16 bytes, 16-byte-aligned
//    bases): a grouped GEMM on the tensor cores. It beats the row kernel at
//    every capacity of chip_smoke.py phase 3d's sweep on the H100, C = 4 to
//    160, so it has no switch: it takes the decode step too, and the
//    CUDA-core kernels keep fp32 and the bf16 strides TMA cannot take. One CTA per (64 rows of C, 128 columns of f, expert), row tiles
//    fastest in the grid so that the CTAs reading one weight tile run
//    together and share it through L2. One producer warp has one thread
//    issue TMA loads (3-D tensor maps over (E, C, d) and (E, d, f), so a box
//    never crosses an expert and TMA zero-fills the tails of C, d and f)
//    into a ring of STAGES slots: an x tile of 64 x 64 (K-major) and a w
//    tile of 64 k x 128 columns (N-contiguous, two 64-column boxes under
//    the 128-byte swizzle). Each slot has a full mbarrier armed with
//    expect_tx and an empty mbarrier the four consumer warps arrive on
//    after wgmma.wait_group has retired the products that read it. The
//    consumer warpgroup issues wgmma m64n128k16 (bf16 x bf16 -> fp32, B
//    transposed: w is MN-major) with both operands in shared memory and 64
//    fp32 accumulators a thread, then rounds them to bf16 (as astype) and
//    writes them masked by C and f. A bf16 x bf16 product is exact in fp32,
//    so this is the Pallas kernel's function up to the order of the sum.
//    The ring keeps STAGES x 24 KB of weights in flight per CTA and two
//    CTAs fit an SM, enough bytes in flight for the HBM rate.
//  * rows (fp32, or bf16 that TMA cannot take, C <= 32): one CTA per (tile
//    of MT rows, 256 columns of f, expert), MT = 4, 8 or 16 as C asks. Its
//    8 warps split the contraction d; each lane owns 8 consecutive columns
//    and loads them with one 16-byte vector load (bf16) or two (fp32). The
//    MT rows' sums stay in registers; x streams through shared memory in
//    chunks of d; the warps' partial sums are added through shared memory.
//    Row tiles are the grid's fastest axis, as above.
//  * tiled (fp32, or bf16 that TMA cannot take, C > 32): one CTA of 256
//    threads per (128 columns, 64 rows, expert) output tile; 16-deep K
//    tiles of x (transposed) and w are staged in shared memory as fp32 and
//    multiplied with fp32 FMAs on the CUDA cores.
// The rows/tiled switch at C = 32 is where those two cross on the H100
// (chip_smoke.py phase 3d's capacity sweep). The two CUDA-core kernels mask
// the tails of C, d and f by hand: no dimension needs to divide a tile,
// where the Pallas kernel asserts divisibility.
//
// Layout: x (E, C, d), w (E, d, f) and out (E, C, f) given by strides in
// elements, with the last axis contiguous.
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- wgmma

constexpr int WG_BM = 64;                       // rows of C per CTA (one wgmma M)
constexpr int WG_BN = 128;                      // columns of f per CTA (wgmma N)
constexpr int WG_BK = 64;                       // k per ring slot: 128 bytes of bf16
constexpr int WG_STAGES = 4;
constexpr int WG_X_BYTES = WG_BM * WG_BK * 2;   // 8 KB
constexpr int WG_WBOX_BYTES = WG_BK * 64 * 2;   // one 64-column w box, 8 KB
constexpr int WG_STAGE_BYTES = WG_X_BYTES + 2 * WG_WBOX_BYTES;
constexpr int WG_THREADS = 160;                 // one consumer warpgroup + a producer warp
// ring, 1024 bytes to align it by hand (128-byte swizzle), full and empty barriers
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024 + 2 * WG_STAGES * 8;

__global__ void __launch_bounds__(WG_THREADS, 2)
gmm_wgmma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
          __nv_bfloat16* __restrict__ o, int64_t soe, int64_t soc, int C, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t full = ring + WG_STAGES * WG_STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + WG_STAGES * 8;
  const int m0 = blockIdx.x * WG_BM;
  const int n0 = blockIdx.y * WG_BN;
  const int e = blockIdx.z;
  const int nk = (d + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 4);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(empty + 8 * s, (kt / WG_STAGES - 1) & 1);
        const uint32_t slot = ring + s * WG_STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, WG_STAGE_BYTES);
        tma_load_3d(slot, &tmx, full + 8 * s, kt * WG_BK, m0, e);
        tma_load_3d(slot + WG_X_BYTES, &tmw, full + 8 * s, n0, kt * WG_BK, e);
        tma_load_3d(slot + WG_X_BYTES + WG_WBOX_BYTES, &tmw, full + 8 * s, n0 + 64,
                    kt * WG_BK, e);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
    const uint32_t xs = ring + s * WG_STAGE_BYTES;
    const uint32_t ws = xs + WG_X_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // x: rows of 128 bytes, 8-row groups 1024 bytes apart; 16 k are 32 bytes.
      // w: k rows of 128 bytes (64 columns), 8-k groups 1024 bytes apart, the
      // second 64 columns in the next box; 16 k are 2048 bytes.
      const uint64_t da = sw128_desc(xs + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(ws + kk * 2048, WG_WBOX_BYTES, 1024);
      wgmma_m64n128k16_ss<1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the slot may be refilled
  }

  // accumulator layout of m64nNk16: warp w holds rows 16 w + lane / 4 (+ 8);
  // registers 4 j .. 4 j + 3 hold columns 8 j + 2 (lane % 4) (+ 1) of them
  __nv_bfloat16* op = o + e * soe;
  const int r0 = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= f) continue;  // f is a multiple of 8, so col + 1 < f too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < C)
        *reinterpret_cast<__nv_bfloat162*>(op + row * soc + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- host side

int launch_wgmma(const GmmArgs& a, int E, cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  const int64_t xdims[3] = {a.d, a.C, E}, xstrides[2] = {a.sxc, a.sxe};
  const int64_t wdims[3] = {a.f, a.d, E}, wstrides[2] = {a.swk, a.swe};
  CUtensorMap tmx, tmw;
  CUresult r = encode_bf16_boxes(enc, &tmx, a.x, 3, xdims, xstrides);
  if (r == CUDA_SUCCESS) r = encode_bf16_boxes(enc, &tmw, a.w, 3, wdims, wstrides);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(gmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.C + WG_BM - 1) / WG_BM, (a.f + WG_BN - 1) / WG_BN, E);
  gmm_wgmma<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(a.o), a.soe, a.soc, a.C, a.d, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT>
int launch_rows(const GmmArgs& a, int E, cudaStream_t stream) {
  dim3 grid((a.C + MT - 1) / MT, (a.f + SK_BN - 1) / SK_BN, E);
  gmm_rows<T, MT><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

enum Path : int { kRows = 0, kTiled = 1, kWgmma = 2 };

template <typename T>
int launch(const GmmArgs& a, int E, int path, cudaStream_t stream) {
  if (path == kRows) {
    if (a.C <= 4) return launch_rows<T, 4>(a, E, stream);
    if (a.C <= 8) return launch_rows<T, 8>(a, E, stream);
    return launch_rows<T, 16>(a, E, stream);
  }
  dim3 grid((a.f + TB_N - 1) / TB_N, (a.C + TB_M - 1) / TB_M, E);
  gmm_tiled<T><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// strides: 6 int64 in elements: x (e, c), w (e, k), out (e, c); the last
// axis of each is contiguous. vec = 1 when f % 8 == 0 and w's base and
// strides allow 16-byte loads (rows). path: 0 rows, 1 tiled, 2 wgmma (bf16
// only; the wrapper has checked TMA's alignment). Returns 0, a cudaError_t
// code, -1 for a dtype or path it does not take, -2 when the driver has no
// tensor-map encoder, or 10000 + the CUresult of a failed encode.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* o,
                           const int64_t* strides, int E, int C, int d, int f,
                           int dtype, int vec, int path, void* stream) {
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
  if (path == kWgmma) return dtype == kBF16 ? launch_wgmma(a, E, s) : -1;
  if (path != kRows && path != kTiled) return -1;
  if (dtype == kF32) return launch<float>(a, E, path, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, E, path, s);
  return -1;
}
