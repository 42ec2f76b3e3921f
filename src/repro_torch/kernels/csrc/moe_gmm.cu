// Grouped expert matmul for Hopper (sm_90a), forward and backward:
//   forward  out[e] = x[e] @ w[e]      x (E, C, d), w (E, d, f) -> (E, C, f)
//   dx       dx[e] = dy[e] @ w[e]^T    dy (E, C, f), w (E, d, f) -> (E, C, d)
//   dw       dw[e] = x[e]^T @ dy[e]    x (E, C, d), dy (E, C, f) -> (E, d, f)
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::_gmm_kernel
// (pl.pallas_call at :52): x (E, C, d) @ w (E, d, f) -> (E, C, f), summed in
// fp32 and written in x's dtype, for bf16 and fp32. The JAX model gets the
// two backward products by autodiff of its einsum; here they are the same
// kernels over other operand layouts. Each launch computes out (E, M, N) =
// A (E, M, K) @ B (E, K, N), A and B given by element strides on all three
// axes, and out contiguous along N:
//   layout  A                        B                        M  K  N
//   fwd     x, K-major               w, N-major               C  d  f
//   dx      dy, K-major              w read as w^T, K-major   C  f  d
//   dw      x read as x^T, M-major   dy, N-major              d  C  f
// (X-major: that axis is contiguous in memory.) No operand is copied or
// transposed in memory: wgmma reads each tile in whichever major-ness it has.
//
// What bounds it: every expert's weights are read once per call (forward,
// dx) or written once (dw), and each weight element serves 2*C flops. At
// phi3.5-moe's decode capacity (C = 4, E = 16, 4096 -> 6400) a call is 839
// MB of weights for 3.4 GFLOP: 0.25 ms at the HBM rate, bound by bytes. At
// the prefill capacity of a 1024-token prompt (C = 160) it is 134 GFLOP on
// the same bytes, 160 flops a byte, still under the card's ~295 bf16 ridge:
// 0.27 ms by bytes, but only if the products run on the tensor cores (fp32
// CUDA-core FMAs at 67 TFLOP/s would take 2 ms). The training capacity (C
// = 320) is 268 GFLOP: 0.27 ms of products, 0.28 ms of weight bytes.
//
// Design: three kernels; the wrapper (kernels/moe_gmm.py::route) picks one
// from the dtype, M and the TMA constraints before the launch and passes it
// here as `path`. Nothing falls back after a failure.
//  * wgmma (bf16, every stride a multiple of 16 bytes, 16-byte-aligned
//    bases): a grouped GEMM on the tensor cores. It beats the row kernel at
//    every capacity of chip_smoke.py phase 3d's sweep on the H100, C = 4 to
//    160, so it has no switch: it takes the decode step too, and the
//    CUDA-core kernels keep fp32 and the bf16 strides TMA cannot take. One
//    CTA per (BM rows of M, 128 columns of N, expert), row tiles fastest in
//    the grid so that the CTAs reading one B tile run together and share it
//    through L2. BM is fixed by the layout: 64 (one consumer warpgroup) for
//    the forward and dx, 128 (two, sharing each B tile: fewer operand bytes
//    per output) for dw, whose contraction over C is short and whose output
//    is a whole weight. One producer warp has one thread issue TMA loads
//    (3-D tensor maps over the (E, ., .) operands, so a box never crosses an
//    expert and TMA zero-fills the tails of M, K and N) into a ring of
//    slots: BM/64 A boxes and two B boxes of 64 x 64 under the 128-byte
//    swizzle. Each slot has a full mbarrier armed with expect_tx and an
//    empty mbarrier the consumer warps arrive on after wgmma.wait_group has
//    retired the products that read it. Each consumer warpgroup issues
//    wgmma m64n128k16 (bf16 x bf16 -> fp32) with both operands in shared
//    memory, A and B each flagged K- or MN-major as the layout has them, 64
//    fp32 accumulators a thread, then rounds them to bf16 (as astype),
//    stages its tile in the idle ring and writes it in 16-byte stores that
//    cover whole 256-byte rows, masked by M and N. A bf16 x bf16 product is
//    exact in fp32, so this is the Pallas kernel's function up to the order
//    of the sum.
//  * rows (fp32, or bf16 that TMA cannot take, M <= 32): one CTA per (tile
//    of MT rows, 256 columns of N, expert), MT = 4, 8 or 16 as M asks. Its
//    8 warps split the contraction K; each lane owns 8 consecutive columns
//    and loads them with one 16-byte vector load (bf16) or two (fp32) where
//    B is N-major, else one element at a time. The MT rows' sums stay in
//    registers; A streams through shared memory in chunks of K; the warps'
//    partial sums are added through shared memory. Row tiles are the grid's
//    fastest axis, as above.
//  * tiled (fp32, or bf16 that TMA cannot take, M > 32): one CTA of 256
//    threads per (128 columns, 64 rows, expert) output tile; 16-deep K
//    tiles of A (transposed) and B are staged in shared memory as fp32 and
//    multiplied with fp32 FMAs on the CUDA cores.
// The rows/tiled switch at M = 32 is where those two cross on the H100
// (chip_smoke.py phase 3d's capacity sweep). The two CUDA-core kernels mask
// the tails of M, K and N by hand: no dimension needs to divide a tile,
// where the Pallas kernel asserts divisibility.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

struct GmmArgs {
  const void* a;
  const void* b;
  void* o;
  int64_t sae, sam, sak;  // A (e, m, k)
  int64_t sbe, sbk, sbn;  // B (e, k, n)
  int64_t soe, som;       // out (e, m); n is contiguous
  int M, K, N;
  int vec;  // 1: B is N-major and its rows allow 16-byte loads of a lane's 8 columns
};

// ---------------------------------------------------------------- rows

constexpr int SK_CPL = 8;              // columns per lane
constexpr int SK_BN = 32 * SK_CPL;     // columns per CTA
constexpr int SK_KC = 256;             // A chunk along K

// a lane's SK_CPL columns of one B row, sn elements apart
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float* out,
                                          int n_left, bool vec, int64_t sn) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  if (vec && n_left >= SK_CPL) {
#pragma unroll
    for (int i = 0; i < SK_CPL; i += V) load_row<T, V>(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < SK_CPL; ++i) out[i] = i < n_left ? to_f<T>(p[i * sn]) : 0.f;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT) gmm_rows(const GmmArgs a) {
  __shared__ float xs[MT][SK_KC];
  __shared__ float red[MT][SK_CPL][32];  // [row][column in lane][lane]

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * MT;
  const int rows = min(MT, a.M - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * SK_BN + lane * SK_CPL;
  const int n_left = a.N - n0;
  const T* ap = static_cast<const T*>(a.a) + e * a.sae + m0 * a.sam;
  const T* bp = static_cast<const T*>(a.b) + e * a.sbe + n0 * a.sbn;

  float acc[MT][SK_CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < SK_CPL; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += SK_KC) {
    __syncthreads();  // the last chunk of A is consumed
    for (int i = threadIdx.x; i < MT * SK_KC; i += NT) {
      const int m = i / SK_KC, k = i % SK_KC;
      xs[m][k] = m < rows && k0 + k < a.K ? to_f<T>(ap[m * a.sam + (k0 + k) * a.sak]) : 0.f;
    }
    __syncthreads();
    const int kn = min(SK_KC, a.K - k0);
    if (n_left > 0) {
#pragma unroll 4
      for (int k = warp; k < kn; k += NW) {
        float wv[SK_CPL];
        load_cols<T>(bp + static_cast<int64_t>(k0 + k) * a.sbk, wv, n_left, a.vec, a.sbn);
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

  T* op = static_cast<T*>(a.o) + e * a.soe + m0 * a.som;
  for (int i = threadIdx.x; i < MT * SK_BN; i += NT) {
    const int m = i / SK_BN, c = i % SK_BN;
    const int n = blockIdx.y * SK_BN + c;
    if (m < rows && n < a.N)
      op[m * a.som + n] = from_f<T>(red[m][c % SK_CPL][c / SK_CPL]);
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
  __shared__ float xs[TB_K][TB_M + 1];  // A tile, transposed
  __shared__ float ws[TB_K][TB_N];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TB_M;
  const int n0 = blockIdx.x * TB_N;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* ap = static_cast<const T*>(a.a) + e * a.sae;
  const T* bp = static_cast<const T*>(a.b) + e * a.sbe;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += TB_K) {
    __syncthreads();  // the last tiles are consumed
    for (int i = threadIdx.x; i < TB_M * TB_K; i += NT) {
      const int m = i / TB_K, k = i % TB_K;
      xs[k][m] = m0 + m < a.M && k0 + k < a.K
                     ? to_f<T>(ap[(m0 + m) * a.sam + (k0 + k) * a.sak]) : 0.f;
    }
    for (int i = threadIdx.x; i < TB_K * TB_N; i += NT) {
      const int k = i / TB_N, n = i % TB_N;
      ws[k][n] = k0 + k < a.K && n0 + n < a.N
                     ? to_f<T>(bp[(k0 + k) * a.sbk + (n0 + n) * a.sbn]) : 0.f;
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
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.N) op[m * a.som + n] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- wgmma

constexpr int WG_BN = 128;                 // columns of N per CTA (wgmma N)
constexpr int WG_BK = 64;                  // k per ring slot: 128 bytes of bf16
constexpr int WG_BOX_BYTES = 64 * 64 * 2;  // one 64 x 64 bf16 box, 8 KB

// The tile of WGS consumer warpgroups: BM = 64 WGS rows of M, a ring of
// STAGES slots (each WGS A boxes and two B boxes), one producer warp. Both
// sizes fit two CTAs an SM: 4 x 24 KB and 3 x 32 KB of ring.
template <int WGS>
struct WgTile {
  static constexpr int BM = 64 * WGS;
  static constexpr int A_BYTES = WGS * WG_BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * WG_BOX_BYTES;
  static constexpr int STAGES = WGS == 1 ? 4 : 3;
  static constexpr int THREADS = 128 * WGS + 32;
  // ring, 1024 bytes to align it by hand (128-byte swizzle), full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// bytes per row of the output tile staged in shared memory: 128 bf16 and
// 16 bytes of padding, so the accumulators' stores hit 32 distinct banks
constexpr int WG_STAGE_PITCH = WG_BN * 2 + 16;

// TRANS_A: A is M-major (dw's x^T), else K-major; TRANS_B: B is N-major
// (the forward's w, dw's dy), else K-major (dx's w^T).
template <int TRANS_A, int TRANS_B, int WGS>
__global__ void __launch_bounds__(WgTile<WGS>::THREADS, 2)
gmm_wgmma(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
          __nv_bfloat16* __restrict__ o, int64_t soe, int64_t som, int M, int K, int N) {
  using Tile = WgTile<WGS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t full = ring + Tile::STAGES * Tile::STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + Tile::STAGES * 8;
  const int m0 = blockIdx.x * Tile::BM;
  const int n0 = blockIdx.y * WG_BN;
  const int e = blockIdx.z;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 4 * WGS);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % Tile::STAGES;
        if (kt >= Tile::STAGES) mbar_wait(empty + 8 * s, (kt / Tile::STAGES - 1) & 1);
        const uint32_t slot = ring + s * Tile::STAGE_BYTES;
        const uint32_t bar = full + 8 * s;
        const int k = kt * WG_BK;
        mbar_expect_tx(bar, Tile::STAGE_BYTES);
        // A box g: rows m0 + 64 g .. + 63 of M, k .. k + 63 of K
#pragma unroll
        for (int g = 0; g < WGS; ++g) {
          if (TRANS_A) tma_load_3d(slot + g * WG_BOX_BYTES, &tma, bar, m0 + 64 * g, k, e);
          else tma_load_3d(slot + g * WG_BOX_BYTES, &tma, bar, k, m0 + 64 * g, e);
        }
        // B box h: columns n0 + 64 h .. + 63 of N
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t dst = slot + Tile::A_BYTES + h * WG_BOX_BYTES;
          if (TRANS_B) tma_load_3d(dst, &tmb, bar, n0 + 64 * h, k, e);
          else tma_load_3d(dst, &tmb, bar, k, n0 + 64 * h, e);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warp's consumer warpgroup: rows m0 + 64 wg ..
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Tile::STAGES;
    mbar_wait(full + 8 * s, (kt / Tile::STAGES) & 1);
    const uint32_t as = ring + s * Tile::STAGE_BYTES + wg * WG_BOX_BYTES;
    const uint32_t bs = ring + s * Tile::STAGE_BYTES + Tile::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // K-major: rows (of M or N) of 128 bytes (64 k), 8-row groups 1024
      // bytes apart; 16 k are 32 bytes. B's 128 rows are its two boxes, one
      // after the other.
      // MN-major: k rows of 128 bytes (64 of M or N), 8-k groups 1024 bytes
      // apart, the next 64 of M or N in the next box; 16 k are 2048 bytes.
      const uint64_t da = TRANS_A ? sw128_desc(as + kk * 2048, WG_BOX_BYTES, 1024)
                                  : sw128_desc(as + kk * 32, 16, 1024);
      const uint64_t db = TRANS_B ? sw128_desc(bs + kk * 2048, WG_BOX_BYTES, 1024)
                                  : sw128_desc(bs + kk * 32, 16, 1024);
      wgmma_m64n128k16_ss<TRANS_B, TRANS_A>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the slot may be refilled
  }

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); registers 4 j .. 4 j + 3 hold columns
  // 8 j + 2 (lane % 4) (+ 1) of them
  __nv_bfloat16* op = o + e * soe;
  // every slot's loads have landed and been read: once all consumer warps
  // are past their last product, the ring holds the warpgroups' tiles
  named_barrier_sync(1, 128 * WGS);
  uint8_t* stage = smem_raw + (ring - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)))
                   + wg * 64 * WG_STAGE_PITCH;
  const int rs = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(stage + (rs + 8 * h) * WG_STAGE_PITCH +
                                         2 * (8 * j + 2 * (lane & 3))) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  named_barrier_sync(1, 128 * WGS);
  // 16 threads cover a row's 256 bytes; N is a multiple of 8, so a
  // 16-byte chunk lies wholly inside or outside it
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int it = 0; it < 64 * (WG_BN / 8) / 128; ++it) {
    const int row = it * 8 + (t >> 4), chunk = t & 15;
    const int grow = m0 + 64 * wg + row, gcol = n0 + 8 * chunk;
    if (grow < M && gcol < N)
      *reinterpret_cast<uint4*>(op + grow * som + gcol) =
          *reinterpret_cast<const uint4*>(stage + row * WG_STAGE_PITCH + 16 * chunk);
  }
}

// ------------------------------------------------------------- host side

enum Layout : int { kFwd = 0, kDx = 1, kDw = 2 };
enum Path : int { kRows = 0, kTiled = 1, kWgmma = 2 };

template <int TRANS_A, int TRANS_B, int WGS>
int launch_wgmma_tile(const GmmArgs& a, int E, const CUtensorMap& tma, const CUtensorMap& tmb,
                      cudaStream_t stream) {
  using Tile = WgTile<WGS>;
  static_assert(WGS * 64 * WG_STAGE_PITCH <= Tile::STAGES * Tile::STAGE_BYTES,
                "the staged output tile must fit in the ring");
  auto kernel = gmm_wgmma<TRANS_A, TRANS_B, WGS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.M + Tile::BM - 1) / Tile::BM, (a.N + WG_BN - 1) / WG_BN, E);
  kernel<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
      tma, tmb, static_cast<__nv_bfloat16*>(a.o), a.soe, a.som, a.M, a.K, a.N);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const GmmArgs& a, int E, int layout, cudaStream_t stream) {
  // the unit-stride axis each layout reads along
  const bool trans_a = layout == kDw, trans_b = layout != kDx;
  if ((trans_a ? a.sam : a.sak) != 1 || (trans_b ? a.sbn : a.sbk) != 1) return -1;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  // dims innermost first: the contiguous axis, the other matrix axis, E
  const int64_t adims[3] = {trans_a ? a.M : a.K, trans_a ? a.K : a.M, E};
  const int64_t astrides[2] = {trans_a ? a.sak : a.sam, a.sae};
  const int64_t bdims[3] = {trans_b ? a.N : a.K, trans_b ? a.K : a.N, E};
  const int64_t bstrides[2] = {trans_b ? a.sbk : a.sbn, a.sbe};
  CUtensorMap tma, tmb;
  CUresult r = encode_bf16_boxes(enc, &tma, a.a, 3, adims, astrides);
  if (r == CUDA_SUCCESS) r = encode_bf16_boxes(enc, &tmb, a.b, 3, bdims, bstrides);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  // each layout's tile (see Design)
  if (layout == kFwd) return launch_wgmma_tile<0, 1, 1>(a, E, tma, tmb, stream);
  if (layout == kDx) return launch_wgmma_tile<0, 0, 1>(a, E, tma, tmb, stream);
  return launch_wgmma_tile<1, 1, 2>(a, E, tma, tmb, stream);
}

template <typename T, int MT>
int launch_rows(const GmmArgs& a, int E, cudaStream_t stream) {
  dim3 grid((a.M + MT - 1) / MT, (a.N + SK_BN - 1) / SK_BN, E);
  gmm_rows<T, MT><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const GmmArgs& a, int E, int path, cudaStream_t stream) {
  if (path == kRows) {
    if (a.M <= 4) return launch_rows<T, 4>(a, E, stream);
    if (a.M <= 8) return launch_rows<T, 8>(a, E, stream);
    return launch_rows<T, 16>(a, E, stream);
  }
  dim3 grid((a.N + TB_N - 1) / TB_N, (a.M + TB_M - 1) / TB_M, E);
  gmm_tiled<T><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// out (E, M, N) = A (E, M, K) @ B (E, K, N). strides: 8 int64 in elements:
// A (e, m, k), B (e, k, n), out (e, m); out's n axis is contiguous. layout:
// 0 forward, 1 dx, 2 dw (the table above: which axis of A and B is
// contiguous, for the tensor-core kernel; the CUDA-core kernels take any
// strides). vec = 1 when B is N-major, N % 8 == 0 and B's base and strides
// allow 16-byte loads (rows). path: 0 rows, 1 tiled, 2 the tensor-core
// kernel (bf16 only; the wrapper has checked TMA's alignment). Returns 0, a
// cudaError_t code, -1 for a dtype, path or layout
// it does not take, -2 when the driver has no tensor-map encoder, or 10000 +
// the CUresult of a failed encode.
extern "C" int moe_gmm_run(const void* a, const void* b, void* o, const int64_t* strides,
                           int E, int M, int K, int N, int dtype, int vec, int path,
                           int layout, void* stream) {
  using namespace repro;
  if (E == 0 || M == 0 || N == 0) return 0;
  if (layout < kFwd || layout > kDw) return -1;
  GmmArgs g;
  g.a = a; g.b = b; g.o = o;
  g.sae = strides[0]; g.sam = strides[1]; g.sak = strides[2];
  g.sbe = strides[3]; g.sbk = strides[4]; g.sbn = strides[5];
  g.soe = strides[6]; g.som = strides[7];
  g.M = M; g.K = K; g.N = N;
  g.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kWgmma) return dtype == kBF16 ? launch_wgmma(g, E, layout, s) : -1;
  if (path != kRows && path != kTiled) return -1;
  if (dtype == kF32) return launch<float>(g, E, path, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(g, E, path, s);
  return -1;
}
