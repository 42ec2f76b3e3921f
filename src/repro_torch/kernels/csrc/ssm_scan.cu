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
// Two kernels compute it; the wrapper (kernels/ssm_scan.py::route) picks one
// before the launch.
//
// "mma", fp32 inputs TMA can read, P = N = 64, Q a multiple of 64 up to 256
// (zamba2-2.7b's prefill). What bounds it: about 12.6 MFLOP a (chunk, head,
// batch row) of causal products against 33 KB of x, B and C read and 16 KB
// of y written, a few hundred flops a byte, so the products; at fp32 they
// must keep fp32's precision, as every product of the Pallas kernel does,
// which takes three TF32 passes. In this design shared memory is the
// likely limit: the splits below and the products' operand reads both go
// through it, and on the H100 their times add up instead of overlapping.
// Design: the sequential chunk axis becomes parallel work plus a small
// recurrence, in three launches on the caller's stream:
//   (a) ssd_chunk_tc, one CTA per (chunk, head, batch row): la (a warp
//       prefix scan, written once to an fp32 workspace so that every later
//       CTA reads the same bits) and the chunk's own state contribution
//       dS_c = x^T (B exp(clip(la_end - la, -60, 0)) dt), P x N with K = Q;
//   (b) ssd_state_tc, one thread per 4 elements of P x N: S_c =
//       exp(la_end,c-1) S_c-1 + dS_c-1 in the reference's fp32 order,
//       written over dS in the workspace (the state entering each chunk),
//       and the final state. It is not fused into (c): a CTA of (c) would
//       have to walk every earlier chunk's dS, reads that grow as nc^2;
//   (c) ssd_out_tc, one CTA per (64-row tile, chunk, head, batch row), last
//       row tiles first: flash-shaped, with C the query, B the key and x the
//       value. Scores C_tile B^T come for the key tiles up to the diagonal,
//       are scaled in registers by the decay and dt and masked on the
//       diagonal (no softmax), then W x is added to (C_tile S_prev^T)
//       exp(la_t).
// The products run on the tensor cores as wgmma m64n64k8 tf32 in 3xTF32:
// each fp32 operand a splits into hi = tf32(a) and lo = tf32(a - hi), and
// a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, summed in fp32, which keeps
// fp32-grade precision where one TF32 pass keeps about three digits. A tf32
// wgmma reads only K-major operands, so each raw tile that TMA brings
// (64 rows x 64 fp32, two 32-column boxes under the 128-byte swizzle) is
// split once, by the CTA's consumer warpgroup, into a hi and a lo copy in
// shared memory, K-major under the same swizzle; x (and, in (a), B w) is
// split transposed, since every product that reads it sums over keys. No
// operand is split twice. C's fragments are split once into registers, the
// register A operand of the tile's score and inter-chunk products. The
// register A fragment does not lay out as the accumulator (columns t4 and
// t4 + 4 against 2 t4 and 2 t4 + 1), but a sum over k does not care which
// key sits in which k slot: x^T's columns hold an 8-key group's key 2 t in
// column t and key 2 t + 1 in column t + 4, so the scores are the A operand
// of W x as they lie. A CTA is one
// warpgroup and one TMA slot (two raw tiles, one mbarrier whose wait traps
// if stuck): thread 0 reloads the slot as soon as the warpgroup has split
// what it held, so the next load overlaps the products, and in (c) x is
// split while the tensor cores run the scores. There is no producer warp: a
// fifth warp would cap the registers at 168 a thread (three warps on one SM
// sub-partition at two CTAs an SM), and the products then spill. 4-D maps
// over (B, T, H, P) and (B, T, G, N) read the model's tensors in place
// through their strides. dt (its T axis strided) and the la workspace are
// read with plain loads. The wrapper allocates the workspaces (dS, B x H x
// nc x P x N fp32; la, B x H x T fp32) and hands over plan's grids; the host
// reads nothing from the device.
//
// "simt", the first version, for bf16 and for what TMA cannot read: one CTA
// of 256 threads per (head, batch row) walks the chunks in a loop with S in
// shared memory: HBM sees x, dt, B and C once, y once and S once. A chunk's
// B and x are staged in shared memory as fp32 (pitch N + 1 for B, so the
// score products read it without bank conflicts), la is a warp prefix scan,
// and the intra-chunk term runs in blocks of 32 rows: the 32 x s_end score
// block (only keys up to the block's last row are computed) goes to shared
// memory with its decay, dt and causal mask applied, and is then applied to
// x together with the inter-chunk term. The state update follows once every
// row of the chunk has read the old S. Products in fp32 on the CUDA cores.
// Grid (H, B). Limits: Q <= 256, P <= 64, N <= 64.
//
// Layout: x and y (B, H, T, P), dt (B, H, T), B/C (B, G, T, N) given by
// strides in elements with the last axis contiguous, so the model's
// (B, T, H, P) tensors are read and written in place; A (H,) and dt are
// fp32.
#include "common.cuh"
#include "hopper.cuh"

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
  // the tensor-core path's workspaces: dS, then the state entering each
  // chunk (B, H, nc, P, N), and la (B, H, T); fp32, contiguous
  float* ds;
  float* la;
  int B, nc;
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

// ------------------------------------------------------- tensor-core path

constexpr int TC_ROWS = 64;                        // rows of a tile
constexpr int TC_DIM = 64;                         // P = N
constexpr int TC_WARPS = 4;                        // one warpgroup, 16 rows a warp
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_QMAX = 256;
constexpr int TC_BOX_BYTES = TC_ROWS * 128;        // 64 rows x 32 fp32
constexpr int TC_TILE_BYTES = 2 * TC_BOX_BYTES;    // 64 rows x 64 fp32
constexpr int TC_TILE_FLOATS = TC_TILE_BYTES / 4;
constexpr int TC_STATE_THREADS = 256;              // ssd_state_tc: 4 elements each
// Shared memory of both passes: 1024 bytes to align the tiles by hand (the
// swizzle's period); the TMA slot (two raw fp32 tiles); four split tiles
// (hi and lo of two operands); then two fp32 arrays of Q and the slot's
// barrier.
constexpr int TC_SLOT = 0;
constexpr int TC_SPLIT = 2 * TC_TILE_BYTES;             // XH, XL, BH, BL
constexpr int TC_ARRAYS = TC_SPLIT + 4 * TC_TILE_BYTES;
constexpr int TC_SMEM = 1024 + TC_ARRAYS + 2 * TC_QMAX * 4 + 8;

// Byte offset of the 16-byte chunk q (0..15) of row r of a 64 x 64 fp32 tile
// held as two 64 x 32 boxes under the 128-byte swizzle: chunk q % 8 of row
// r sits at chunk (q % 8) ^ (r % 8) of the row's 128 bytes.
__device__ __forceinline__ uint32_t sw_off(int r, int q) {
  return ((q >> 3) << 13) + (r << 7) + (((q & 7) ^ (r & 7)) << 4);
}

// The float index of element (r, c) of such a tile.
__device__ __forceinline__ int sw_idx(int r, int c) {
  return (c >> 5) * (TC_ROWS * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// 3xTF32's split: hi = tf32(v) (round to nearest), lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// Four 8 x 4 fp32 blocks (8 x 8 b16 matrices to ldmatrix), one 16-byte row
// address from each lane: lane l gets element l % 4 of row l / 4 of block k
// in register k.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The tf32 register A fragment (wgmma's, as m16n8k8's) of rows m0 .. m0 + 15,
// k 8 kk .. 8 kk + 7 of a K-contiguous tile: (gq, t4), (gq + 8, t4),
// (gq, t4 + 4), (gq + 8, t4 + 4) with gq = lane / 4, t4 = lane % 4.
__device__ __forceinline__ void ld_a(uint32_t tile, int m0, int kk, int lane, uint32_t (&a)[4]) {
  const int blk = lane >> 3;
  ldsm_x4(tile + sw_off(m0 + (lane & 7) + ((blk & 1) << 3), 2 * kk + (blk >> 1)), a);
}

// The wgmma descriptor of k-step kk (8 tf32, 32 bytes) of a 64-row,
// K-contiguous split tile: 8-row groups 1024 bytes apart, the next 32 k
// the next box.
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * TC_BOX_BYTES + (kk & 3) * 32, 16, 1024);
}

// d += A @ B over k = 64 in 3xTF32, the small terms first: A's hi and lo
// in registers (k-step kk in ah[kk], al[kk]), B's in the split tiles bh, bl.
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[32], const uint32_t (&ah)[8][4],
                                                const uint32_t (&al)[8][4], uint32_t bh,
                                                uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dh = k_desc(bh, kk), dl = k_desc(bl, kk);
    wgmma_m64n64k8_tf32_rs(d, al[kk], dh, 1);
    wgmma_m64n64k8_tf32_rs(d, ah[kk], dl, 1);
    wgmma_m64n64k8_tf32_rs(d, ah[kk], dh, 1);
  }
}

// Keep A's registers (read by the products in flight) from reuse until the
// wait: call after wgmma_wait_all.
__device__ __forceinline__ void fence_a(uint32_t (&ah)[8][4], uint32_t (&al)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    fence_regs(ah[kk]);
    fence_regs(al[kk]);
  }
}

// hi and lo of a raw 64 x 64 tile, element for element (the same layout);
// by the TC_THREADS threads.
__device__ __forceinline__ void split_tile(const float* src, uint32_t* hi, uint32_t* lo,
                                           int tid) {
#pragma unroll
  for (int k = 0; k < TC_TILE_FLOATS / 4 / TC_THREADS; ++k) {
    const int f = tid + TC_THREADS * k;
    const float4 v = reinterpret_cast<const float4*>(src)[f];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[f] = h;
    reinterpret_cast<uint4*>(lo)[f] = l;
  }
}

// hi and lo of the transpose of a raw 64 x 64 tile (rows: keys), each
// element times w[key] when W: element (key, c) goes to row c, column
// slot(key), where an 8-key group's key 2 t sits in column t and key
// 2 t + 1 in column t + 4. That is the k order in which the scores lie in
// the wgmma accumulator (columns 2 t4, 2 t4 + 1 of each 8), so they are the
// register A operand of W x as they lie (its columns t4, t4 + 4); x^T and
// (B w)^T of the state update take the same order on both operands. Warp w
// writes columns 16 w .. 16 w + 15; each of its stores covers 8 rows x 4
// columns of the destination and each load 8 columns x 4 keys of the
// source, so neither has a bank conflict under the swizzle, and all but
// the lane's and the warp's part of each address is known at compile time.
template <bool W>
__device__ __forceinline__ void split_tile_t(const float* src, uint32_t* hi, uint32_t* lo,
                                             const float* w, int warp, int lane) {
  const int cl = lane & 7, pl = lane >> 3;
#pragma unroll
  for (int k = 0; k < TC_TILE_FLOATS / TC_THREADS; ++k) {
    const int c = 8 * (k & 7) + cl;
    const int t = (4 * (k >> 3) + pl) & 7;
    const int pos = 16 * warp + 4 * (k >> 3) + pl;
    const int key = (pos & ~7) + (t < 4 ? 2 * t : 2 * t - 7);
    float v = src[sw_idx(key, c)];
    if (W) v *= w[key];
    uint32_t h, l;
    split_tf32(v, h, l);
    const int dst = sw_idx(c, pos);
    hi[dst] = h;
    lo[dst] = l;
  }
}

// (a) la and the chunk's own state contribution dS_c = x^T (B w), w =
// exp(clip(la_end - la, -60, 0)) dt. Grid (nc, H, B).
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_chunk_tc(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmb,
             const SsdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_p = smem_raw + (base - raw);
  const uint32_t slot = base + TC_SLOT;              // raw x, then raw B
  const uint32_t xh = base + TC_SPLIT;               // (x^T) hi, lo; ((B w)^T) hi, lo
  const uint32_t xl = xh + TC_TILE_BYTES;
  const uint32_t bh = xl + TC_TILE_BYTES;
  const uint32_t bl = bh + TC_TILE_BYTES;
  const float* raw_x = reinterpret_cast<const float*>(base_p + TC_SLOT);
  const float* raw_b = raw_x + TC_TILE_FLOATS;
  uint32_t* split_p = reinterpret_cast<uint32_t*>(base_p + TC_SPLIT);
  float* las = reinterpret_cast<float*>(base_p + TC_ARRAYS);   // [QMAX]
  float* wst = las + TC_QMAX;                                   // [QMAX]
  const uint32_t full = base + TC_ARRAYS + 2 * TC_QMAX * 4;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int Q = a.Q;
  const int t0 = c * Q;
  const int n_tiles = Q / TC_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // thread 0 loads x and B tile it into the slot, once the slot is free:
  // first at the start, then as soon as the tile before is split
  auto load = [&](int it) {
    const int r0 = t0 + it * TC_ROWS;
    mbar_expect_tx(full, 2 * TC_TILE_BYTES);
    for (int k = 0; k < 2; ++k) {
      tma_load_4d(slot + k * TC_BOX_BYTES, &tmx, full, 32 * k, r0, h, b);
      tma_load_4d(slot + TC_TILE_BYTES + k * TC_BOX_BYTES, &tmb, full, 32 * k, r0, g, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(full, 1);   // the expect_tx arrival
    mbar_init_fence();
    load(0);
  }

  // la = cumsum(dt * A) over the chunk, 32 steps at a time (warp 0)
  const float* dtp = a.dt + b * a.sdb + h * a.sdh;
  if (warp == 0) {
    const float A = a.A[h];
    float carry = 0.f;
    for (int base_s = 0; base_s < Q; base_s += 32) {
      const int s = base_s + lane;
      float v = dtp[static_cast<int64_t>(t0 + s) * a.sdt] * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      las[s] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();   // la; the barrier's initialisation
  const float la_end = las[Q - 1];
  float* lap = a.la + (static_cast<int64_t>(b) * a.H + h) * a.T + t0;
  for (int s = threadIdx.x; s < Q; s += TC_THREADS) {
    wst[s] = clip_exp(la_end - las[s]) * dtp[static_cast<int64_t>(t0 + s) * a.sdt];
    lap[s] = las[s];
  }
  __syncthreads();

  // dS rows p = 16 warp + gq (+ 8), columns n = 8 j + 2 t4 (+ 1) in acc[4 j ..]
  const int gq = lane >> 2, t4 = lane & 3;
  const int p0 = 16 * warp;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(full, it & 1);
    split_tile_t<false>(raw_x, split_p, split_p + TC_TILE_FLOATS, nullptr, warp, lane);
    split_tile_t<true>(raw_b, split_p + 2 * TC_TILE_FLOATS, split_p + 3 * TC_TILE_FLOATS,
                       wst + it * TC_ROWS, warp, lane);
    fence_view_async();   // the split tiles, to the tensor cores
    __syncthreads();      // split; the slot is read
    if (threadIdx.x == 0 && it + 1 < n_tiles) load(it + 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 8; ++kk) {
      const uint64_t ah = k_desc(xh, kk), al = k_desc(xl, kk);
      const uint64_t bhd = k_desc(bh, kk), bld = k_desc(bl, kk);
      wgmma_m64n64k8_tf32_ss(acc, al, bhd, 1);
      wgmma_m64n64k8_tf32_ss(acc, ah, bld, 1);
      wgmma_m64n64k8_tf32_ss(acc, ah, bhd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();   // the split tiles are read
  }
  float* dsp = a.ds + ((static_cast<int64_t>(b) * a.H + h) * a.nc + c) * (TC_DIM * TC_DIM);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(dsp + (p0 + gq) * TC_DIM + n) = make_float2(acc[4 * j],
                                                                           acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dsp + (p0 + gq + 8) * TC_DIM + n) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// (b) the state entering each chunk, over dS in place, and the final state:
// S_0 = 0, S_c+1 = exp(la_end,c) S_c + dS_c, each a product then a sum in
// fp32 as the reference rounds them. Grid (P N / (4 TC_STATE_THREADS), H, B).
// The loads of 4 chunks go out before their sums, so they overlap.
__global__ void __launch_bounds__(TC_STATE_THREADS) ssd_state_tc(const SsdArgs a) {
  constexpr int kBatch = 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * TC_STATE_THREADS + threadIdx.x;  // float4 index in P x N
  constexpr int per_chunk = TC_DIM * TC_DIM / 4;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  float4* ds = reinterpret_cast<float4*>(a.ds + bh * a.nc * (TC_DIM * TC_DIM)) + e;
  const float* lap = a.la + bh * a.T + a.Q - 1;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float4 d[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < a.nc) {
        d[k] = ds[(c0 + k) * per_chunk];
        decay[k] = lap[static_cast<int64_t>(c0 + k) * a.Q];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < a.nc) {
        ds[(c0 + k) * per_chunk] = S;
        const float dk = expf(decay[k]);
        S.x = __fadd_rn(__fmul_rn(dk, S.x), d[k].x);
        S.y = __fadd_rn(__fmul_rn(dk, S.y), d[k].y);
        S.z = __fadd_rn(__fmul_rn(dk, S.z), d[k].z);
        S.w = __fadd_rn(__fmul_rn(dk, S.w), d[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(a.s_out + bh * (TC_DIM * TC_DIM))[e] = S;
}

// (c) y of one 64-row tile of a chunk. Grid (nc Q / 64, H, B): x runs over a
// chunk's row tiles from the last (the most key tiles), then the chunks, so
// the CTAs that read a chunk's x and B tiles run together and share them
// in L2.
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_out_tc(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmb,
           const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms,
           const SsdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_p = smem_raw + (base - raw);
  const uint32_t slot = base + TC_SLOT;              // raw x | B, first raw C | S
  const uint32_t xh = base + TC_SPLIT;               // (x^T) hi, lo; B (first S) hi, lo
  const uint32_t xl = xh + TC_TILE_BYTES;
  const uint32_t bh = xl + TC_TILE_BYTES;
  const uint32_t bl = bh + TC_TILE_BYTES;
  const float* raw_x = reinterpret_cast<const float*>(base_p + TC_SLOT);   // or C
  const float* raw_b = raw_x + TC_TILE_FLOATS;                             // or S
  uint32_t* split_p = reinterpret_cast<uint32_t*>(base_p + TC_SPLIT);
  float* las = reinterpret_cast<float*>(base_p + TC_ARRAYS);   // [QMAX] la of the chunk
  float* dts = las + TC_QMAX;                                   // [QMAX] dt of the chunk
  const uint32_t full = base + TC_ARRAYS + 2 * TC_QMAX * 4;

  const int n_rt = a.Q / TC_ROWS;
  const int c = blockIdx.x / n_rt, h = blockIdx.y, b = blockIdx.z;
  const int i = n_rt - 1 - static_cast<int>(blockIdx.x) % n_rt;  // row tile; keys 0 .. i
  const int g = h / (a.H / a.G);
  const int c0 = c * a.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // thread 0 loads key tile it (x and B) into the slot, once the slot is
  // free: as soon as what it held before is split
  auto load = [&](int it) {
    const int r0 = c0 + it * TC_ROWS;
    mbar_expect_tx(full, 2 * TC_TILE_BYTES);
    for (int k = 0; k < 2; ++k) {
      tma_load_4d(slot + k * TC_BOX_BYTES, &tmx, full, 32 * k, r0, h, b);
      tma_load_4d(slot + TC_TILE_BYTES + k * TC_BOX_BYTES, &tmb, full, 32 * k, r0, g, b);
    }
  };
  if (threadIdx.x == 0) {  // C (and S) first
    mbar_init(full, 1);
    mbar_init_fence();
    mbar_expect_tx(full, c > 0 ? 2 * TC_TILE_BYTES : TC_TILE_BYTES);
    const int sidx = (b * a.H + h) * a.nc + c;
    for (int k = 0; k < 2; ++k) {
      tma_load_4d(slot + k * TC_BOX_BYTES, &tmc, full, 32 * k, c0 + i * TC_ROWS, g, b);
      if (c > 0) tma_load_3d(slot + TC_TILE_BYTES + k * TC_BOX_BYTES, &tms, full, 32 * k, 0,
                             sidx);
    }
  }

  // la and dt of the chunk's rows up to this tile's last
  const float* lap = a.la + (static_cast<int64_t>(b) * a.H + h) * a.T + c0;
  const float* dtp = a.dt + b * a.sdb + h * a.sdh;
  for (int s = threadIdx.x; s < (i + 1) * TC_ROWS; s += TC_THREADS) {
    las[s] = lap[s];
    dts[s] = dtp[static_cast<int64_t>(c0 + s) * a.sdt];
  }

  // this thread's rows of the chunk: tr and tr + 8
  const int gq = lane >> 2, t4 = lane & 3;
  const int tr = i * TC_ROWS + 16 * warp + gq;

  // C's A fragments, split once, for every product of the tile; S's hi and
  // lo into the B tiles for the inter-chunk term
  __syncthreads();   // the barrier's initialisation
  mbar_wait(full, 0);
  uint32_t ch[8][4], cl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t v[4];
    ld_a(slot, 16 * warp, kk, lane, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(v[e]), ch[kk][e], cl[kk][e]);
  }
  if (c > 0) split_tile(raw_b, split_p + 2 * TC_TILE_FLOATS, split_p + 3 * TC_TILE_FLOATS,
                        threadIdx.x);
  fence_view_async();   // S's split tiles, to the tensor cores
  __syncthreads();      // split, and la and dt in place; the slot is read
  if (threadIdx.x == 0) load(0);
  const float la0 = las[tr], la1 = las[tr + 8];

  float y[32];  // y (tr (+ 8), 8 jp + 2 t4 (+ 1)) in y[4 jp ..]
#pragma unroll
  for (int e = 0; e < 32; ++e) y[e] = 0.f;
  if (c > 0) {  // the inter-chunk term (C S_prev^T) exp(la_t); S_prev = 0 at c = 0
    fence_regs(y);
    wgmma_fence();
    wgmma_3xtf32_rs(y, ch, cl, bh, bl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(y);
    fence_a(ch, cl);
    const float e0 = expf(la0), e1 = expf(la1);
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      y[4 * jp] *= e0;
      y[4 * jp + 1] *= e0;
      y[4 * jp + 2] *= e1;
      y[4 * jp + 3] *= e1;
    }
  }

  for (int it = 0; it <= i; ++it) {
    const bool diag = it == i;
    const int k0 = it * TC_ROWS;
    __syncthreads();   // the last tiles' split copies are read
    mbar_wait(full, (it + 1) & 1);
    split_tile(raw_b, split_p + 2 * TC_TILE_FLOATS, split_p + 3 * TC_TILE_FLOATS, threadIdx.x);
    fence_view_async();   // B's split tiles, to the tensor cores
    __syncthreads();

    // scores (tr (+ 8), key k0 + 8 j + 2 t4 (+ 1)) = C B^T over n, in sc[4 j ..];
    // x is split while the tensor cores run them
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    wgmma_3xtf32_rs(sc, ch, cl, bh, bl);
    wgmma_commit();
    split_tile_t<false>(raw_x, split_p, split_p + TC_TILE_FLOATS, nullptr, warp, lane);
    fence_view_async();   // x's split tiles, to the tensor cores
    __syncthreads();      // split; the slot is read
    if (threadIdx.x == 0 && it < i) load(it + 1);
    wgmma_wait_all();
    fence_regs(sc);
    fence_a(ch, cl);
    // W = scores exp(clip(la_t - la_s, -60, 0)) dt_s, 0 past the diagonal
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = tr + 8 * (e >> 1);
        const float v = sc[4 * j + e] * clip_exp((e < 2 ? la0 : la1) - las[key]) * dts[key];
        sc[4 * j + e] = diag && key > row ? 0.f : v;
      }
    // y += W x: the A operand of key step j is the scores of keys
    // 8 j .. 8 j + 7 as they lie (registers 4 j .. 4 j + 3 in the order
    // (row, 2 t4), (row + 8, 2 t4), (row, 2 t4 + 1), (row + 8, 2 t4 + 1)),
    // k slot t4 holding key 2 t4 and slot t4 + 4 key 2 t4 + 1: split_tile_t's
    // order of x^T's columns
    uint32_t wh[8][4], wl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float av[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(av[e], wh[j][e], wl[j][e]);
    }
    fence_a(wh, wl);
    fence_regs(y);
    wgmma_fence();
    wgmma_3xtf32_rs(y, wh, wl, xh, xl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(y);
    fence_a(wh, wl);
  }

  float* yp = static_cast<float*>(a.y) + b * a.syb + h * a.syh;
  const int64_t row0 = static_cast<int64_t>(c0 + tr) * a.syt;
  const int64_t row1 = static_cast<int64_t>(c0 + tr + 8) * a.syt;
#pragma unroll
  for (int jp = 0; jp < 8; ++jp) {
    const int p = 8 * jp + 2 * t4;
    *reinterpret_cast<float2*>(yp + row0 + p) = make_float2(y[4 * jp], y[4 * jp + 1]);
    *reinterpret_cast<float2*>(yp + row1 + p) = make_float2(y[4 * jp + 2], y[4 * jp + 3]);
  }
}

// The three launches of the tensor-core path; grids (x, y, z) of (a), (b)
// and (c) as kernels/ssm_scan.py::plan gives them, checked against the
// shapes here.
int launch_tc(const SsdArgs& a, int B, const int* grids, cudaStream_t stream) {
  const int nc = a.nc;
  const int n_rt = a.Q / TC_ROWS;
  const int want[9] = {nc, a.H, B, TC_DIM * TC_DIM / (4 * TC_STATE_THREADS), a.H, B,
                       nc * n_rt, a.H, B};
  for (int k = 0; k < 9; ++k)
    if (grids[k] != want[k]) return -1;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  const uint32_t box[4] = {32, TC_ROWS, 1, 1};
  const int64_t xdims[4] = {a.P, a.T, a.H, B}, xstr[3] = {a.sxt, a.sxh, a.sxb};
  const int64_t bdims[4] = {a.N, a.T, a.G, B}, bstr[3] = {a.sbt, a.sbg, a.sbb};
  const int64_t cstr[3] = {a.sct, a.scg, a.scb};
  const int64_t sdims[3] = {a.N, a.P, static_cast<int64_t>(B) * a.H * nc};
  const int64_t sstr[2] = {a.N, static_cast<int64_t>(a.P) * a.N};
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tx, tb, tc, ts;
  CUresult r = encode_boxes(enc, &tx, f32, 4, a.x, 4, xdims, xstr, box, sw);
  if (r == CUDA_SUCCESS) r = encode_boxes(enc, &tb, f32, 4, a.bm, 4, bdims, bstr, box, sw);
  if (r == CUDA_SUCCESS) r = encode_boxes(enc, &tc, f32, 4, a.cm, 4, bdims, cstr, box, sw);
  if (r == CUDA_SUCCESS) r = encode_boxes(enc, &ts, f32, 4, a.ds, 3, sdims, sstr, box, sw);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_tc,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_out_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_tc<<<dim3(grids[0], grids[1], grids[2]), TC_THREADS, TC_SMEM, stream>>>(
      tx, tb, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_tc<<<dim3(grids[3], grids[4], grids[5]), TC_STATE_THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_tc<<<dim3(grids[6], grids[7], grids[8]), TC_THREADS, TC_SMEM, stream>>>(
      tx, tb, tc, ts, a);
  return static_cast<int>(cudaGetLastError());
}

enum Path : int { kSimt = 0, kMma = 1 };

}  // namespace
}  // namespace repro

// strides: 15 int64 in elements, (b, h|g, t) for x, dt, B, C and y in that
// order; the last axis of x, B, C and y is contiguous. s_out is a contiguous
// (B, H, P, N) fp32 buffer. path: 0 the first version (ssd_kernel), 1 the
// tensor-core path (fp32; the wrapper has checked TMA's alignment), which
// needs the workspaces ds (B, H, T / Q, P, N) and la (B, H, T), fp32 and
// contiguous, and grids: the 9 grid dimensions of its three launches.
// Returns 0, a cudaError_t code, -1 for a shape, dtype or path it does not
// take, -2 when the driver has no tensor-map encoder, or 10000 + the
// CUresult of a failed encode.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* bm, const void* cm, void* y, float* s_out,
                            const int64_t* strides, int B, int H, int G, int T,
                            int P, int N, int Q, int dtype, int path, float* ds, float* la,
                            const int* grids, void* stream) {
  using namespace repro;
  if (Q < 1 || Q > QMAX || P > PMAX || N > NMAX || T % Q || H % G) return -1;
  if (path != kSimt && path != kMma) return -1;
  if (path == kMma && (dtype != kF32 || P != TC_DIM || N != TC_DIM || Q % TC_ROWS ||
                       Q > TC_QMAX || ds == nullptr || la == nullptr || grids == nullptr))
    return -1;
  if (B == 0 || T == 0) return 0;
  SsdArgs a;
  a.x = x; a.dt = dt; a.A = A; a.bm = bm; a.cm = cm; a.y = y; a.s_out = s_out;
  a.sxb = strides[0]; a.sxh = strides[1]; a.sxt = strides[2];
  a.sdb = strides[3]; a.sdh = strides[4]; a.sdt = strides[5];
  a.sbb = strides[6]; a.sbg = strides[7]; a.sbt = strides[8];
  a.scb = strides[9]; a.scg = strides[10]; a.sct = strides[11];
  a.syb = strides[12]; a.syh = strides[13]; a.syt = strides[14];
  a.H = H; a.G = G; a.T = T; a.P = P; a.N = N; a.Q = Q;
  a.ds = ds; a.la = la; a.B = B; a.nc = T / Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kMma) return launch_tc(a, B, grids, s);
  if (dtype == kF32) return launch<float>(a, B, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, B, s);
  return -1;
}
