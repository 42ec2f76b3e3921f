// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pl.pallas_call at :104): causal, sliding-window or
// non-causal attention with GQA (q head h reads kv head h / R), query row i
// at key i (the starts lined up, :59), an online softmax whose state (m, l,
// acc) stays in fp32, masked probabilities exactly 0 (:72) and the output
// divided by max(l, 1e-20) (:82).
//
// What bounds it: at prefill lengths the work is 4*D flops per unmasked
// (query, key) pair against 2*D*(Tq + 2*Tk) bytes, far above the card's
// ~295 flops/byte ridge, so the kernel is bound by operations: by the
// tensor cores' bf16 rate, which only wgmma reaches.
//
// Design: two kernels; the wrapper (kernels/flash_attention.py::route)
// picks one from the dtype and the TMA constraints before the launch and
// passes it here as `path`. Nothing falls back after a failure.
//  * wgmma (bf16, every q/k/v stride a multiple of 16 bytes, 16-byte-aligned
//    bases): both products on the tensor cores. One CTA per (64 q rows, q
//    head, batch row), the last q tiles (the longest under a causal mask)
//    first. One producer warp has one thread issue TMA loads through 4-D
//    tensor maps over (D, T, H, B) with the caller's element strides, so the
//    model's (B, T, H, D) views are read in place: Q once, then K and V
//    tiles of 64 keys into a ring of 2 slots, each with a full mbarrier
//    armed with expect_tx and an empty one the consumer warps arrive on once
//    wgmma.wait_group has retired the products that read the slot. A row of
//    a tile is ceil(D/64) boxes of 64 columns under the 128-byte swizzle;
//    TMA zero-fills the columns past D and the rows past Tq and Tk. The
//    consumer warpgroup runs S = Q K^T as wgmma m64n64k16 (both operands in
//    shared memory, K-major), masks in registers only the tiles that cross
//    the causal diagonal, the window's start or Tk (tiles wholly outside
//    are never loaded), takes each row's max over the 4 lanes of a quad,
//    and splits P = exp2(S * scale * log2(e) - m) into two bf16 halves in
//    registers, hi = bf16(P) and lo = bf16(P - hi): the m64n64 accumulator
//    layout of 16 columns is the k16 A fragment layout, so each half feeds
//    O += P V (wgmma m64nNk16, N = 64 ceil(D/64), A from registers, V
//    MN-major in shared memory: tnspB = 1) without a trip through shared
//    memory, two products per 16 keys. The epilogue divides by max(l,
//    1e-20), rounds to bf16 and stores masked by Tq and D.
//    Numerics: a bf16 x bf16 product summed in fp32 is exact up to the
//    order of the sum, so S is the Pallas kernel's up to that order; hi +
//    lo holds P to about 16 significant bits, so hi V + lo V is the Pallas
//    kernel's fp32 P times V (there fp32 V, here the same bf16 values) up
//    to that rounding and the order of the sum, and the row sum l, taken
//    from the fp32 P, agrees with it. One bf16 rounding of P alone (the
//    first version of this kernel) put the outputs up to 1.56e-2 from the
//    plain version's. exp2 with the scale and log2(e) folded into one
//    multiply-add is exp up to rounding.
//    Waste: padding D to 64 columns computes 37.5% more products than
//    needed at D = 80 (128) and 17% at D = 160 (192), 75% and 50% at
//    D = 16 and 32. The softmax does not overlap the products (one
//    consumer warpgroup, one q head per CTA).
//    Shared memory: Q 8 KB per 64 columns plus 2 slots of K and V: 80 KB at
//    D = 128 (two CTAs an SM), 120 KB at D = 160 (one).
//    Its device time beats the CUDA-core kernel's at every length of
//    chip_smoke.py's sweep (T = 16 to 2048 at D = 128, 80 and 160), so
//    the route has no length switch.
//  * simt (fp32, or bf16 that TMA cannot read): the first version, fp32
//    FMAs on the CUDA cores. One CTA of 256 threads per (64-row q tile, q
//    head, batch row); the Q tile is staged once in shared memory as fp32;
//    K and V tiles of 64 rows stream through shared memory. Thread (ty, tx)
//    owns rows ty + 16 i and key columns tx + 16 j of the score tile
//    (interleaved, so shared-memory reads are conflict-free with a +1 row
//    pitch), and the output columns tx + 16 j. Row max and row sum reduce
//    over the 16 lanes of a half warp. Any head dim that is a multiple of 16
//    fits this layout; the instantiated ones are 16, 32, 64, 80 (zamba2),
//    128 and 160 (stablelm-12b), the last at 140 KB of shared memory.
//    K tiles past the causal diagonal (or before the window) are never
//    loaded. Tails of any length are masked.
//
// Layout: q/o (B, Hq, Tq, D) and k/v (B, Hkv, Tk, D) given by strides in
// elements, with the D axis contiguous, so the model's (B, T, H, D) tensors
// are read in place.
#include "common.cuh"
#include "hopper.cuh"

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
  int Hq, Hkv, Tq, Tk, D;
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

// ---------------------------------------------------------------- wgmma

constexpr int FW_BQ = 64;                   // q rows per CTA: one wgmma M
constexpr int FW_BK = 64;                   // keys per ring slot
constexpr int FW_STAGES = 2;
constexpr int FW_BOX_BYTES = 64 * 64 * 2;   // a 64-row x 64-column bf16 box, 8 KB
constexpr int FW_THREADS = 160;             // one consumer warpgroup + a producer warp

// NB: 64-column boxes in a row of Q, K or V, ceil(D / 64)
template <int NB>
struct FwShape {
  static constexpr int kTileBytes = NB * FW_BOX_BYTES;  // a Q, K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;    // K and V
  // Q, the ring, 1024 bytes to align them by hand (the swizzle's period),
  // the barriers: Q's, full[], empty[]
  static constexpr int kSmem =
      kTileBytes + FW_STAGES * kStageBytes + 1024 + (1 + 2 * FW_STAGES) * 8;
};

// p0, p1 (p0 in the low half) as two bf16x2 halves, hi = bf16(p) and lo =
// bf16(p - hi): hi + lo carries p to about 16 significant bits, so hi V +
// lo V is p V with the precision of the plain version's fp32 p
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// O (64 x 64 NB) += P (64 x 16 keys, registers) @ V (16 keys x 64 NB)
template <int NB>
__device__ __forceinline__ void pv_product(float (&o)[32 * NB], const uint32_t (&p)[4],
                                           uint64_t dv) {
  if constexpr (NB == 1) wgmma_m64n64k16_rs(o, p, dv, 1);
  else if constexpr (NB == 2) wgmma_m64n128k16_rs(o, p, dv, 1);
  else wgmma_m64n192k16_rs(o, p, dv, 1);
}

template <int NB>
__global__ void __launch_bounds__(FW_THREADS, NB == 3 ? 1 : 2)
flash_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv, const FlashArgs a) {
  using Shape = FwShape<NB>;
  constexpr int kTile = Shape::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t ring = qs + kTile;  // slot s: K at ring + s * stage, V kTile after it
  const uint32_t qbar = ring + FW_STAGES * Shape::kStageBytes;
  const uint32_t full = qbar + 8;    // full[s] at full + 8 s
  const uint32_t empty = full + FW_STAGES * 8;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BQ;  // the longest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the key range this q tile needs: causal stops at its last row, a
  // window starts at its first row's window
  const int last_row = min(q0 + FW_BQ, a.Tq) - 1;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, last_row + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / FW_BK) * FW_BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + FW_BK - 1) / FW_BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 4);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer: one thread loads Q, then keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(qbar, kTile);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(qs + c * FW_BOX_BYTES, &tmq, qbar, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % FW_STAGES;
        if (it >= FW_STAGES) mbar_wait(empty + 8 * s, (it / FW_STAGES - 1) & 1);
        const uint32_t ks = ring + s * Shape::kStageBytes;
        const int k0 = k_begin + it * FW_BK;
        mbar_expect_tx(full + 8 * s, Shape::kStageBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(ks + c * FW_BOX_BYTES, &tmk, full + 8 * s, 64 * c, k0, hk, b);
          tma_load_4d(ks + kTile + c * FW_BOX_BYTES, &tmv, full + 8 * s, 64 * c, k0, hk, b);
        }
      }
    }
    return;
  }

  // this thread's rows, r0 and r0 + 8, and its first column in each group
  // of 8 (the accumulator layout, hopper.cuh)
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float neg_inf = __int_as_float(0xff800000u);
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
  float o[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % FW_STAGES;
    const int k0 = k_begin + it * FW_BK;
    const uint32_t ks = ring + s * Shape::kStageBytes;
    const uint32_t vs = ks + kTile;
    mbar_wait(full + 8 * s, (it / FW_STAGES) & 1);

    // S = Q K^T. Q and K rows are 128 bytes a box, 8-row groups 1024 bytes
    // apart; 16 d are 32 bytes, the next 64 d the next box.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk >> 2) * FW_BOX_BYTES + (kk & 3) * 32;
      wgmma_m64n64k16_ss<0>(sc, sw128_desc(qs + off, 16, 1024), sw128_desc(ks + off, 16, 1024),
                            1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask the tiles that cross the causal diagonal, the window's start or
    // Tk; a masked score is -inf, so its probability is exactly 0
    if (k0 + FW_BK > a.Tk || (a.causal && k0 + FW_BK - 1 > q0) ||
        (a.window > 0 && k0 <= q0 + FW_BQ - 1 - a.window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          const int key = k0 + 8 * j + c0 + (e & 1);
          bool ok = key < a.Tk;
          if (a.causal) ok = ok && key <= row;
          if (a.window > 0) ok = ok && key > row - a.window;
          if (!ok) sc[4 * j + e] = neg_inf;
        }
    }

    // online softmax on the fragment: each row's max over its quad
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx * scale_log2);  // m stays finite
      alpha[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
    // P as two bf16 halves (split_bf16), so the row sums l and P V see the
    // same fp32 p: registers 4 kk .. 4 kk + 3 of each are the A fragment of
    // keys 16 kk .. 16 kk + 15
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(sc[4 * j], scale_log2, -m[0]));
      const float p1 = exp2f(fmaf(sc[4 * j + 1], scale_log2, -m[0]));
      const float p2 = exp2f(fmaf(sc[4 * j + 2], scale_log2, -m[1]));
      const float p3 = exp2f(fmaf(sc[4 * j + 3], scale_log2, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      split_bf16(p0, p1, ph[2 * j], pl[2 * j]);          // row r0, keys 8 j + c0 (+ 1)
      split_bf16(p2, p3, ph[2 * j + 1], pl[2 * j + 1]);  // row r0 + 8
    }
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V as hi V + lo V. V rows (keys) are 128 bytes a box, 8-key
    // groups 1024 bytes apart (SBO), the next 64 columns the next box (LBO);
    // 16 keys are 2048 bytes.
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 2048, FW_BOX_BYTES, 1024);
      const uint32_t hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
      const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
      pv_product<NB>(o, hi, dv);
      pv_product<NB>(o, lo, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the slot may be refilled
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hr] = 1.f / fmaxf(sum, 1e-20f);
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int j = 0; j < 8 * NB; ++j) {
    const int col = 8 * j + c0;
    if (col >= a.D) continue;  // D is a multiple of 16, so col + 1 < D too
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row < a.Tq)
        *reinterpret_cast<__nv_bfloat162*>(op + row * a.sot + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv[hr], o[4 * j + 2 * hr + 1] * inv[hr]);
    }
  }
}

// ------------------------------------------------------------- host side

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

template <int NB>
int launch_wgmma_nb(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                    const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = FwShape<NB>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Tq + FW_BQ - 1) / FW_BQ, a.Hq, B);
  flash_wgmma<NB><<<grid, FW_THREADS, bytes, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const FlashArgs& a, int B, cudaStream_t stream) {
  const int D = a.D;
  if (D % 16 != 0 || D > 192) return -1;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  const int64_t qdims[4] = {D, a.Tq, a.Hq, B}, kdims[4] = {D, a.Tk, a.Hkv, B};
  const int64_t qstr[3] = {a.sqt, a.sqh, a.sqb}, kstr[3] = {a.skt, a.skh, a.skb},
                vstr[3] = {a.svt, a.svh, a.svb};
  CUtensorMap tq, tk, tv;
  CUresult r = encode_bf16_boxes(enc, &tq, a.q, 4, qdims, qstr);
  if (r == CUDA_SUCCESS) r = encode_bf16_boxes(enc, &tk, a.k, 4, kdims, kstr);
  if (r == CUDA_SUCCESS) r = encode_bf16_boxes(enc, &tv, a.v, 4, kdims, vstr);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  if (D <= 64) return launch_wgmma_nb<1>(tq, tk, tv, a, B, stream);
  if (D <= 128) return launch_wgmma_nb<2>(tq, tk, tv, a, B, stream);
  return launch_wgmma_nb<3>(tq, tk, tv, a, B, stream);
}

enum Path : int { kSimt = 0, kWgmma = 1 };

}  // namespace
}  // namespace repro

// strides: 12 int64 in elements, (b, h, t) for q, k, v, o in that order.
// path: 0 simt, 1 wgmma (bf16 only; the wrapper has checked TMA's
// alignment). Returns 0, a cudaError_t code, -1 for a head dim, dtype or
// path it does not take, -2 when the driver has no tensor-map encoder, or
// 10000 + the CUresult of a failed encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int64_t* strides, int B, int Hq,
                                   int Hkv, int Tq, int Tk, int D, int dtype,
                                   int causal, int window, float scale, int path,
                                   void* stream) {
  using namespace repro;
  if (Tq == 0 || B == 0) return 0;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqt = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skt = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svt = strides[8];
  a.sob = strides[9]; a.soh = strides[10]; a.sot = strides[11];
  a.Hq = Hq; a.Hkv = Hkv; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.causal = causal; a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kWgmma) return dtype == kBF16 ? launch_wgmma(a, B, s) : -1;
  if (path != kSimt) return -1;
  if (dtype == kF32) return dispatch_d<float>(a, B, D, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return -1;
}
