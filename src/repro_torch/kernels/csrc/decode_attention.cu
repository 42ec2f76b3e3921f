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
// bound by the bytes of the cache it must read, and what it needs is many
// bytes in flight. Both kernels read each valid cache row once: a CTA
// serves all R q heads of its cache head, where the Pallas grid (B, Hq,
// S-blocks) reads the group's cache R times.
//
// decode_split, the kernel of the serving paths, splits S over the grid:
// one CTA per (split of S, cache head, batch row), the number of splits a
// function of shapes alone (kernels/decode_attention.py::plan), so the host
// never reads valid_len and the launch can be captured in a graph. A CTA
// whose split starts at or past valid_len[b] writes an empty partial and
// returns. Inside a CTA one producer thread keeps a 4-slot ring of 32-row
// K and V tiles full through TMA (full/empty mbarriers, expect_tx), over
// 4-D maps (D, S, Hc, B) that take the cache view's strides as they are;
// four consumer warps take the tiles in turn, each its own slot. In a tile
// a lane owns a row for q.k (it walks the row's 16-byte chunks from a
// different start than its neighbours, so the reads spread over the
// banks), the warp runs the online softmax in fp32, and for P.V the lanes
// own 16-byte column chunks (8-byte for int8), in row groups. An int8 tile
// is dequantized through its rows' scales, read with plain loads: q.k
// times the k scale, p times the v scale. Each CTA leaves (m, l, acc[D]) per q head in an fp32
// workspace, and decode_merge, launched by the same entry point, combines
// a (batch row, q head)'s splits; a split with l = 0 is skipped, so
// valid_len = 0 gives 0.
//
// decode_kernel, the first version, takes what TMA cannot read (a stride
// or base off 16 bytes): one CTA per (cache head, batch row); 8 warps split
// the valid rows; a warp takes 4 rows at a time, its lanes holding D/32
// (rounded up to a power of two) consecutive elements of each row (one
// vector load per lane). Dot products reduce over the warp with shuffles;
// each warp keeps its own (m, l, acc) per q head, and the warps' states
// merge through shared memory at the end.
//
// Layout: q/o (B, Hq, D); k/v (B, Hc, S, D) and scales (B, Hc, S, 1) given by
// strides in elements, so the per-layer (B, S, Hc, D) view of the model's
// (L, B, S, Hc, D) cache is read in place.
#include "common.cuh"
#include "hopper.cuh"

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
  // decode_split only: the partials (B, Hq, n_splits, D + 2) of m, l and
  // acc[D], fp32, and the rows of a split
  float* ws;
  int split_rows, n_splits;
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

// ---------------------------------------------------------------- split S

constexpr int DS_ROWS = 32;     // cache rows per ring slot: one per lane
constexpr int DS_WARPS = 4;     // consumer warps, each taking every 4th tile
constexpr int DS_STAGES = 4;    // ring slots; warp w takes slot w
constexpr int DS_THREADS = 32 * (DS_WARPS + 1);   // and one producer warp
constexpr int DS_MAX_SPLITS = 4096;   // the merge's weights fit 32 KB of shared memory
static_assert(DS_STAGES == DS_WARPS, "each consumer warp owns one ring slot");

template <typename TKV, int D>
struct DsShape {
  static constexpr int kVE = 16 / static_cast<int>(sizeof(TKV));  // elements per 16 bytes
  static constexpr int kNV = D / kVE;                  // 16-byte chunks per row
  static constexpr int kQV = kVE / 4;                  // fp32 q chunks per cache chunk
  // P.V: a warp's lanes hold P.V chunk lane % kPN of every kG-th row (kG
  // row groups), or for rows of more than 32 chunks, chunks lane + 32 j; a
  // chunk is 16 bytes, 8 for int8 (16 fp32 sums a head would spill at R = 8)
  static constexpr int kPE = kVE < 8 ? kVE : 8;       // elements per P.V chunk
  static constexpr int kPN = D / kPE;
  static constexpr int kG = kPN >= 32 ? 1 : 32 / kPN;
  static constexpr int kCPL = (kPN + 31) / 32;
  static constexpr int kTileBytes = DS_ROWS * D * static_cast<int>(sizeof(TKV));
  static constexpr int kStageBytes = 2 * kTileBytes;   // K and V
  static constexpr int kRingBytes = DS_STAGES * kStageBytes;
  static_assert(D % kVE == 0, "a row is whole 16-byte chunks");
  // the warps' (m, l, acc) meet in the ring once it is drained
  static_assert(DS_WARPS * 8 * (D + 2) * 4 <= kRingBytes, "merge scratch fits the ring");
};

template <int RMAX, int D>
constexpr int ds_smem_bytes(int ring_bytes) {
  // 128 bytes to align the ring by hand, the ring, q in fp32, the barriers
  return 128 + ring_bytes + RMAX * D * 4 + 2 * DS_STAGES * 8;
}

template <typename TQ, typename TKV, int D, int RMAX>
__global__ void __launch_bounds__(DS_THREADS)
decode_split(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
             const DecodeArgs a) {
  using Sh = DsShape<TKV, D>;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int VE = Sh::kVE, NV = Sh::kNV, QV = Sh::kQV;
  constexpr int PE = Sh::kPE, PN = Sh::kPN, NG = Sh::kG, CPL = Sh::kCPL;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 127) & ~127u;   // slot s: K at ring + s * stage, V after it
  uint8_t* ring_p = smem_raw + (ring - raw);
  // q in fp32, scaled by scale * log2(e), chunk-interleaved: element (r, d)
  // at float4 (r * QV + (d % VE) / 4) * NV + d / VE, lane d % 4, so lanes
  // reading neighbouring chunks of one head read neighbouring 16 bytes
  float* qs = reinterpret_cast<float*>(ring_p + Sh::kRingBytes);
  const uint32_t full = ring + Sh::kRingBytes + RMAX * D * 4;   // full[s] at full + 8 s
  const uint32_t empty = full + DS_STAGES * 8;

  const int split = blockIdx.x;
  const int hc = blockIdx.y;
  const int b = blockIdx.z;
  const int R = a.Hq / a.Hc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int valid = max(0, min(a.valid_len[b], a.S));
  const int row0 = split * a.split_rows;
  const int row_end = min(row0 + a.split_rows, valid);
  // head r's partial: part + r * n_splits * (D + 2)
  const int64_t head_step = static_cast<int64_t>(a.n_splits) * (D + 2);
  float* part = a.ws + (static_cast<int64_t>(b) * a.Hq + hc * R) * head_step
                + static_cast<int64_t>(split) * (D + 2);
  if (row0 >= row_end) {   // nothing to read: l = 0 tells the merge to skip it
    if (threadIdx.x < R) {
      part[threadIdx.x * head_step] = kNegInf;
      part[threadIdx.x * head_step + 1] = 0.f;
    }
    return;
  }
  const int n_tiles = (row_end - row0 + DS_ROWS - 1) / DS_ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DS_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 1);   // the lane 0 of the warp that read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == DS_WARPS) {   // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % DS_STAGES;
        if (it >= DS_STAGES) mbar_wait(empty + 8 * s, (it / DS_STAGES - 1) & 1);
        const uint32_t slot = ring + s * Sh::kStageBytes;
        const int t0 = row0 + it * DS_ROWS;   // rows past S read as 0
        mbar_expect_tx(full + 8 * s, Sh::kStageBytes);
        tma_load_4d(slot, &tmk, full + 8 * s, 0, t0, hc, b);
        tma_load_4d(slot + Sh::kTileBytes, &tmv, full + 8 * s, 0, t0, hc, b);
      }
    }
    return;
  }

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.sqb + static_cast<int64_t>(hc) * R * a.sqh;
  const float scale_log2 = a.scale * 1.4426950408889634f;   // exp(x) = exp2(x log2(e))
  for (int i = threadIdx.x; i < R * D; i += 32 * DS_WARPS) {
    const int r = i / D, d = i % D;
    qs[((r * QV + (d % VE) / 4) * NV + d / VE) * 4 + d % 4] =
        to_f<TQ>(qp[r * a.sqh + d]) * scale_log2;
  }
  named_barrier_sync(1, 32 * DS_WARPS);

  const float* ksp = kInt8 ? a.ks + b * a.sksb + hc * a.sksh : nullptr;
  const float* vsp = kInt8 ? a.vs + b * a.svsb + hc * a.svsh : nullptr;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float neg_inf = __int_as_float(0xff800000u);
  // P.V: this lane's row group and chunk; lanes past NG * PN idle there
  const int pv_g = PN >= 32 ? 0 : lane / PN;
  const int pv_c = PN >= 32 ? lane : lane % PN;
  const bool pv_on = pv_g < NG;

  float m[RMAX], l[RMAX], acc[RMAX][CPL][PE];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;   // finite, so a masked (-inf) score gives p = 0
    l[r] = 0.f;       // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < PE; ++e) acc[r][j][e] = 0.f;
  }

  for (int it = warp; it < n_tiles; it += DS_WARPS) {
    const int s = it % DS_STAGES;
    const int t0 = row0 + it * DS_ROWS;
    const int rows = min(DS_ROWS, row_end - t0);   // this tile's rows to count
    const bool row_on = lane < rows;
    float kscale = 1.f, vscale = 1.f;
    if constexpr (kInt8) {
      if (row_on) {   // issued before the wait, so the loads overlap it
        kscale = ksp[(t0 + lane) * a.skst];
        vscale = vsp[(t0 + lane) * a.svst];
      }
    }
    mbar_wait(full + 8 * s, (it / DS_STAGES) & 1);
    const TKV* kt = reinterpret_cast<const TKV*>(ring_p + s * Sh::kStageBytes);
    const TKV* vt = kt + DS_ROWS * D;

    // scores: this lane's row against the R heads, from chunk lane % NV on
    float sc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
    const TKV* krow = kt + lane * D;
    int cc = lane % NV;
#pragma unroll 2
    for (int c = 0; c < NV; ++c) {
      float kf[VE];
      load_row<TKV, VE>(krow + cc * VE, kf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int j = 0; j < QV; ++j) {
          const float4 x = q4[(r * QV + j) * NV + cc];
          float t = sc[r];
          t = fmaf(x.x, kf[4 * j], t);
          t = fmaf(x.y, kf[4 * j + 1], t);
          t = fmaf(x.z, kf[4 * j + 2], t);
          t = fmaf(x.w, kf[4 * j + 3], t);
          sc[r] = t;
        }
      }
      cc = cc + 1 == NV ? 0 : cc + 1;
    }

    // online softmax over the tile, in log2 units; rows past `rows` are -inf
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      const float sr = row_on ? sc[r] * kscale : neg_inf;
      float mx = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      p[r] = exp2f(sr - m_new);
      l[r] = fmaf(l[r], alpha, p[r]);
      if constexpr (kInt8) p[r] *= vscale;   // dequantize V through p
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < PE; ++e) acc[r][j][e] *= alpha;
    }

    // O += P V: row rho's p comes from lane rho; only rows < `rows` are
    // read, so no 0 * (whatever lies past valid_len) enters the sum
#pragma unroll 2
    for (int i = 0; i < (DS_ROWS + NG - 1) / NG; ++i) {
      const int rho = pv_g + NG * i;
      float pr[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        pr[r] = r < R ? __shfl_sync(0xffffffffu, p[r], rho & 31) : 0.f;
      if (pv_on && rho < rows) {
        const TKV* vrow = vt + rho * D;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int ch = pv_c + 32 * j;
          if (CPL > 1 && ch >= PN) break;
          float vf[PE];
          load_row<TKV, PE>(vrow + ch * PE, vf);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r >= R) break;
#pragma unroll
            for (int e = 0; e < PE; ++e) acc[r][j][e] = fmaf(pr[r], vf[e], acc[r][j][e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);   // the slot may be refilled
  }

  // the warp's row sums, and its P.V over the row groups into lanes < PN
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    if constexpr (NG > 1) {
#pragma unroll
      for (int e = 0; e < PE; ++e) {
        const float x = acc[r][0][e];
        float sum = x;
#pragma unroll
        for (int gg = 1; gg < NG; ++gg) sum += __shfl_down_sync(0xffffffffu, x, gg * PN);
        acc[r][0][e] = sum;
      }
    }
  }

  // the four warps' states meet in the drained ring: [warp][r][m, l, acc]
  named_barrier_sync(1, 32 * DS_WARPS);
  float* scr = reinterpret_cast<float*>(ring_p);
  float* mine = scr + warp * RMAX * (D + 2);
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    if (lane == 0) {
      mine[r * (D + 2)] = m[r];
      mine[r * (D + 2) + 1] = l[r];
    }
    if (pv_g == 0) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int ch = pv_c + 32 * j;
        if (ch >= PN) break;
#pragma unroll
        for (int e = 0; e < PE; ++e) mine[r * (D + 2) + 2 + ch * PE + e] = acc[r][j][e];
      }
    }
  }
  named_barrier_sync(1, 32 * DS_WARPS);
  for (int i = threadIdx.x; i < R * (D + 2); i += 32 * DS_WARPS) {
    const int r = i / (D + 2), x = i % (D + 2);
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < DS_WARPS; ++w) mx = fmaxf(mx, scr[(w * RMAX + r) * (D + 2)]);
    float sum = 0.f;   // a warp with no tile has m = kNegInf, l = 0, acc = 0
#pragma unroll
    for (int w = 0; w < DS_WARPS; ++w) {
      const float* st = scr + (w * RMAX + r) * (D + 2);
      sum = fmaf(st[x], exp2f(st[0] - mx), sum);
    }
    part[r * head_step + x] = x == 0 ? mx : sum;
  }
}

// out[b, h] = the splits' partials of (b, h) combined, one thread a column.
// Each split's weight, exp2(m - max m) or 0 where l = 0, is computed once
// into shared memory (2 n_splits floats); a split of weight 0 is not read,
// so an empty split's unwritten acc never enters, and no split leaves 0.
template <typename TQ>
__global__ void decode_merge(const DecodeArgs a, int D) {
  extern __shared__ float wsh[];   // weights [n_splits], then weights x l
  __shared__ float red[32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ns = a.n_splits;
  const float* part = a.ws + (static_cast<int64_t>(b) * a.Hq + h) * ns * (D + 2);
  float mx = kNegInf;
  for (int s = tid; s < ns; s += blockDim.x) {
    const float m = part[s * (D + 2)], l = part[s * (D + 2) + 1];
    wsh[s] = m;
    wsh[ns + s] = l;
    if (l > 0.f) mx = fmaxf(mx, m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) mx = fmaxf(mx, red[w]);
  for (int s = tid; s < ns; s += blockDim.x) {
    const float l = wsh[ns + s];
    const float w = l > 0.f ? exp2f(wsh[s] - mx) : 0.f;
    wsh[s] = w;
    wsh[ns + s] = w * l;
  }
  __syncthreads();
  if (tid >= D) return;
  float lsum = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const float w = wsh[s];
    lsum += wsh[ns + s];
    if (w > 0.f) o = fmaf(part[s * (D + 2) + 2 + tid], w, o);
  }
  static_cast<TQ*>(a.o)[b * a.sob + h * a.soh + tid] = from_f<TQ>(o / fmaxf(lsum, 1e-20f));
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType tma_type<int8_t>() { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }

template <typename TQ, typename TKV, int D, int RMAX>
int launch_split(const DecodeArgs& a, int B, cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  constexpr int el = static_cast<int>(sizeof(TKV));
  const int64_t dims[4] = {D, a.S, a.Hc, B};
  const int64_t kstr[3] = {a.skt, a.skh, a.skb}, vstr[3] = {a.svt, a.svh, a.svb};
  const uint32_t box[4] = {D, DS_ROWS, 1, 1};
  CUtensorMap tk, tv;
  CUresult r = encode_boxes(enc, &tk, tma_type<TKV>(), el, a.k, 4, dims, kstr, box,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r == CUDA_SUCCESS)
    r = encode_boxes(enc, &tv, tma_type<TKV>(), el, a.v, 4, dims, vstr, box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  constexpr int bytes = ds_smem_bytes<RMAX, D>(DsShape<TKV, D>::kRingBytes);
  auto kernel = decode_split<TQ, TKV, D, RMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.n_splits, a.Hc, B), DS_THREADS, bytes, stream>>>(tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge<TQ><<<dim3(a.Hq, B), 32 * ((D + 31) / 32), 2 * a.n_splits * sizeof(float),
                     stream>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

enum Path : int { kSimt = 0, kSplit = 1 };

template <typename TQ, typename TKV, int D, int RMAX>
int launch(const DecodeArgs& a, int B, int path, cudaStream_t stream) {
  if (path == kSplit) return launch_split<TQ, TKV, D, RMAX>(a, B, stream);
  dim3 grid(a.Hc, B);
  decode_kernel<TQ, TKV, D, RMAX><<<grid, NW * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int dispatch_r(const DecodeArgs& a, int B, int path, cudaStream_t stream) {
  const int R = a.Hq / a.Hc;
  if (R <= 1) return launch<TQ, TKV, D, 1>(a, B, path, stream);
  if (R <= 2) return launch<TQ, TKV, D, 2>(a, B, path, stream);
  if (R <= 4) return launch<TQ, TKV, D, 4>(a, B, path, stream);
  if (R <= 8) return launch<TQ, TKV, D, 8>(a, B, path, stream);
  return -1;
}

template <typename TQ, typename TKV>
int dispatch_d(const DecodeArgs& a, int B, int D, int path, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_r<TQ, TKV, 16>(a, B, path, stream);
    case 32: return dispatch_r<TQ, TKV, 32>(a, B, path, stream);
    case 64: return dispatch_r<TQ, TKV, 64>(a, B, path, stream);
    case 80: return dispatch_r<TQ, TKV, 80>(a, B, path, stream);
    case 128: return dispatch_r<TQ, TKV, 128>(a, B, path, stream);
    case 160: return dispatch_r<TQ, TKV, 160>(a, B, path, stream);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

// strides: 16 int64 in elements: q (b, h); k (b, h, t); v (b, h, t);
// k_scale (b, h, t); v_scale (b, h, t); o (b, h). Scales are read only for
// an int8 cache. path: 0 decode_kernel, 1 decode_split (the wrapper has
// checked TMA's alignment), which needs ws, an fp32 workspace of B * Hq *
// n_splits * (D + 2) floats, and the rows of a split, a multiple of 32, in
// at most 4096 splits.
// Returns 0, a cudaError_t code, -1 for a head dim, group size, dtype pair
// or path it does not take, -2 when the driver has no tensor-map encoder,
// or 10000 + the CUresult of a failed encode.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* k_scale, const float* v_scale,
                                    const int* valid_len, void* o, float* ws,
                                    const int64_t* strides, int B, int Hq, int Hc,
                                    int S, int D, int q_dtype, int kv_dtype,
                                    float scale, int split_rows, int n_splits, int path,
                                    void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  if (path != kSimt && path != kSplit) return -1;
  if (path == kSplit && (S <= 0 || split_rows <= 0 || split_rows % DS_ROWS != 0 ||
                         n_splits <= 0 || n_splits > DS_MAX_SPLITS || ws == nullptr))
    return -1;
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
  a.ws = ws; a.split_rows = split_rows; a.n_splits = n_splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return dispatch_d<float, float>(a, B, D, path, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, path, s);
  if (q_dtype == kF32 && kv_dtype == kI8) return dispatch_d<float, int8_t>(a, B, D, path, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return dispatch_d<__nv_bfloat16, int8_t>(a, B, D, path, s);
  return -1;
}
