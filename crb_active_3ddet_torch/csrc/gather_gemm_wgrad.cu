// Weight gradient of the sparse-conv gather-GEMM for Hopper (sm_90a):
//     dW[k, c, n] = sum_{v : rb[v, k] >= 0} feat[rb[v, k], c] * dout[v, n]
//
// The backward of crb_active_3ddet_tpu/ops/pallas_kernels.py
// (sparse_conv_gather_gemm), which has no VJP there: the JAX package trains
// through XLA's autodiff of the gather + dot (models/backbones_3d/
// spconv_backbone.py:137-145), whose weight cotangent is this product.  The
// input gradient needs no kernel of its own: it is the forward kernel
// (gather_gemm.cu) over the inverse rulebook with W[k] transposed.
//
// Both routes cut the rows v into slices: a block owns one offset k, one
// Cout tile of TN <= 64 columns and one slice, so that even K = 3 (conv_out)
// fills the card.  The slices' partial tiles go to scratch and a second
// kernel sums them in slice order: no float atomics, the same bits on every
// run.
//
// bf16 features: tensor cores (wgrad_mma_kernel)
//   * the tile is a GEMM with M = Cin (A = the gathered feature rows,
//     transposed), N = the Cout tile and the depth running over the listed
//     hits of offset k, 16 at a time.  Which hit sits in which depth slot
//     does not matter as long as A and B agree;
//   * the f32 output gradient enters the bf16 mma as three terms,
//     hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid), each rounded
//     to nearest: d - hi keeps at most 16 significant bits and d - hi - mid
//     at most 8, so hi + mid + lo == d exactly for every |d| >= 2^-110 (below
//     that lo is a bf16 subnormal and the sum is within 2^-134 of d).  The
//     features are bf16 and exact.  So each product feat * d reaches the f32
//     accumulator as three exact products, and the kernel agrees with the f32
//     einsum within its summation order (1e-5 of the sum of the products'
//     magnitudes, 1e-6 absolute for a single hit); two terms would leave
//     up to 2^-17 of every product.  A TF32 hi/lo split of d (bf16 is exact
//     in TF32) keeps 22 bits: within the 1e-5, but a single product above 4
//     would miss the 1e-6, and at m16n8k8 it issues 2 x 2 = 4 mmas per depth
//     16 against 3 here and doubles the staged bytes: three bf16 terms it is;
//   * the rulebook comes transposed, (K, V_out): a block reads its column
//     coalesced, 8 entries a thread a round, and compacts the slice's hits in
//     row order (ballot, popcount, one prefix over 8 x 4 warp counts) into a
//     list in shared memory (a slice has at most LIST_CAP rows, so its hits
//     fit);
//   * the listed hits go through in groups of 64: the group's feature rows
//     (bf16, 16 B loads) and dout rows (f32, 16 B loads, split into the three
//     bf16 planes as they are stored) are staged in shared memory, rows padded
//     by 16 B so that ldmatrix's eight row addresses fall in distinct banks,
//     and the next group's rows are loaded into registers while this group's
//     mmas run (two barriers a group);
//   * fragments come from ldmatrix.x4.trans: A as (hit, channel) rows read
//     transposed, B likewise from each dout plane; one A fragment serves the
//     three terms and every n-tile of the warp;
//   * 4 warps: as many as fit split the (Cin, TN) tile, the others split the
//     depth steps of a group and are summed in warp order at the end;
//   * Cin 4 and 8 (conv_input) are staged into 16 channels, the rest zeros:
//     the mma's M rows past Cin cost products but no bytes.
//
// f32 features (the f32 models' gradient must keep their 1e-4 agreement,
// which a TF32 product loses): CUDA cores (wgrad_partial_kernel)
//   * a block walks its rows 256 at a time: one rulebook entry a thread, the
//     hits compacted in row order into a list in shared memory, so that rows
//     without a hit cost one 4-byte read and nothing else;
//   * 32 listed rows at a time are staged in shared memory, each thread's
//     loads of a round all issued before its first store, and the next 256
//     rows' rulebook entries read while this chunk is worked on; each thread
//     keeps an MR x MC block of the (Cin, TN) tile in registers and adds each
//     row's outer product with FMAs.  Below 1024 outputs a tile, G groups of
//     threads take every G-th row and are summed in group order at the end.
//
// Measurement builds (chip_smoke.py --ablate-wgrad): GW_ABLATE_GATHER stages
// zeros instead of gathering rows, GW_ABLATE_MMA leaves out the mmas.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;        // also the rows a block tests at a time
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;            // listed rows staged at a time
constexpr int TARGET_BLOCKS = 4 * 132;

template <int CIN, int TN>
struct Tile {
  static constexpr int OUT = CIN * TN;                       // outputs a block
  static constexpr int MC = 4;                               // columns a thread
  static constexpr int MR = OUT > THREADS * MC ? OUT / (THREADS * MC) : 1;  // rows a thread
  static constexpr int P = (CIN / MR) * (TN / MC);           // threads a group
  static constexpr int G = THREADS / P;                      // groups
  static_assert(P * G == THREADS && CIN % MR == 0, "tile does not fit the block");
};

template <int CIN, int TN>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const float* __restrict__ feat, const int* __restrict__ rb,
                     const float* __restrict__ dout, float* __restrict__ partial,
                     int v_out, int num_k, int cout, int rows_per_slice) {
  using L = Tile<CIN, TN>;
  constexpr int MR = L::MR, MC = L::MC, G = L::G;
  constexpr int FPT = (ROWS * CIN + THREADS - 1) / THREADS;   // staged values a thread
  constexpr int DPT = (ROWS * TN + THREADS - 1) / THREADS;
  __shared__ int src_s[THREADS];                 // listed hits: feature row
  __shared__ int dst_s[THREADS];                 //              dout row
  __shared__ int cnt_s[WARPS];
  __shared__ __align__(16) float f_s[ROWS][CIN];
  __shared__ __align__(16) float d_s[ROWS][TN];
  __shared__ __align__(16) float red_s[G > 1 ? G * L::OUT : 1];

  const int k = blockIdx.x;
  const int n0 = blockIdx.y * TN;
  const int slice = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L::P, p = tid % L::P;
  const int cr = (p / (TN / MC)) * MR;           // this thread's first row of W's tile
  const int cc = (p % (TN / MC)) * MC;           // and first column
  const int begin = slice * rows_per_slice;
  const int end = min(v_out, begin + rows_per_slice);

  float acc[MR][MC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;

  // the next chunk's rulebook entry is read while this chunk is worked on
  int e_next = begin + tid < end ? rb[(size_t)(begin + tid) * num_k + k] : -1;
  for (int base = begin; base < end; base += THREADS) {
    const int v = base + tid;
    const int e = e_next;
    e_next = v + THREADS < end ? rb[(size_t)(v + THREADS) * num_k + k] : -1;
    const unsigned hits = __ballot_sync(FULL, e >= 0);
    if (lane == 0) cnt_s[warp] = __popc(hits);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = cnt_s[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (e >= 0) {
      const int at = off + __popc(hits & ((1u << lane) - 1u));
      src_s[at] = e;
      dst_s[at] = v;
    }
    __syncthreads();
    for (int t0 = 0; t0 < total; t0 += ROWS) {
      const int nr = min(ROWS, total - t0);
      // every load of the round is issued before the first store, so that
      // they are in flight together
      float fv[FPT], dv[DPT];
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        const int i = tid + j * THREADS, r = i / CIN;
        fv[j] = i < ROWS * CIN && r < nr
                    ? feat[(size_t)src_s[t0 + r] * CIN + i % CIN] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int i = tid + j * THREADS, r = i / TN;
        dv[j] = i < ROWS * TN && r < nr ? dout[(size_t)dst_s[t0 + r] * cout + n0 + i % TN]
                                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        const int i = tid + j * THREADS;
        if (i < ROWS * CIN) f_s[i / CIN][i % CIN] = fv[j];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int i = tid + j * THREADS;
        if (i < ROWS * TN) d_s[i / TN][i % TN] = dv[j];
      }
      __syncthreads();
      for (int r = grp; r < nr; r += G) {
        float f[MR], d[MC];
#pragma unroll
        for (int i = 0; i < MR; ++i) f[i] = f_s[r][cr + i];
        const float4 dq = *reinterpret_cast<const float4*>(&d_s[r][cc]);
        d[0] = dq.x; d[1] = dq.y; d[2] = dq.z; d[3] = dq.w;
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < MC; ++j) acc[i][j] = fmaf(f[i], d[j], acc[i][j]);
      }
      __syncthreads();
    }
    __syncthreads();                             // cnt_s and the list are reused
  }

  float* out = partial + ((size_t)slice * num_k + k) * CIN * cout + n0;
  if constexpr (G == 1) {
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) out[(size_t)(cr + i) * cout + cc + j] = acc[i][j];
  } else {
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) red_s[grp * L::OUT + (cr + i) * TN + cc + j] = acc[i][j];
    __syncthreads();
    for (int o = tid; o < L::OUT; o += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s += red_s[g * L::OUT + o];
      out[(size_t)(o / TN) * cout + o % TN] = s;
    }
  }
}

// ---------------------------------------------------------------- tensor cores

constexpr int MMA_THREADS = 128;     // also the rows a slice is a multiple of
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int GROUP = 64;            // listed hits staged at a time (4 depth steps)
constexpr int LIST_CAP = 2048;       // rows a slice at most: its hits fit the list
constexpr int SCAN = 8;              // rulebook entries a thread reads a round
constexpr int TERMS = 3;             // bf16 terms of the output gradient
constexpr int PAD = 8;               // bf16 a staged row is padded by

template <int CIN, int TN>
struct MmaTile {
  static constexpr int CS = CIN < 16 ? 16 : CIN;         // staged channels (zeros past CIN)
  static constexpr int WM = CS >= 64 ? 2 : 1;            // warps along Cin
  static constexpr int WN = TN >= 64 ? 2 : 1;            // warps along the Cout tile
  static constexpr int WK = MMA_WARPS / (WM * WN);       // warps along the depth
  static constexpr int MT = CS / 16 / WM;                // m16 tiles a warp
  static constexpr int NT = TN / 8 / WN;                 // n8 tiles a warp
  static constexpr int FS = CS + PAD, DS = TN + PAD;     // staged row strides (bf16)
  static constexpr int VEC = CIN < 8 ? CIN : 8;          // channels a feature load
  static constexpr int NFV = GROUP * CIN / VEC;          // feature loads a group
  static constexpr int FV = (NFV + MMA_THREADS - 1) / MMA_THREADS;  // ... a thread
  static constexpr int DV = GROUP * TN / 4 / MMA_THREADS;   // 16 B dout loads a thread
  static constexpr int LIST_BYTES = 2 * LIST_CAP * 4;
  static constexpr int STAGE_BYTES = GROUP * (FS + TERMS * DS) * 2;
  static constexpr int RED_BYTES = WK > 1 ? WK * CS * TN * 4 : 0;
  static constexpr int SMEM = LIST_BYTES + STAGE_BYTES > RED_BYTES
                                  ? LIST_BYTES + STAGE_BYTES : RED_BYTES;
  using FVec = std::conditional_t<VEC == 8, uint4, uint2>;
  static_assert(WK >= 1 && MT >= 1 && NT % 2 == 0, "warps do not tile the block");
  static_assert(VEC * sizeof(__nv_bfloat16) == sizeof(FVec) && CIN % VEC == 0 &&
                DV * MMA_THREADS * 4 == GROUP * TN, "staging loads do not fit");
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, register i holds the lane's pair of it
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x -> the three bf16 terms of the output gradient, each rounded to nearest
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&t)[TERMS]) {
  t[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
}

template <int CIN, int TN>
__global__ void __launch_bounds__(MMA_THREADS)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rbt,
                 const float* __restrict__ dout, float* __restrict__ partial, int v_out,
                 int num_k, int cout, int rows_per_slice) {
  using L = MmaTile<CIN, TN>;
  constexpr int MT = L::MT, NT = L::NT, WK = L::WK, FS = L::FS, DS = L::DS, CS = L::CS;
  constexpr int VPR = CIN / L::VEC;                        // feature loads a row
  using FVec = typename L::FVec;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);               // listed hits: feature row
  int* dst_s = src_s + LIST_CAP;                           //              dout row
  __nv_bfloat16* f_s = reinterpret_cast<__nv_bfloat16*>(smem + L::LIST_BYTES);  // [GROUP][FS]
  __nv_bfloat16* d_s = f_s + GROUP * FS;                   // [TERMS][GROUP][DS]
  __shared__ int cnt_s[2][SCAN][MMA_WARPS];

  const int k = blockIdx.x;
  const int n0 = blockIdx.y * TN;
  const int slice = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int begin = slice * rows_per_slice;
  const int end = min(v_out, begin + rows_per_slice);

  // 1. the slice's hits of offset k, in row order: row r0 + j * 128 + tid
  //    is entry j of thread tid, so (j, warp, lane) is row order
  const int* column = rbt + (size_t)k * v_out;
  int nh = 0;
  for (int r0 = begin, par = 0; r0 < end; r0 += MMA_THREADS * SCAN, par ^= 1) {
    int e[SCAN];
    unsigned b[SCAN];
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int v = r0 + j * MMA_THREADS + tid;
      e[j] = v < end ? __ldg(column + v) : -1;
    }
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      b[j] = __ballot_sync(FULL, e[j] >= 0);
      if (lane == 0) cnt_s[par][j][warp] = __popc(b[j]);
    }
    __syncthreads();
    int at[SCAN];
    int run = nh;
#pragma unroll
    for (int j = 0; j < SCAN; ++j)
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w) {
        if (w == warp) at[j] = run;
        run += cnt_s[par][j][w];
      }
#pragma unroll
    for (int j = 0; j < SCAN; ++j)
      if (e[j] >= 0) {
        const int i = at[j] + __popc(b[j] & ((1u << lane) - 1u));
        src_s[i] = e[j];
        dst_s[i] = r0 + j * MMA_THREADS + tid;
      }
    nh = run;
  }
  __syncthreads();

  // 2. groups of 64 listed hits through the tensor cores
  const int wk = warp % WK, wm = (warp / WK) % L::WM, wn = warp / WK / L::WM;
  const int cm = wm * MT * 16, cn = wn * NT * 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  FVec fv[L::FV];
  float4 dv[L::DV];
  auto load = [&](int h0) {          // the group's rows into registers (zeros past the list)
#pragma unroll
    for (int i = 0; i < L::FV; ++i) {
      const int idx = tid + i * MMA_THREADS, h = h0 + idx / VPR;
      fv[i] = FVec{};
#ifndef GW_ABLATE_GATHER
      if (idx < L::NFV && h < nh)
        fv[i] = __ldg(reinterpret_cast<const FVec*>(feat + (size_t)src_s[h] * CIN) + idx % VPR);
#endif
    }
#pragma unroll
    for (int i = 0; i < L::DV; ++i) {
      const int idx = tid + i * MMA_THREADS, h = h0 + idx / (TN / 4);
      dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#ifndef GW_ABLATE_GATHER
      if (h < nh)
        dv[i] = __ldg(reinterpret_cast<const float4*>(dout + (size_t)dst_s[h] * cout + n0) +
                      idx % (TN / 4));
#endif
    }
  };
  auto store = [&]() {               // registers -> staged rows; dout split into its terms
#pragma unroll
    for (int i = 0; i < L::FV; ++i) {
      const int idx = tid + i * MMA_THREADS;
      if (idx < L::NFV)
        *reinterpret_cast<FVec*>(f_s + (idx / VPR) * FS + L::VEC * (idx % VPR)) = fv[i];
    }
#pragma unroll
    for (int i = 0; i < L::DV; ++i) {
      const int idx = tid + i * MMA_THREADS;
      __nv_bfloat16 x[4][TERMS];
      split3(dv[i].x, x[0]);
      split3(dv[i].y, x[1]);
      split3(dv[i].z, x[2]);
      split3(dv[i].w, x[3]);
#pragma unroll
      for (int p = 0; p < TERMS; ++p)
        *reinterpret_cast<uint2*>(d_s + (p * GROUP + idx / (TN / 4)) * DS + 4 * (idx % (TN / 4))) =
            make_uint2(pack2(x[0][p], x[1][p]), pack2(x[2][p], x[3][p]));
    }
  };

  // ldmatrix row addresses: A's matrices are (hits 0-7 | 8-15) x (channels
  // 0-7 | 8-15) in the order of the mma's a0..a3; B's (hits 0-7 | 8-15) x
  // (columns of n-tile 2jp | 2jp + 1) in the order b0, b1 of each
  const int a_row = (lane & 7) + 8 * (lane >> 4), a_col = 8 * ((lane >> 3) & 1);
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1), b_col = 8 * (lane >> 4);
  if constexpr (CIN < CS)            // the staged channels past CIN stay zero
    for (int i = tid; i < GROUP * FS / 8; i += MMA_THREADS)
      reinterpret_cast<uint4*>(f_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (nh > 0) load(0);
  for (int h0 = 0; h0 < nh; h0 += GROUP) {
    __syncthreads();                 // every warp is done with the last group
    store();
    __syncthreads();
    if (h0 + GROUP < nh) load(h0 + GROUP);
    const int steps = min(GROUP, nh - h0 + 15) / 16;      // the rest are zero rows
    for (int s = wk; s < steps; s += WK) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(a[mt], f_s + (16 * s + a_row) * FS + cm + 16 * mt + a_col);
#pragma unroll
      for (int p = 0; p < TERMS; ++p)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_trans(b, d_s + (p * GROUP + 16 * s + b_row) * DS + cn + 16 * jp + b_col);
#ifndef GW_ABLATE_MMA
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * jp], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
          }
#endif
        }
    }
  }

  // 3. the tile (the depth warps summed in warp order) to the slice's partial
  float* out = partial + ((size_t)slice * num_k + k) * CIN * cout + n0;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (WK == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (cm + 16 * mt + g + 8 * h < CIN)
            *reinterpret_cast<float2*>(out + (size_t)(cm + 16 * mt + g + 8 * h) * cout + cn +
                                       8 * j + 2 * t) =
                make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  } else {
    float* red = reinterpret_cast<float*>(smem);           // [WK][CS][TN]
    __syncthreads();                                       // the list and stage are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (wk * CS + cm + 16 * mt + g + 8 * h) * TN + cn +
                                     8 * j + 2 * t) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    __syncthreads();
    for (int o = tid; o < CIN * TN; o += MMA_THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) sum += red[w * CS * TN + o];
      out[(size_t)(o / TN) * cout + o % TN] = sum;
    }
  }
}

// dw[i] = sum over the slices, in slice order, of partial[slice][i]
__global__ void sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int n, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < slices; ++j) s += partial[(size_t)j * n + i];
  dw[i] = s;
}

template <int CIN>
cudaError_t launch_cin(const float* feat, const int* rb, const float* dout, float* partial,
                       int v_out, int num_k, int cout, int tn, int slices, int rps,
                       cudaStream_t stream) {
  dim3 grid(num_k, cout / tn, slices);
  switch (tn) {
    case 16: wgrad_partial_kernel<CIN, 16><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    case 32: wgrad_partial_kernel<CIN, 32><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    case 64: wgrad_partial_kernel<CIN, 64><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_fma(const float* feat, const int* rb, const float* dout, float* partial,
                       int v_out, int num_k, int cin, int cout, int tn, int slices, int rps,
                       cudaStream_t s) {
  switch (cin) {
    case 4: return launch_cin<4>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 8: return launch_cin<8>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 16: return launch_cin<16>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 32: return launch_cin<32>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 64: return launch_cin<64>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 128: return launch_cin<128>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int CIN, int TN>
cudaError_t launch_mma_tile(const __nv_bfloat16* feat, const int* rbt, const float* dout,
                            float* partial, int v_out, int num_k, int cout, int slices,
                            int rps, cudaStream_t stream) {
  constexpr int smem = MmaTile<CIN, TN>::SMEM;
  static bool opted_in = false;      // dynamic + static shared memory may pass 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_mma_kernel<CIN, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  dim3 grid(num_k, cout / TN, slices);
  wgrad_mma_kernel<CIN, TN><<<grid, MMA_THREADS, smem, stream>>>(
      feat, rbt, dout, partial, v_out, num_k, cout, rps);
  return cudaGetLastError();
}

template <int CIN>
cudaError_t launch_mma_cin(const __nv_bfloat16* feat, const int* rbt, const float* dout,
                           float* partial, int v_out, int num_k, int cout, int tn,
                           int slices, int rps, cudaStream_t s) {
  switch (tn) {
    case 16: return launch_mma_tile<CIN, 16>(feat, rbt, dout, partial, v_out, num_k, cout, slices, rps, s);
    case 32: return launch_mma_tile<CIN, 32>(feat, rbt, dout, partial, v_out, num_k, cout, slices, rps, s);
    case 64: return launch_mma_tile<CIN, 64>(feat, rbt, dout, partial, v_out, num_k, cout, slices, rps, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma(const __nv_bfloat16* feat, const int* rbt, const float* dout,
                       float* partial, int v_out, int num_k, int cin, int cout, int tn,
                       int slices, int rps, cudaStream_t s) {
  switch (cin) {
    case 4: return launch_mma_cin<4>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 8: return launch_mma_cin<8>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 16: return launch_mma_cin<16>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 32: return launch_mma_cin<32>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 64: return launch_mma_cin<64>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 128: return launch_mma_cin<128>(feat, rbt, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// How the rows are cut into slices: the wrapper sizes the scratch with it.
// Writes {slices, rows per slice}; returns 0.  The tensor-core route (bf16)
// keeps a slice within LIST_CAP rows.
int gather_gemm_wgrad_slices(int v_out, int num_k, int cin, int cout, int is_bf16, int* out) {
  const int tiles = num_k * (cout >= 64 ? cout / 64 : 1);
  const int unit = is_bf16 ? MMA_THREADS : THREADS;
  const int chunks = (v_out + unit - 1) / unit;
  int slices = (TARGET_BLOCKS + tiles - 1) / tiles;
  slices = slices < chunks ? slices : chunks;
  slices = slices > 1 ? slices : 1;
  int rps = ((chunks + slices - 1) / slices) * unit;
  if (is_bf16 && rps > LIST_CAP) rps = LIST_CAP;
  out[0] = v_out > 0 ? (v_out + rps - 1) / rps : 1;
  out[1] = rps;
  return 0;
}

// feat (V_in, cin) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); rb (v_out, num_k)
// int32 (-1 = none) and the same rulebook transposed, rbt (num_k, v_out),
// which the tensor-core route (bf16; feat, dout and rbt 16-byte aligned)
// reads instead and the f32 route does not read (may be null there);
// dout (v_out, cout) f32; dw (num_k, cin, cout) f32; partial: scratch of
// slices * num_k * cin * cout floats (slices from gather_gemm_wgrad_slices).
// cin in {4, 8, 16, 32, 64, 128}; cout in {16, 32} or a multiple of 64.
int gather_gemm_wgrad_launch(const void* feat, const int* rb, const int* rbt,
                             const float* dout, float* partial, float* dw, int v_out,
                             int num_k, int cin, int cout, int is_bf16, void* stream) {
  if (num_k < 1) return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  if (is_bf16 && rbt == nullptr) return cudaErrorInvalidValue;
  int cut[2];
  gather_gemm_wgrad_slices(v_out, num_k, cin, cout, is_bf16, cut);
  const int tn = cout >= 64 ? 64 : cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = launch_mma(static_cast<const __nv_bfloat16*>(feat), rbt, dout, partial, v_out, num_k,
                   cin, cout, tn, cut[0], cut[1], s);
  else
    e = launch_fma(static_cast<const float*>(feat), rb, dout, partial, v_out, num_k, cin, cout,
                   tn, cut[0], cut[1], s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = num_k * cin * cout;
  sum_slices_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, cut[0]);
  return static_cast<int>(cudaGetLastError());
}

const char* gather_gemm_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
