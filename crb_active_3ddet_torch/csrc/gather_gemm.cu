// Sparse-conv gather-GEMM for Hopper (sm_90a):
//     out[v, :] = sum_k feat[rb[v, k], :] @ W[k]      (rb[v, k] == -1: no neighbour)
//
// Replaces the Pallas kernel crb_active_3ddet_tpu/ops/pallas_kernels.py
// (sparse_conv_gather_gemm / _gather_gemm_kernel).  There the grid ran
// (voxel block, offset) in order and carried the sum in VMEM scratch from one
// grid step to the next; on the GPU blocks run in no order, so the offset
// loop runs inside the kernel and the sum stays in registers.
//
// What bounds it on the H100.  By bytes moved once (features, rulebook,
// weights in, f32 rows out) a layer of the SECOND backbone is 5-12 us, and
// the products of the entries that hit are less than that on tensor cores.
// What a kernel can lose is (a) products on CUDA cores, (b) work on entries
// that are -1 (67-97 % of a layer's rulebook, and every row of the buffers'
// padding), (c) block barriers between gather and product, (d) re-reading
// W[k] per tile.  The design below answers each.  What is left, by builds
// with the gather (GG_ABLATE_A) or the weight reads (GG_ABLATE_B) compiled
// out (chip_smoke.py --ablate-k2): at conv3.1 (64 -> 64, the longest layer)
// rulebook read, masks, mmas and output rows alone take 57 % of the time,
// taking out the gather saves 20 % and the weight reads 24 %; the parts
// overlap and add up differently at other layers.  In conv2-conv4 53-91 %
// of the rows that go through an mma are zero rows (a 16-row group runs an
// offset as soon as one of its rows hits), which compacting the hit rows
// into dense fragments would save.
//
// bf16: tensor cores, no shared-memory tile, no block barrier
//   * a warp owns 32 output rows (two m16 tiles); it reads its (32, K) block
//     of the rulebook once, coalesced (16 B a lane), into warp-private shared
//     memory and derives with __ballot_sync, for each 16-row tile, the bitmask
//     of offsets with at least one hit; it walks the set bits only.  A warp
//     whose mask is 0 (padding rows) writes zeros and leaves;
//   * the product is mma.sync.m16n8k16 on bf16 with f32 accumulators.  The A
//     fragment is gathered straight into registers: the four lanes of a quad
//     read 16 B each of their row (8 B at Cin 16), a -1 entry reads nothing
//     and gives zeros.  A sum over the depth index does not care in which
//     order the columns sit, so the depth slots of the mma are a fixed
//     permutation of the feature columns (lane t of a quad holds columns
//     8t..8t+7 of each 32-column chunk) and need no ldmatrix shuffle;
//   * Cin 4 (conv_input) does not fill a depth of 16: four offsets are
//     folded into one mma step, lane t of a quad gathering the whole 8-byte
//     row of offset 4u + t, and the masks count groups of four offsets
//     (Cin 8: two offsets a step, two lanes an offset);
//   * W is brought into the same permuted order, one 16 B B-fragment pair a
//     lane a (offset, step, two n-tiles), by a small pack kernel in the same
//     launch call; the main kernel reads the fragments through L1 with __ldg
//     (W is at most 221 KB and stays in L1/L2; the warps of an SM walk the
//     offsets at about the same pace).  One load serves four mmas (two
//     n-tiles x two m16 tiles), and consecutive mmas go to different
//     accumulators;
//   * the next offset's rows are gathered before the current offset's
//     products are started (register double buffer);
//   * every output element is summed by one thread in ascending offset order:
//     no atomics, the same bits on every run.
//
// The backward's dgrad runs this same kernel: dfeat[i] = sum_k dout[inv[i, k]]
// @ W[k]^T over the inverse rulebook (ops/sparse/rulebook.py), so its Cin is
// the forward's Cout, up to 128 (conv_out); the wgrad is gather_gemm_wgrad.cu.
//
// f32: CUDA cores in exact f32 (the AL configs' route, forward and dgrad)
//   * what bounds it: by bytes a layer of the AL scan (batch 4, 16 000-voxel
//     buffers) is 10-30 us; the products of the entries that hit, at the
//     card's 67 TFLOP/s of f32 FMA, are less.  The first kernel lost 18x
//     that (2.2x the f32 matmul over the dense gather) to (1) one 4-byte
//     shared load per FMA, (2) every offset run for all 64 rows of a tile
//     when one row hit it, (3) scalar gathers after a barrier, nothing in
//     flight under the FMAs, two barriers per offset, (4) Cin 4 and 8 paying
//     that per 4 or 8 columns;
//   * (2) a block owns 128 rows x TN = min(Cout, 64) columns.  It reads its
//     (128, K) rulebook block once and lists, per offset, the rows that hit
//     (warp ballots and prefix counts, rows ascending).  Only listed rows
//     are gathered and multiplied; the accumulators stay in shared memory
//     between steps, so a row that misses costs nothing;
//   * (1) a step's n hits are split evenly over the block's entry groups
//     (16 lanes x 4 columns each at TN 64): a thread takes ceil(n / 16) of
//     them (at most 8), loads their accumulators, and per 4 channels reads
//     one float4 of each hit's gathered row and 4 float4s of W and runs up
//     to 128 FMAs; a warp's groups read distinct banks;
//   * (3) a step is (offset, chunk of 32 channels).  The next step's gathered rows and W[k] are staged with
//     cp.async, 16 B a lane (a -1 entry zero-fills), into the other half of
//     a double buffer while this step's FMAs run: one barrier a step;
//   * (4) below Cin 16, 16 / Cin offsets fold into one staged row of 16
//     values (conv_input: 7 steps over K = 27);
//   * the order rule: every output element is summed by one thread as one
//     fmaf chain from 0.0f, in ascending offset and, within an offset,
//     ascending input channel, leaving out only products that are exactly 0
//     (the rows that miss).  At the AL path's shapes that is also the order
//     of the plain version's f32 matmul (TF32 off), and the two are
//     bit-equal; the route is bit-equal to itself on every run.  No TF32 or split-operand tensor-core product, no split of
//     the depth across threads, no partial sums added later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;            // offsets a rulebook row may hold (mask bits)
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- tensor cores

constexpr int MMA_WARPS = 4;
constexpr int MT = 2;                // m16 tiles a warp owns
constexpr int WARP_ROWS = 16 * MT;   // one rulebook row a lane

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// How the kernel cuts the sum over (offset, column) into depth-16 mma steps.
// A UNIT is what the offset loop walks and the masks count: one offset with
// CIN / 16 steps, or, below CIN 16, 16 / CIN offsets folded into one step.
// Lane t of a quad feeds 4 values into a step (mma slots 2t, 2t+1, 2t+8,
// 2t+9): columns column(s, t) + 0..3 of offset offset(u, t).
template <int CIN>
struct Steps {
  static constexpr int FOLD = CIN < 16 ? 16 / CIN : 1;   // offsets a unit
  static constexpr int KS = CIN < 16 ? 1 : CIN / 16;     // steps a unit
  static constexpr int WPL = 2 * KS;                     // A words a lane a row
  __host__ __device__ static int units(int num_k) { return (num_k + FOLD - 1) / FOLD; }
  __host__ __device__ static int offset(int u, int t) { return FOLD * u + t * FOLD / 4; }
  __host__ __device__ static int column(int s, int t) {
    return CIN >= 32 ? 32 * (s / 2) + 8 * t + 4 * (s % 2) : 4 * t % CIN;
  }
};

// W (K, CIN, cout) bf16 -> B fragments.  The uint4 at
// ((u * KS + s) * (cout / 16) + jp) * 32 + lane holds, for the n-tiles 2jp and
// 2jp + 1, the lane's 4 values of step s of unit u (zeros beyond offset K - 1).
template <int CIN>
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    uint2* __restrict__ wpack, int num_k, int cout) {
  using S = Steps<CIN>;
  const int ntt = cout / 8;
  const int total = S::units(num_k) * S::KS * ntt * 32;   // one uint2 a thread
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int jj = idx & 1;
  const int lane = (idx >> 1) & 31;
  const int jp = (idx >> 6) % (ntt / 2);
  const int us = idx / (32 * ntt);
  const int s = us % S::KS, u = us / S::KS;
  const int g = lane >> 2, t = lane & 3;
  const int k = S::offset(u, t);
  uint2 v = make_uint2(0u, 0u);
  if (k < num_k) {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(
        w + ((size_t)k * CIN + S::column(s, t)) * cout + 8 * (2 * jp + jj) + g);
    v.x = (uint32_t)s16[0] | ((uint32_t)s16[cout] << 16);
    v.y = (uint32_t)s16[2 * cout] | ((uint32_t)s16[3 * cout] << 16);
  }
  wpack[idx] = v;
}

// The A words of unit u for this lane's four rows (zeros for -1).
template <int CIN>
__device__ __forceinline__ void gather_rows(const __nv_bfloat16* __restrict__ feat,
                                            const int* rs, int num_k, int u, int g, int t,
                                            uint32_t (&a)[MT][2][Steps<CIN>::WPL]) {
  const int k = Steps<CIN>::offset(u, t);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#ifdef GG_ABLATE_A    // measurement build: gather nothing, multiply zeros
      const int src = -1;
#else
      const int src = k < num_k ? rs[(16 * mt + g + 8 * h) * num_k + k] : -1;
#endif
      if constexpr (CIN >= 32) {
#pragma unroll
        for (int q = 0; q < CIN / 32; ++q) {
          uint4 x = make_uint4(0u, 0u, 0u, 0u);
          if (src >= 0)
            x = __ldg(reinterpret_cast<const uint4*>(feat + (size_t)src * CIN + 32 * q + 8 * t));
          a[mt][h][4 * q + 0] = x.x;
          a[mt][h][4 * q + 1] = x.y;
          a[mt][h][4 * q + 2] = x.z;
          a[mt][h][4 * q + 3] = x.w;
        }
      } else {
        uint2 x = make_uint2(0u, 0u);
        if (src >= 0)
          x = __ldg(reinterpret_cast<const uint2*>(feat + (size_t)src * CIN
                                                   + Steps<CIN>::column(0, t)));
        a[mt][h][0] = x.x;
        a[mt][h][1] = x.y;
      }
    }
  }
}

template <int CIN, int NT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
gather_mma_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rb,
                  const uint4* __restrict__ wpack, float* __restrict__ out, int v_out,
                  int num_k, int cout) {
  using S = Steps<CIN>;
  constexpr int KS = S::KS, WPL = S::WPL;
  __shared__ __align__(16) int rb_s[MMA_WARPS][WARP_ROWS * MAX_K];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = (blockIdx.x * MMA_WARPS + warp) * WARP_ROWS;
  if (v0 >= v_out) return;                   // no block barrier below
  const int npt = cout / 16;                 // n-tile pairs of the whole output
  const int jp0 = blockIdx.y * (NT / 2);

  // the warp's (32, K) rulebook block, contiguous in memory, 16 B a lane
  int* rs = rb_s[warp];
  {
    const int total = WARP_ROWS * num_k;
    const int n_in = min(WARP_ROWS, v_out - v0) * num_k;
    const int* slab = rb + (size_t)v0 * num_k;
    for (int i = lane * 4; i < total; i += 128) {
      int4 e;
      if (i + 3 < n_in) {
        e = __ldg(reinterpret_cast<const int4*>(slab + i));
      } else {
        e.x = i + 0 < n_in ? slab[i + 0] : -1;
        e.y = i + 1 < n_in ? slab[i + 1] : -1;
        e.z = i + 2 < n_in ? slab[i + 2] : -1;
        e.w = i + 3 < n_in ? slab[i + 3] : -1;
      }
      *reinterpret_cast<int4*>(rs + i) = e;
    }
  }
  __syncwarp();

  // bit u of mask[mt]: a row of 16-row tile mt hits in unit u
  unsigned mask[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mask[mt] = 0u;
  for (int k = 0; k < num_k; ++k) {
    const unsigned b = __ballot_sync(FULL, rs[lane * num_k + k] >= 0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if ((b >> (16 * mt)) & 0xffffu) mask[mt] |= 1u << (k / S::FOLD);
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  unsigned todo = 0u;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) todo |= mask[mt];
  uint32_t a_next[MT][2][WPL];
  if (todo) gather_rows<CIN>(feat, rs, num_k, __ffs(todo) - 1, g, t, a_next);
  while (todo) {
    const int u = __ffs(todo) - 1;
    todo &= todo - 1;
    uint32_t a[MT][2][WPL];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < WPL; ++i) a[mt][h][i] = a_next[mt][h][i];
    if (todo) gather_rows<CIN>(feat, rs, num_k, __ffs(todo) - 1, g, t, a_next);
    // consecutive mmas go to different accumulators: one accumulator's next
    // step comes MT * NT mmas later
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
#ifdef GG_ABLATE_B    // measurement build: one B fragment for every step
        const uint4 y = __ldg(wpack + lane);
#else
        const uint4 y = __ldg(wpack + ((size_t)(u * KS + s) * npt + jp0 + jp) * 32 + lane);
#endif
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if ((mask[mt] >> u) & 1u) {          // the same for the whole warp
            mma_bf16(acc[mt][2 * jp], a[mt][0][2 * s], a[mt][1][2 * s],
                     a[mt][0][2 * s + 1], a[mt][1][2 * s + 1], y.x, y.y);
            mma_bf16(acc[mt][2 * jp + 1], a[mt][0][2 * s], a[mt][1][2 * s],
                     a[mt][0][2 * s + 1], a[mt][1][2 * s + 1], y.z, y.w);
          }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + 16 * mt + g + 8 * h;
      if (v < v_out) {
        float* o = out + (size_t)v * cout + 16 * jp0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
}

template <int CIN>
cudaError_t launch_mma(const __nv_bfloat16* feat, const int* rb, const __nv_bfloat16* w,
                       void* wpack, float* out, int v_out, int num_k, int cout,
                       cudaStream_t stream) {
  using S = Steps<CIN>;
  const int frags = S::units(num_k) * S::KS * (cout / 8) * 32;      // uint2 elements
  pack_weights_kernel<CIN><<<(frags + 255) / 256, 256, 0, stream>>>(
      w, static_cast<uint2*>(wpack), num_k, cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // at Cin 128 (the dgrad of conv_out, over its Cout) a warp's A fragments
  // take 64 registers, twice with the prefetch: half the n-tiles a block
  // keeps the accumulators at 32
  const int nt = cout >= 64 ? (CIN >= 128 ? 4 : 8) : cout / 8;
  dim3 grid((v_out + MMA_WARPS * WARP_ROWS - 1) / (MMA_WARPS * WARP_ROWS), cout / (8 * nt));
  const int threads = MMA_WARPS * 32;
  const uint4* wp = static_cast<const uint4*>(wpack);
  switch (nt) {
    case 2: gather_mma_kernel<CIN, 2><<<grid, threads, 0, stream>>>(
                feat, rb, wp, out, v_out, num_k, cout); break;
    case 4: gather_mma_kernel<CIN, 4><<<grid, threads, 0, stream>>>(
                feat, rb, wp, out, v_out, num_k, cout); break;
    case 8: gather_mma_kernel<CIN, 8><<<grid, threads, 0, stream>>>(
                feat, rb, wp, out, v_out, num_k, cout); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------------ CUDA cores

constexpr int FMA_THREADS = 256;
constexpr int FMA_BM = 128;          // rows a block owns (a hit list entry is a uint8)
constexpr int FMA_CC = 32;           // most input channels a step stages
constexpr int NR = 4;                // columns a thread owns: one float4

// How a block of the f32 kernel cuts its work.  A UNIT is what the hit lists
// count: one offset, or, below Cin 16, 16 / Cin offsets folded into one staged
// row.  A STEP stages, for one unit, its whole hit list (at most BM entries)
// and one chunk of CC input channels: D = F * CC values an entry, in
// (offset, channel) order.  The G entry groups of the block's threads split a
// step's n entries evenly: each takes mr = ceil(n / G) consecutive entries
// (at most MR = BM / G), so a step costs its busiest thread mr entries; a
// group's staged rows are followed by one float4 of padding, so that the
// groups of a warp read distinct banks.
template <int CIN, int TN>
struct Fma {
  static constexpr int F = CIN < 16 ? 16 / CIN : 1;            // offsets a unit
  static constexpr int CC = CIN < FMA_CC ? CIN : FMA_CC;        // channels a step
  static constexpr int NCH = CIN / CC;                          // chunks a unit
  static constexpr int D = F * CC;                              // depth of a step
  static constexpr int Q = D / 4;                               // float4s a staged row
  static constexpr int CG = TN / NR;                            // column groups
  static constexpr int G = FMA_THREADS / CG;                    // entry groups
  static constexpr int MR = FMA_BM / G;                         // most entries a group
  static constexpr int F_CHUNKS = FMA_BM * Q + G;               // float4s a feature buffer
  static constexpr int W_CHUNKS = D * TN / 4;                   // float4s a weight buffer
  static constexpr int ACC_LD = TN + 4;                         // floats an accumulator row
  static_assert(MR >= 1 && MR <= 8 && MR * G == FMA_BM && FMA_BM % 32 == 0, "tile");
  __host__ __device__ static int units(int num_k) { return (num_k + F - 1) / F; }
  __device__ static int entries_a_group(int n) { return min(MR, (n + G - 1) / G); }
  static size_t smem_bytes(int num_k) {
    return 16 * (2 * (size_t)F_CHUNKS + 2 * (size_t)W_CHUNKS)
        + 4 * (size_t)(FMA_BM + 1) * ACC_LD + 4 * (size_t)FMA_BM * num_k
        + (size_t)units(num_k) * FMA_BM;
  }
};

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One group's products of a step: M entries (rows arow[m] of the
// accumulators, scratch past the list) x the thread's 4 columns, continuing
// each element's fmaf chain over the step's D values in order
template <class S, int M, int TN>
__device__ __forceinline__ void fma_entries(float* acc_s, const int* arow,
                                            const float4* fb, const float4* wb) {
  float4 acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = *reinterpret_cast<const float4*>(acc_s + arow[m]);
#pragma unroll
  for (int q = 0; q < S::Q; ++q) {
    float4 fv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) fv[m] = fb[m * S::Q + q];
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 wv = wb[(4 * q + dd) * (TN / 4)];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float a = dd == 0 ? fv[m].x : dd == 1 ? fv[m].y : dd == 2 ? fv[m].z : fv[m].w;
        acc[m].x = fmaf(a, wv.x, acc[m].x);
        acc[m].y = fmaf(a, wv.y, acc[m].y);
        acc[m].z = fmaf(a, wv.z, acc[m].z);
        acc[m].w = fmaf(a, wv.w, acc[m].w);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) *reinterpret_cast<float4*>(acc_s + arow[m]) = acc[m];
}

template <int CIN, int TN>
__global__ void __launch_bounds__(FMA_THREADS)
gather_fma_kernel(const float* __restrict__ feat, const int* __restrict__ rb,
                  const float* __restrict__ w, float* __restrict__ out,
                  int v_out, int num_k, int cout) {
  using S = Fma<CIN, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* f_s = reinterpret_cast<float4*>(smem);                        // [2][F_CHUNKS]
  float4* w_s = f_s + 2 * S::F_CHUNKS;                                   // [2][D][TN / 4]
  float* acc_s = reinterpret_cast<float*>(w_s + 2 * S::W_CHUNKS);        // [BM + 1][ACC_LD]
  int* rb_s = reinterpret_cast<int*>(acc_s + (FMA_BM + 1) * S::ACC_LD);  // [BM][K]
  unsigned char* list_s = reinterpret_cast<unsigned char*>(rb_s + FMA_BM * num_k);
  __shared__ int cnt_s[MAX_K];                                           // hit list lengths

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * FMA_BM;
  const int n0 = blockIdx.y * TN;
  const int units = S::units(num_k);

  // the block's (BM, K) rulebook tile (-1 past v_out), accumulators at 0
  {
    const int n_in = min(FMA_BM, v_out - v0) * num_k;
    const int* slab = rb + (size_t)v0 * num_k;
    for (int i = tid; i < FMA_BM * num_k; i += FMA_THREADS)
      rb_s[i] = i < n_in ? __ldg(slab + i) : -1;
    float4* a4 = reinterpret_cast<float4*>(acc_s);
    for (int i = tid; i < (FMA_BM + 1) * S::ACC_LD / 4; i += FMA_THREADS)
      a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // hit lists: each warp builds those of every (FMA_THREADS / 32)-th unit:
  // the rows, in ascending order, with a hit at one of the unit's offsets
  for (int u = warp; u < units; u += FMA_THREADS / 32) {
    int n = 0;
    for (int q = 0; q < FMA_BM / 32; ++q) {
      const int r = 32 * q + lane;
      bool hit = false;
#pragma unroll
      for (int f = 0; f < S::F; ++f) {
        const int k = S::F * u + f;
        hit |= k < num_k && rb_s[r * num_k + k] >= 0;
      }
      const unsigned b = __ballot_sync(FULL, hit);
      if (hit) list_s[u * FMA_BM + n + __popc(b & ((1u << lane) - 1u))] = (unsigned char)r;
      n += __popc(b);
    }
    if (lane == 0) cnt_s[u] = n;
  }
  __syncthreads();
  unsigned todo = 0u;
  for (int u = 0; u < units; ++u)
    if (cnt_s[u]) todo |= 1u << u;

  // stage step (u, chunk c) into buffer b: the gathered rows of the unit's
  // hits (zeros for -1 and past K), group by group, and its weight rows
  auto stage = [&](int u, int c, int b) {
    const int n_e = cnt_s[u];
#ifndef GG_ABLATE_A    // measurement build: gather nothing
    const int mr = S::entries_a_group(n_e);
    float4* fb = f_s + b * S::F_CHUNKS;
    constexpr int PER_ENTRY = S::F * (S::CC / 4);
    for (int idx = tid; idx < n_e * PER_ENTRY; idx += FMA_THREADS) {
      const int i = idx / PER_ENTRY, q = idx % PER_ENTRY;
      const int f = q / (S::CC / 4), c4 = q % (S::CC / 4);
      const int k = S::F * u + f;
      const int src = k < num_k ? rb_s[list_s[u * FMA_BM + i] * num_k + k] : -1;
      cp_async16(fb + i * S::Q + i / mr + q,
                 src >= 0 ? feat + (size_t)src * CIN + c * S::CC + 4 * c4 : feat,
                 src >= 0 ? 16 : 0);
    }
#endif
#ifndef GG_ABLATE_B    // measurement build: read no weights
    float4* wb = w_s + b * S::W_CHUNKS;
    for (int idx = tid; idx < S::W_CHUNKS; idx += FMA_THREADS) {
      const int d = idx / (TN / 4), n4 = idx % (TN / 4);
      const int k = S::F * u + d / S::CC;
      cp_async16(wb + idx,
                 k < num_k ? w + ((size_t)k * CIN + c * S::CC + d % S::CC) * cout + n0 + 4 * n4
                           : w,
                 k < num_k ? 16 : 0);
    }
#endif
    cp_async_commit();
  };

  // one step's products: group g of the step's entry groups takes entries
  // g * mr .. g * mr + mr - 1, thread (g, j) their columns 4j..4j+3; each
  // output element is one fmaf chain, continued here over the step's D
  // values in (offset, channel) order
  auto compute = [&](int u, int b) {
    const int n_e = cnt_s[u];
    const int mr = S::entries_a_group(n_e);
    const int j = tid % S::CG, g = tid / S::CG;
    if (g * mr >= n_e) return;
    int arow[S::MR];
#pragma unroll
    for (int m = 0; m < S::MR; ++m) {
      const int e = g * mr + m;
      const int r = m < mr && e < n_e ? list_s[u * FMA_BM + e] : FMA_BM;  // BM: scratch
      arow[m] = r * S::ACC_LD + 4 * j;
    }
    const float4* fb = f_s + b * S::F_CHUNKS + g * (mr * S::Q + 1);
    const float4* wb = w_s + b * S::W_CHUNKS + j;
    switch (mr) {
      case 1: fma_entries<S, 1, TN>(acc_s, arow, fb, wb); break;
      case 2: fma_entries<S, 2, TN>(acc_s, arow, fb, wb); break;
      case 3: if constexpr (S::MR >= 3) fma_entries<S, 3, TN>(acc_s, arow, fb, wb); break;
      case 4: if constexpr (S::MR >= 4) fma_entries<S, 4, TN>(acc_s, arow, fb, wb); break;
      case 5: if constexpr (S::MR >= 5) fma_entries<S, 5, TN>(acc_s, arow, fb, wb); break;
      case 6: if constexpr (S::MR >= 6) fma_entries<S, 6, TN>(acc_s, arow, fb, wb); break;
      case 7: if constexpr (S::MR >= 7) fma_entries<S, 7, TN>(acc_s, arow, fb, wb); break;
      default: if constexpr (S::MR >= 8) fma_entries<S, 8, TN>(acc_s, arow, fb, wb); break;
    }
  };

  // steps in order: units with a hit ascending, then chunks.  One barrier a
  // step: it publishes the step's staged buffer and frees the other one
  // (every thread is done with the previous step), whose refill then runs
  // under this step's products
  int u = todo ? __ffs(todo) - 1 : -1, c = 0, b = 0;
  if (u >= 0) stage(u, 0, 0);
  while (u >= 0) {
    int nu = u, nc = c + 1;
    if (nc == S::NCH) {
      nc = 0;
      todo &= todo - 1u;
      nu = todo ? __ffs(todo) - 1 : -1;
    }
    cp_async_wait_all();
    __syncthreads();
    if (nu >= 0) stage(nu, nc, b ^ 1);
    compute(u, b);
    u = nu; c = nc; b ^= 1;
  }
  __syncthreads();
  for (int i = tid; i < FMA_BM * (TN / 4); i += FMA_THREADS) {
    const int r = i / (TN / 4), n4 = i % (TN / 4);
    if (v0 + r < v_out)
      *reinterpret_cast<float4*>(out + (size_t)(v0 + r) * cout + n0 + 4 * n4) =
          *reinterpret_cast<const float4*>(acc_s + r * S::ACC_LD + 4 * n4);
  }
}

template <int CIN, int TN>
cudaError_t launch_fma_tile(const float* feat, const int* rb, const float* w, float* out,
                            int v_out, int num_k, int cout, cudaStream_t stream) {
  const int smem = static_cast<int>(Fma<CIN, TN>::smem_bytes(num_k));
  // above 48 KB a block's shared memory must be asked for (on the current
  // device; not a stream operation, so a CUDA graph may capture the launch)
  const cudaError_t e = cudaFuncSetAttribute(
      gather_fma_kernel<CIN, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((v_out + FMA_BM - 1) / FMA_BM, cout / TN);
  gather_fma_kernel<CIN, TN><<<grid, FMA_THREADS, smem, stream>>>(
      feat, rb, w, out, v_out, num_k, cout);
  return cudaGetLastError();
}

template <int CIN>
cudaError_t launch_fma_cin(const float* feat, const int* rb, const float* w, float* out,
                           int v_out, int num_k, int cout, cudaStream_t stream) {
  switch (cout >= 64 ? 64 : cout) {
    case 16: return launch_fma_tile<CIN, 16>(feat, rb, w, out, v_out, num_k, cout, stream);
    case 32: return launch_fma_tile<CIN, 32>(feat, rb, w, out, v_out, num_k, cout, stream);
    case 64: return launch_fma_tile<CIN, 64>(feat, rb, w, out, v_out, num_k, cout, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fma(const float* f, const int* rb, const float* ww, float* out,
                       int v_out, int num_k, int cin, int cout, cudaStream_t stream) {
  switch (cin) {
    case 4: return launch_fma_cin<4>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 8: return launch_fma_cin<8>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 16: return launch_fma_cin<16>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 32: return launch_fma_cin<32>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 64: return launch_fma_cin<64>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 128: return launch_fma_cin<128>(f, rb, ww, out, v_out, num_k, cout, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// feat (V_in, cin), w (num_k, cin, cout): both f32 (is_bf16 = 0) or both
// bf16 (is_bf16 = 1); rb (v_out, num_k) int32, num_k <= 32; out (v_out, cout)
// f32.  cin in {4, 8, 16, 32, 64, 128}; cout in {16, 32} or a multiple of 64.
// bf16 runs on tensor cores and needs wpack, scratch of (num_k rounded up to a
// multiple of 4) * cin * cout bf16 values; feat, rb and wpack must then be
// 16-byte aligned.  f32 runs on CUDA cores and stages feat and w 16 bytes a
// lane: they must then be 16-byte aligned; wpack is not read.
int gather_gemm_launch(const void* feat, const int* rb, const void* w, void* wpack,
                       float* out, int v_out, int num_k, int cin, int cout,
                       int is_bf16, void* stream) {
  if (v_out == 0) return 0;
  if (num_k < 1 || num_k > MAX_K) return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if ((reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
      return cudaErrorInvalidValue;
    return static_cast<int>(launch_fma(static_cast<const float*>(feat), rb,
                                       static_cast<const float*>(w), out, v_out, num_k, cin,
                                       cout, s));
  }
  if (wpack == nullptr || (reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(rb) |
                           reinterpret_cast<uintptr_t>(wpack)) % 16 != 0)
    return cudaErrorInvalidValue;
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  const __nv_bfloat16* ww = static_cast<const __nv_bfloat16*>(w);
  cudaError_t e;
  switch (cin) {
    case 4: e = launch_mma<4>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    case 8: e = launch_mma<8>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    case 16: e = launch_mma<16>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    case 32: e = launch_mma<32>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    case 64: e = launch_mma<64>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    case 128: e = launch_mma<128>(f, rb, ww, wpack, out, v_out, num_k, cout, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* gather_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
