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
// f32: CUDA cores in full f32 (a TF32 product would lose the 1e-4 agreement
// of the f32 models with the CPU path)
//   * a block of 256 threads owns 64 rows x TN columns (TN = min(Cout, 64));
//     it reads its (64, K) rulebook block once, coalesced, builds the tile's
//     offset mask, and for each offset that hits stages W[k] and the gathered
//     rows as f32 in shared memory and accumulates with FMAs.

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

constexpr int TILE_V = 64;
constexpr int FMA_THREADS = 256;

template <int CIN, int TN>
__global__ void __launch_bounds__(FMA_THREADS)
gather_fma_kernel(const float* __restrict__ feat, const int* __restrict__ rb,
                  const float* __restrict__ w, float* __restrict__ out,
                  int v_out, int num_k, int cout) {
  constexpr int RSTEP = FMA_THREADS / TN;  // rows between one thread's outputs
  constexpr int NPT = TILE_V / RSTEP;      // outputs per thread
  constexpr int CC = CIN < 64 ? CIN : 64;  // input columns staged at a time
  __shared__ int rb_s[TILE_V * MAX_K];     // the tile's (64, K) rulebook block
  __shared__ float f_s[TILE_V][CC + 1];    // +1: rows fall in distinct banks
  __shared__ float w_s[CC][TN];
  __shared__ unsigned mask_s;              // bit k: offset k hits in this tile

  const int v0 = blockIdx.x * TILE_V;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int col = tid % TN;
  const int row0 = tid / TN;

  if (tid == 0) mask_s = 0u;
  __syncthreads();
  {
    const int n_in = min(TILE_V, v_out - v0) * num_k;
    const int* slab = rb + (size_t)v0 * num_k;
    unsigned mine = 0u;
    for (int i = tid; i < TILE_V * num_k; i += FMA_THREADS) {
      const int e = i < n_in ? slab[i] : -1;
      rb_s[i] = e;
      if (e >= 0) mine |= 1u << (i % num_k);
    }
    mine = __reduce_or_sync(FULL, mine);
    if ((tid & 31) == 0 && mine) atomicOr(&mask_s, mine);
  }
  __syncthreads();

  float acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.f;

  // per offset, the columns in chunks of CC (one chunk up to Cin 64; the
  // chunks keep Cin 128, the dgrad of conv_out, in the same shared memory)
  for (unsigned todo = mask_s; todo; todo &= todo - 1) {
    const int k = __ffs(todo) - 1;
    for (int c0 = 0; c0 < CIN; c0 += CC) {
      for (int idx = tid; idx < CC * TN; idx += FMA_THREADS) {
        const int c = idx / TN, n = idx % TN;
        w_s[c][n] = w[((size_t)k * CIN + c0 + c) * cout + n0 + n];
      }
      for (int idx = tid; idx < TILE_V * CC; idx += FMA_THREADS) {
        const int r = idx / CC, c = idx % CC;
        const int src = rb_s[r * num_k + k];
        f_s[r][c] = src >= 0 ? feat[(size_t)src * CIN + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const float wv = w_s[c][col];
#pragma unroll
        for (int i = 0; i < NPT; ++i)
          acc[i] = fmaf(f_s[row0 + i * RSTEP][c], wv, acc[i]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int v = v0 + row0 + i * RSTEP;
    if (v < v_out) out[(size_t)v * cout + n0 + col] = acc[i];
  }
}

template <int CIN>
cudaError_t launch_fma_cin(const float* feat, const int* rb, const float* w, float* out,
                           int v_out, int num_k, int cout, cudaStream_t stream) {
  const int tn = cout >= 64 ? 64 : cout;
  dim3 grid((v_out + TILE_V - 1) / TILE_V, cout / tn);
  switch (tn) {
    case 16: gather_fma_kernel<CIN, 16><<<grid, FMA_THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    case 32: gather_fma_kernel<CIN, 32><<<grid, FMA_THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    case 64: gather_fma_kernel<CIN, 64><<<grid, FMA_THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
// 16-byte aligned.  f32 runs on CUDA cores; wpack is not read.
int gather_gemm_launch(const void* feat, const int* rb, const void* w, void* wpack,
                       float* out, int v_out, int num_k, int cin, int cout,
                       int is_bf16, void* stream) {
  if (v_out == 0) return 0;
  if (num_k < 1 || num_k > MAX_K) return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return static_cast<int>(launch_fma(static_cast<const float*>(feat), rb,
                                       static_cast<const float*>(w), out, v_out, num_k, cin,
                                       cout, s));
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
