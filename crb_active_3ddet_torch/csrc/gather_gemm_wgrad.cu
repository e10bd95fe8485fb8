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
// What bounds it on the H100.  Per layer it reads the rulebook (V x K int32),
// the features and dout once and writes K x Cin x Cout floats: 0.4-14 MB, so
// 0.1-4 us by bytes.  The products of the entries that hit are 2 x hits x Cin
// x Cout operations: 0.1-2 GFLOP a layer of the SECOND backbone, 2-30 us on
// CUDA cores at the f32 peak.  A simple design is enough here (tensor cores,
// TMA and wider tiles are later work); what it does:
//   * a block owns one offset k, one Cout tile of TN <= 64 columns and one
//     slice of the rows v: K x Cout/TN x slices blocks, so that even K = 3
//     (conv_out) fills the card;
//   * it walks its rows 256 at a time: one rulebook entry a thread, the hits
//     compacted in row order (ballot, popcount, a prefix over 8 warps) into a
//     list in shared memory, so that rows without a hit (67-97 % of a layer's
//     entries) cost one 4-byte read and nothing else;
//   * 32 listed rows at a time are staged as f32 in shared memory (the
//     gathered feature rows, widened from bf16 exactly, and the dout rows),
//     each thread's loads of a round all issued before its first store, and
//     the next 256 rows' rulebook entries read while this chunk is worked
//     on (the kernel's time is latency: a chunk is a chain of dependent
//     loads and block barriers);
//     each thread keeps an MR x MC block of the (Cin, TN) tile in registers
//     and adds each row's outer product with FMAs.  Below 1024 outputs a
//     tile, G groups of threads take every G-th row and are summed in group
//     order at the end;
//   * the slices' partial tiles go to scratch and a second kernel sums them
//     in slice order: no float atomics, the same bits on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;        // also the rows a block tests at a time
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;            // listed rows staged at a time
constexpr int TARGET_BLOCKS = 4 * 132;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int CIN, int TN>
struct Tile {
  static constexpr int OUT = CIN * TN;                       // outputs a block
  static constexpr int MC = 4;                               // columns a thread
  static constexpr int MR = OUT > THREADS * MC ? OUT / (THREADS * MC) : 1;  // rows a thread
  static constexpr int P = (CIN / MR) * (TN / MC);           // threads a group
  static constexpr int G = THREADS / P;                      // groups
  static_assert(P * G == THREADS && CIN % MR == 0, "tile does not fit the block");
};

template <typename T, int CIN, int TN>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
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
                    ? widen(feat[(size_t)src_s[t0 + r] * CIN + i % CIN]) : 0.f;
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

// dw[i] = sum over the slices, in slice order, of partial[slice][i]
__global__ void sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int n, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < slices; ++j) s += partial[(size_t)j * n + i];
  dw[i] = s;
}

template <typename T, int CIN>
cudaError_t launch_cin(const T* feat, const int* rb, const float* dout, float* partial,
                       int v_out, int num_k, int cout, int tn, int slices, int rps,
                       cudaStream_t stream) {
  dim3 grid(num_k, cout / tn, slices);
  switch (tn) {
    case 16: wgrad_partial_kernel<T, CIN, 16><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    case 32: wgrad_partial_kernel<T, CIN, 32><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    case 64: wgrad_partial_kernel<T, CIN, 64><<<grid, THREADS, 0, stream>>>(
                 feat, rb, dout, partial, v_out, num_k, cout, rps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const T* feat, const int* rb, const float* dout, float* partial,
                         int v_out, int num_k, int cin, int cout, int tn, int slices,
                         int rps, cudaStream_t s) {
  switch (cin) {
    case 4: return launch_cin<T, 4>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 8: return launch_cin<T, 8>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 16: return launch_cin<T, 16>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 32: return launch_cin<T, 32>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 64: return launch_cin<T, 64>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    case 128: return launch_cin<T, 128>(feat, rb, dout, partial, v_out, num_k, cout, tn, slices, rps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// How the rows are cut into slices: the wrapper sizes the scratch with it.
// Writes {slices, rows per slice}; returns 0.
int gather_gemm_wgrad_slices(int v_out, int num_k, int cout, int* out) {
  const int tiles = num_k * (cout >= 64 ? cout / 64 : 1);
  const int chunks = (v_out + THREADS - 1) / THREADS;
  int slices = (TARGET_BLOCKS + tiles - 1) / tiles;
  slices = slices < chunks ? slices : chunks;
  slices = slices > 1 ? slices : 1;
  const int rps = ((chunks + slices - 1) / slices) * THREADS;
  out[0] = v_out > 0 ? (v_out + rps - 1) / rps : 1;
  out[1] = rps;
  return 0;
}

// feat (V_in, cin) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); rb (v_out, num_k)
// int32 (-1 = none); dout (v_out, cout) f32; dw (num_k, cin, cout) f32;
// partial: scratch of slices * num_k * cin * cout floats (slices from
// gather_gemm_wgrad_slices).  cin in {4, 8, 16, 32, 64, 128}; cout in {16, 32}
// or a multiple of 64.
int gather_gemm_wgrad_launch(const void* feat, const int* rb, const float* dout,
                             float* partial, float* dw, int v_out, int num_k, int cin,
                             int cout, int is_bf16, void* stream) {
  if (num_k < 1) return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  int cut[2];
  gather_gemm_wgrad_slices(v_out, num_k, cout, cut);
  const int tn = cout >= 64 ? 64 : cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16
      ? launch_typed(static_cast<const __nv_bfloat16*>(feat), rb, dout, partial, v_out,
                     num_k, cin, cout, tn, cut[0], cut[1], s)
      : launch_typed(static_cast<const float*>(feat), rb, dout, partial, v_out, num_k,
                     cin, cout, tn, cut[0], cut[1], s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = num_k * cin * cout;
  sum_slices_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, cut[0]);
  return static_cast<int>(cudaGetLastError());
}

const char* gather_gemm_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
