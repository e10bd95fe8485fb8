// Sparse-conv gather-GEMM for Hopper (sm_90a):
//     out[v, :] = sum_k feat[rb[v, k], :] @ W[k]      (rb[v, k] == -1: no neighbour)
//
// Replaces the Pallas kernel crb_active_3ddet_tpu/ops/pallas_kernels.py
// (sparse_conv_gather_gemm / _gather_gemm_kernel).  There the grid ran
// (voxel block, offset) in order and carried the sum in VMEM scratch from one
// grid step to the next; on the GPU blocks run in no order, so the offset
// loop runs inside the block and the sum stays in registers.
//
// What bounds it on the H100: the feature rows are re-read once per offset
// (27 gathers of Cin values per output row), while the math is 2*Cin*Cout
// per gathered row.  At the SECOND layer shapes (Cin 4..64, Cout 16..128)
// the gathered bytes dominate and the roofline is set by memory, but a row
// gather is a scattered access, so the practical limit is L2/DRAM latency
// of the gather rather than the peak rate.
//
// Design (simple and right first):
//   * one block of 256 threads per tile of 64 output rows x TN output
//     columns (TN = min(Cout, 64); blockIdx.y walks Cout in TN steps);
//   * per offset k: load the tile's 64 rulebook entries into shared memory,
//     stage W[k][:, n0:n0+TN] as f32 in shared memory, gather the 64 feature
//     rows (zeros for -1) as f32 into shared memory, then every thread
//     accumulates TN/4 outputs with plain f32 FMAs;
//   * inputs f32 or bf16 (widened to f32 on load; a bf16*bf16 product is
//     exact in f32), output f32.  The kernel allocates nothing.
// Later work: mma.sync/wgmma on bf16 tiles, skipping all-missing offsets,
// and gathering from the packed (V, 9) window rulebook.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TILE_V = 64;
constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int CIN, int TN>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
                   const T* __restrict__ w, float* __restrict__ out,
                   int v_out, int num_k, int cout) {
  constexpr int RSTEP = THREADS / TN;      // rows between one thread's outputs
  constexpr int NPT = TILE_V / RSTEP;      // outputs per thread
  __shared__ int rb_s[TILE_V];
  __shared__ float f_s[TILE_V][CIN + 1];   // +1: rows fall in distinct banks
  __shared__ float w_s[CIN][TN];

  const int v0 = blockIdx.x * TILE_V;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int col = tid % TN;
  const int row0 = tid / TN;

  float acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.f;

  for (int k = 0; k < num_k; ++k) {
    if (tid < TILE_V) {
      const int v = v0 + tid;
      rb_s[tid] = v < v_out ? rb[(long long)v * num_k + k] : -1;
    }
    for (int idx = tid; idx < CIN * TN; idx += THREADS) {
      const int c = idx / TN, n = idx % TN;
      w_s[c][n] = to_f32(w[((long long)k * CIN + c) * cout + n0 + n]);
    }
    __syncthreads();
    for (int idx = tid; idx < TILE_V * CIN; idx += THREADS) {
      const int r = idx / CIN, c = idx % CIN;
      const int src = rb_s[r];
      f_s[r][c] = src >= 0 ? to_f32(feat[(long long)src * CIN + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CIN; ++c) {
      const float wv = w_s[c][col];
#pragma unroll
      for (int i = 0; i < NPT; ++i)
        acc[i] = fmaf(f_s[row0 + i * RSTEP][c], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int v = v0 + row0 + i * RSTEP;
    if (v < v_out) out[(long long)v * cout + n0 + col] = acc[i];
  }
}

template <typename T, int CIN>
cudaError_t launch_cin(const T* feat, const int* rb, const T* w, float* out,
                       int v_out, int num_k, int cout, cudaStream_t stream) {
  const int tn = cout >= 64 ? 64 : cout;
  dim3 grid((v_out + TILE_V - 1) / TILE_V, cout / tn);
  switch (tn) {
    case 16: gather_gemm_kernel<T, CIN, 16><<<grid, THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    case 32: gather_gemm_kernel<T, CIN, 32><<<grid, THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    case 64: gather_gemm_kernel<T, CIN, 64><<<grid, THREADS, 0, stream>>>(
                 feat, rb, w, out, v_out, num_k, cout); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* feat, const int* rb, const void* w, float* out,
                   int v_out, int num_k, int cin, int cout, cudaStream_t stream) {
  const T* f = static_cast<const T*>(feat);
  const T* ww = static_cast<const T*>(w);
  switch (cin) {
    case 4: return launch_cin<T, 4>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 8: return launch_cin<T, 8>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 16: return launch_cin<T, 16>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 32: return launch_cin<T, 32>(f, rb, ww, out, v_out, num_k, cout, stream);
    case 64: return launch_cin<T, 64>(f, rb, ww, out, v_out, num_k, cout, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// feat (V_in, cin), w (num_k, cin, cout): both f32 (is_bf16 = 0) or both
// bf16 (is_bf16 = 1); rb (v_out, num_k) int32; out (v_out, cout) f32.
// cin in {4, 8, 16, 32, 64}; cout in {16, 32} or a multiple of 64.
int gather_gemm_launch(const void* feat, const int* rb, const void* w,
                       float* out, int v_out, int num_k, int cin, int cout,
                       int is_bf16, void* stream) {
  if (v_out == 0) return 0;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16
      ? launch<__nv_bfloat16>(feat, rb, w, out, v_out, num_k, cin, cout, s)
      : launch<float>(feat, rb, w, out, v_out, num_k, cin, cout, s);
  return static_cast<int>(e);
}

const char* gather_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
