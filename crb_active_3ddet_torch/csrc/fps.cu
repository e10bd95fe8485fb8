// Farthest point sampling for Hopper (sm_90a):
//     out[b, 0] = 0
//     out[b, s] = argmax_i min_{t < s} |p[b, i] - p[b, out[b, t]]|^2
// over the valid points of frame b; ties go to the lowest index; invalid
// points are held at -1e10 and so are never chosen while a valid point is
// left (with fewer valid points than samples the lowest-index valid point
// repeats, with none index 0 repeats).
//
// Replaces the Pallas kernel crb_active_3ddet_tpu/ops/pallas_kernels.py
// (farthest_point_sample_pallas, body _fps_kernel).  What it keeps of that
// kernel is the function, not its shape: no lane padding, no masked-sum
// coordinate fetch (the chosen point is read by index), and the indices are
// stored as a plain (B, K) int32 tensor.
//
// What bounds it on the H100: neither bytes nor operations but latency.  The
// work is a chain of K - 1 steps, each a pass over the frame's points followed
// by a block-wide argmax whose result the next step needs; the bytes moved
// (points in once, K indices out) and the 9 f32 operations a point a step are
// both microseconds.  The design therefore keeps all state on chip for the
// whole chain and makes each step short:
//   * one thread block of 1024 threads per frame (grid = B), one launch for
//     the whole batch;
//   * the coordinates live in shared memory as three arrays (12 B a point:
//     216 KB at N = 18 000, under the 227 KB a block may opt into), read with
//     stride 1 across the threads;
//   * each thread keeps the running minimum distance of its <= 18 points in
//     registers (point i belongs to thread i % 1024, slot i / 1024), so the
//     kernel is built for N <= 18 432 and the launch refuses more;
//   * the argmax compares (value, index) pairs, greater value first, lower
//     index on equal values, in a warp butterfly; the 32 warp results go
//     through shared memory and every warp reduces them again, so all threads
//     hold the winner after ONE block barrier a step (the two scratch rows
//     alternate, which makes the second barrier unnecessary).
//
// The distance is (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn / __fadd_rn, and the file is built with -fmad=false):
// one differing index changes every later one, so the arithmetic is that of
// the plain PyTorch version to the last bit.
//
// Later work: a thread block cluster per frame (the points spread over the
// shared memory of several SMs, the argmax finished through distributed
// shared memory) would shorten each step's pass; B = 8 blocks use 8 of 132 SMs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 1024;
constexpr int PER_THREAD = 18;
constexpr int MAX_POINTS = THREADS * PER_THREAD;
constexpr float BIG = 1e10f;

// (v, i) <- the better of (v, i) and (ov, oi): greater value, then lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ points, const unsigned char* __restrict__ valid,
           int* __restrict__ out, int n, int k) {
  extern __shared__ float coords[];           // x[n], y[n], z[n]
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  float* sx = coords;
  float* sy = coords + n;
  float* sz = coords + 2 * n;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = points + (long long)blockIdx.x * n * 3;
  const unsigned char* ok = valid + (long long)blockIdx.x * n;
  int* o = out + (long long)blockIdx.x * k;

  for (int e = tid; e < 3 * n; e += THREADS) {      // coalesced (N, 3) read
    const int q = e / 3, c = e - 3 * q;
    coords[c * n + q] = p[e];
  }
  float dist[PER_THREAD];
  unsigned live = 0;                                // bit j: slot j is valid
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = j * THREADS + tid;
    const bool v = i < n && ok[i] != 0;
    live |= v ? (1u << j) : 0u;
    dist[j] = v ? BIG : -BIG;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < k; ++s) {
    const float cx = sx[last], cy = sy[last], cz = sz[last];
    float best_v = -CUDART_INF_F;                   // below every real entry
    int best_i = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = j * THREADS + tid;
      if (i < n) {
        const float dx = __fsub_rn(sx[i], cx);
        const float dy = __fsub_rn(sy[i], cy);
        const float dz = __fsub_rn(sz[i], cz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        d = ((live >> j) & 1u) ? d : -BIG;
        const float m = fminf(dist[j], d);
        dist[j] = m;
        if (m > best_v) {                           // i ascends with j
          best_v = m;
          best_i = i;
        }
      }
    }
    warp_argmax(best_v, best_i);
    const int row = s & 1;
    if (lane == 0) {
      red_v[row][warp] = best_v;
      red_i[row][warp] = best_i;
    }
    __syncthreads();
    best_v = red_v[row][lane];
    best_i = red_i[row][lane];
    warp_argmax(best_v, best_i);
    last = best_i < n ? best_i : 0;               // only if every entry is NaN
    if (tid == 0) o[s] = last;
  }
}

}  // namespace

extern "C" {

// Most points a frame may hold (the per-thread register array's capacity).
int fps_max_points() { return MAX_POINTS; }

// points (B, N, 3) f32, valid (B, N) bytes (0 = padding), out (B, K) int32.
int fps_launch(const float* points, const unsigned char* valid, int* out, int B,
               int N, int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  if (N < 1 || N > MAX_POINTS) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      3 * MAX_POINTS * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      points, valid, out, N, K);
  return static_cast<int>(cudaGetLastError());
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
