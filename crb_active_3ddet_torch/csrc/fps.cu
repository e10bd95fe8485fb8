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
// coordinate fetch, and the indices are stored as a plain (B, K) int32 tensor.
//
// What bounds it on the H100: neither bytes nor operations but latency.  The
// work is a chain of K - 1 steps, each a pass over the frame's points followed
// by an argmax over all of them whose result the next step needs; the bytes
// moved (points in once, K indices out) and the 10 f32 operations a point a
// step are both microseconds.  A step costs (a) the operations one SM's four
// schedulers must dispatch for the pass and the reduction, all warps of the
// block counted, and (b) the latency of agreeing on the winner.  The design:
//   * one thread block CLUSTER of 8 blocks a frame (grid = (8, B), one launch
//     for the whole batch), so eight SMs share a frame's pass.  Block r owns
//     the r-th eighth of the frame's points; coordinates and running minimum
//     distances live in registers (PT points a thread), nothing in shared
//     memory but the exchange slots.  PT is a template parameter with two
//     instances: 24 (24 576 points a frame, the synthetic and train buffers)
//     and 44 (45 056 points, KITTI's 45 000-point test buffer); the launch
//     takes the smaller one that holds the frame, so a frame of at most
//     24 576 points runs as it always did.  At 44 a thread holds 176 floats
//     of points and distances under __launch_bounds__(128, 1), within the
//     255 registers a thread may have;
//   * 128 threads a block: one warp a scheduler.  Every warp repeats the
//     reduction's operations, so more warps a block cost more dispatch slots a
//     step than their shorter pass saves (1 024 threads x 3 points a thread
//     took over twice the time of 128 x 24);
//   * the pass keeps only max(min-distance) a thread (10 operations a
//     point); the index is found afterwards, by the lanes that hold the warp's
//     maximum.  The argmax compares 64-bit keys, (distance bits mapped so that
//     unsigned order is float order) << 32 | ~index: the greater key is the
//     greater distance and, on equal distances, the lower index.  A warp
//     reduces with two redux.sync operations (high word, then low word
//     among the lanes that hold the high word's maximum);
//   * ONE exchange a step and no barrier: each warp sends its candidate (key
//     and the candidate's coordinates, 24 bytes) into its slot in the shared
//     memory of all 8 blocks with st.async, which counts the bytes on the
//     receiving block's mbarrier; a warp waits on its own block's mbarrier
//     until all 32 candidates have arrived, and reduces them itself.  The
//     winner's coordinates travel with its key, so no block reads another
//     block's points, and neither a block barrier nor a cluster barrier is on
//     the chain (with cluster.sync() in its place the same kernel took 1.4x
//     as long).  Slots and mbarriers are double-buffered: a block can be at
//     most one step ahead of the slowest, since it needs that block's
//     candidates;
//   * a slot without a point is held at -inf, below every real entry
//     (>= -1e10), so short frames and blocks without points need no branch.
// A cluster of 16 (non-portable size) halves the pass but was slower, for one
// frame and more so for eight: the exchange, not the pass, is what is left of
// a step.
//
// A third route takes the frames past 45 056 points (Waymo's 180 000-point
// buffer): fps_cluster_kernel, one cluster of 16 blocks a frame (the
// non-portable size, launched with cudaLaunchKernelEx), 256 threads a block.
// A frame's state, 180 000 x (12 bytes of coordinates + 4 of running
// distance) = 2.88 MB, is more than the register files of 8 SMs hold, so each
// block keeps the coordinates of its 11 264 points in shared memory (three
// planes x, y, z of 44 KB: each thread reads back only the points it wrote,
// so no barrier guards them, and a warp's 32 reads of a plane hit 32 banks)
// and their running distances in registers, 44 a thread.  The step is the
// same as above: a pass, a warp's candidate, one exchange by st.async into
// every block's slots, now 16 x 8 = 128 of them, each warp reducing all 128
// (four a lane).  At 180 000 points the pass is ~4x that of a 45 000-point
// frame, so the wider cluster's shorter pass outweighs its larger exchange.
//
// The distance is (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn / __fadd_rn, and the file is built with -fmad=false):
// one differing index changes every later one, so the arithmetic is that of
// the plain PyTorch version to the last bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float BIG = 1e10f;
constexpr unsigned FULL = 0xffffffffu;

// float bits -> unsigned whose order is the floats' order
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// max over the warp of the key (hi, lo); returns the lowest lane holding it
__device__ __forceinline__ int warp_max_key(unsigned hi, unsigned lo, unsigned& top_hi,
                                            unsigned& top_lo) {
  top_hi = __reduce_max_sync(FULL, hi);
  top_lo = __reduce_max_sync(FULL, hi == top_hi ? lo : 0u);
  return __ffs(__ballot_sync(FULL, hi == top_hi && lo == top_lo)) - 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// asynchronous remote stores that count their bytes on the target's mbarrier
__device__ __forceinline__ void st_async_u64(uint32_t addr, unsigned long long v, uint32_t bar) {
  asm volatile("st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
               :: "r"(addr), "l"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async_f4(uint32_t addr, float x, float y, float z, float w,
                                            uint32_t bar) {
  asm volatile("st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(addr), "f"(x), "f"(y), "f"(z), "f"(w), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

constexpr int CL = 8;                       // blocks a frame (portable maximum)
constexpr int THREADS = 128;                // one warp a scheduler
constexpr int WARPS = THREADS / 32;
constexpr int PT_NARROW = 24;               // points a thread, up to 24 576 a frame
constexpr int PT_WIDE = 44;                 // up to 45 056 a frame
constexpr int SLOTS = CL * WARPS;           // candidates a step
static_assert(SLOTS == 32, "the final reduction reads one candidate a lane");

template <int PT>
constexpr int capacity() { return CL * THREADS * PT; }

template <int PT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ points, const unsigned char* __restrict__ valid,
           int* __restrict__ out, int n, int k) {
  __shared__ __align__(16) unsigned long long key_s[2][SLOTS];
  __shared__ float4 xyz_s[2][SLOTS];
  __shared__ __align__(8) unsigned long long bar_s[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = points + (size_t)blockIdx.y * n * 3;
  const unsigned char* ok = valid + (size_t)blockIdx.y * n;
  int* o = out + (size_t)blockIdx.y * k;

  const int chunk = (n + CL - 1) / CL;              // points a block owns
  const int base = rank * chunk;
  const int end = min(n, base + chunk);

  // a slot without a point is held at -inf, below every real entry, and an
  // invalid point at -1e10, where min(., d >= 0) keeps it
  float px[PT], py[PT], pz[PT], dist[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int i = base + j * THREADS + tid;
    const bool own = i < end;
    px[j] = own ? p[3 * i + 0] : 0.f;
    py[j] = own ? p[3 * i + 1] : 0.f;
    pz[j] = own ? p[3 * i + 2] : 0.f;
    dist[j] = !own ? -CUDART_INF_F : (ok[i] != 0 ? BIG : -BIG);
  }
  float cx = p[0], cy = p[1], cz = p[2];            // the start is index 0
  if (rank == 0 && tid == 0) o[0] = 0;
  if (tid == 0) {
    mbar_init(smem_addr(&bar_s[0]), 1);
    mbar_init(smem_addr(&bar_s[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();                                   // every block has started

  for (int s = 1; s < k; ++s) {
    const int buf = s & 1;
    if (tid == 0) mbar_arrive_expect(smem_addr(&bar_s[buf]), SLOTS * 24);
    float best_v = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      best_v = fmaxf(best_v, dist[j]);
    }
    // the warp's candidate: greatest distance, then lowest index
    unsigned hi = ordered_bits(best_v), lo = 0u;
    unsigned top_hi = __reduce_max_sync(FULL, hi), top_lo;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (hi == top_hi) {
#pragma unroll
      for (int j = PT - 1; j >= 0; --j)
        if (dist[j] == best_v) {                    // the lowest j wins: i ascends with j
          lo = ~static_cast<unsigned>(base + j * THREADS + tid);
          bx = px[j];
          by = py[j];
          bz = pz[j];
        }
    }
    top_lo = __reduce_max_sync(FULL, lo);
    int src = __ffs(__ballot_sync(FULL, hi == top_hi && lo == top_lo)) - 1;
    const float wx = __shfl_sync(FULL, bx, src);
    const float wy = __shfl_sync(FULL, by, src);
    const float wz = __shfl_sync(FULL, bz, src);
    const int slot = rank * WARPS + warp;
    const unsigned long long key = (static_cast<unsigned long long>(top_hi) << 32) | top_lo;
    if (lane < 2 * CL) {
      const uint32_t to = lane & (CL - 1);
      const uint32_t bar = in_rank(smem_addr(&bar_s[buf]), to);
      if (lane < CL)
        st_async_u64(in_rank(smem_addr(&key_s[buf][slot]), to), key, bar);
      else
        st_async_f4(in_rank(smem_addr(&xyz_s[buf][slot]), to), wx, wy, wz, 0.f, bar);
    }
    mbar_wait(smem_addr(&bar_s[buf]), ((s - 1) >> 1) & 1);

    // every warp reduces all candidates itself, one a lane
    const unsigned long long cand = key_s[buf][lane];
    src = warp_max_key(static_cast<unsigned>(cand >> 32), static_cast<unsigned>(cand),
                       top_hi, top_lo);
    const float4 c = xyz_s[buf][src];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if (rank == 0 && tid == 0) {
      const unsigned last = ~top_lo;
      o[s] = last < static_cast<unsigned>(n) ? static_cast<int>(last) : 0;  // NaN only
    }
  }
  cluster.sync();        // no block leaves while another may still write to it
}

// Points a thread of the instance that a frame of N points runs on (0: none).
int points_per_thread(int N) {
  return N <= capacity<PT_NARROW>() ? PT_NARROW : N <= capacity<PT_WIDE>() ? PT_WIDE : 0;
}

constexpr int CL_BIG = 16;                      // blocks a frame (non-portable)
constexpr int THREADS_BIG = 256;
constexpr int WARPS_BIG = THREADS_BIG / 32;
constexpr int PT_BIG = 44;                      // points a thread
constexpr int SLOTS_BIG = CL_BIG * WARPS_BIG;   // candidates a step
constexpr int BLOCK_POINTS_BIG = THREADS_BIG * PT_BIG;
constexpr int CAPACITY_BIG = CL_BIG * BLOCK_POINTS_BIG;            // 180 224
constexpr int SMEM_BIG = 3 * BLOCK_POINTS_BIG * (int)sizeof(float);  // the x, y, z planes
static_assert(SLOTS_BIG % 32 == 0 && 2 * CL_BIG == 32,
              "a warp sends its key to every block from lanes 0-15, its point from 16-31");

__global__ void __launch_bounds__(THREADS_BIG, 1)
fps_cluster_kernel(const float* __restrict__ points, const unsigned char* __restrict__ valid,
                   int* __restrict__ out, int n, int k) {
  extern __shared__ float plane_s[];              // x, y, z of the block's points
  __shared__ __align__(16) unsigned long long key_s[2][SLOTS_BIG];
  __shared__ float4 xyz_s[2][SLOTS_BIG];
  __shared__ __align__(8) unsigned long long bar_s[2];
  float* xs = plane_s;
  float* ys = plane_s + BLOCK_POINTS_BIG;
  float* zs = plane_s + 2 * BLOCK_POINTS_BIG;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = points + (size_t)blockIdx.y * n * 3;
  const unsigned char* ok = valid + (size_t)blockIdx.y * n;
  int* o = out + (size_t)blockIdx.y * k;

  const int chunk = (n + CL_BIG - 1) / CL_BIG;
  const int base = rank * chunk;
  const int end = min(n, base + chunk);

  float dist[PT_BIG];
#pragma unroll
  for (int j = 0; j < PT_BIG; ++j) {
    const int l = j * THREADS_BIG + tid;
    const int i = base + l;
    const bool own = i < end;
    xs[l] = own ? p[3 * i + 0] : 0.f;
    ys[l] = own ? p[3 * i + 1] : 0.f;
    zs[l] = own ? p[3 * i + 2] : 0.f;
    dist[j] = !own ? -CUDART_INF_F : (ok[i] != 0 ? BIG : -BIG);
  }
  float cx = p[0], cy = p[1], cz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  if (tid == 0) {
    mbar_init(smem_addr(&bar_s[0]), 1);
    mbar_init(smem_addr(&bar_s[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  for (int s = 1; s < k; ++s) {
    const int buf = s & 1;
    if (tid == 0) mbar_arrive_expect(smem_addr(&bar_s[buf]), SLOTS_BIG * 24);
    float best_v = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PT_BIG; ++j) {
      const int l = j * THREADS_BIG + tid;
      const float dx = __fsub_rn(xs[l], cx);
      const float dy = __fsub_rn(ys[l], cy);
      const float dz = __fsub_rn(zs[l], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      best_v = fmaxf(best_v, dist[j]);
    }
    unsigned hi = ordered_bits(best_v), lo = 0u;
    unsigned top_hi = __reduce_max_sync(FULL, hi), top_lo;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (hi == top_hi) {
      int jj = 0;
#pragma unroll
      for (int j = PT_BIG - 1; j >= 0; --j)
        if (dist[j] == best_v) jj = j;            // the lowest j: i ascends with j
      const int l = jj * THREADS_BIG + tid;
      lo = ~static_cast<unsigned>(base + l);
      bx = xs[l];
      by = ys[l];
      bz = zs[l];
    }
    top_lo = __reduce_max_sync(FULL, lo);
    int src = __ffs(__ballot_sync(FULL, hi == top_hi && lo == top_lo)) - 1;
    const float wx = __shfl_sync(FULL, bx, src);
    const float wy = __shfl_sync(FULL, by, src);
    const float wz = __shfl_sync(FULL, bz, src);
    const int slot = rank * WARPS_BIG + warp;
    const unsigned long long key = (static_cast<unsigned long long>(top_hi) << 32) | top_lo;
    {
      const uint32_t to = lane & (CL_BIG - 1);
      const uint32_t bar = in_rank(smem_addr(&bar_s[buf]), to);
      if (lane < CL_BIG)
        st_async_u64(in_rank(smem_addr(&key_s[buf][slot]), to), key, bar);
      else
        st_async_f4(in_rank(smem_addr(&xyz_s[buf][slot]), to), wx, wy, wz, 0.f, bar);
    }
    mbar_wait(smem_addr(&bar_s[buf]), ((s - 1) >> 1) & 1);

    // every warp reduces all 128 candidates itself, four a lane (keys are
    // distinct: each carries its point's index)
    unsigned long long best = key_s[buf][lane];
    int best_slot = lane;
#pragma unroll
    for (int q = 1; q < SLOTS_BIG / 32; ++q) {
      const unsigned long long c = key_s[buf][lane + 32 * q];
      if (c > best) {
        best = c;
        best_slot = lane + 32 * q;
      }
    }
    src = warp_max_key(static_cast<unsigned>(best >> 32), static_cast<unsigned>(best),
                       top_hi, top_lo);
    const float4 c = xyz_s[buf][__shfl_sync(FULL, best_slot, src)];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if (rank == 0 && tid == 0) {
      const unsigned last = ~top_lo;
      o[s] = last < static_cast<unsigned>(n) ? static_cast<int>(last) : 0;  // NaN only
    }
  }
  cluster.sync();
}

// The third route's launch configuration: a cluster of 16 blocks a frame,
// B frames.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};

  ClusterLaunch(int B, cudaStream_t s) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL_BIG;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CL_BIG, B);
    cfg.blockDim = dim3(THREADS_BIG);
    cfg.dynamicSmemBytes = SMEM_BIG;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // cfg.attrs points into it
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// Clusters of the third route that the current device holds at once (0: the
// card cannot place a cluster of 16 blocks); sets the kernel's attributes.
cudaError_t cluster_route_clusters(int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(fps_cluster_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BIG);
  if (e != cudaSuccess) return e;
  const ClusterLaunch launch(1, 0);
  return cudaOccupancyMaxActiveClusters(clusters, fps_cluster_kernel, &launch.cfg);
}

cudaError_t launch_cluster_route(const float* points, const unsigned char* valid, int* out,
                                 int B, int N, int K, cudaStream_t s) {
  static int ready_device = -1;                   // attributes set and checked for it
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device != ready_device) {
    int clusters = 0;
    e = cluster_route_clusters(&clusters);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    ready_device = device;
  }
  const ClusterLaunch launch(B, s);
  return cudaLaunchKernelEx(&launch.cfg, fps_cluster_kernel, points, valid, out, N, K);
}

}  // namespace

extern "C" {

// Most points a frame may hold (the third route's 16 blocks).
int fps_max_points() { return CAPACITY_BIG; }

// Most points a frame of the two register instances may hold.
int fps_max_register_points() { return capacity<PT_WIDE>(); }

// Clusters of 16 blocks the current device holds at once, into *clusters.
int fps_cluster_occupancy(int* clusters) {
  *clusters = 0;
  return static_cast<int>(cluster_route_clusters(clusters));
}

// points (B, N, 3) f32, valid (B, N) bytes (0 = padding), out (B, K) int32.
int fps_launch(const float* points, const unsigned char* valid, int* out, int B,
               int N, int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  if (N < 1 || N > CAPACITY_BIG || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pt = points_per_thread(N);
  if (pt == PT_NARROW)
    fps_kernel<PT_NARROW><<<dim3(CL, B), THREADS, 0, s>>>(points, valid, out, N, K);
  else if (pt == PT_WIDE)
    fps_kernel<PT_WIDE><<<dim3(CL, B), THREADS, 0, s>>>(points, valid, out, N, K);
  else {
    const cudaError_t e = launch_cluster_route(points, valid, out, B, N, K, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
