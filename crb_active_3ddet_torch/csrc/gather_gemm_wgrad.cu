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
// Both routes read the rulebook transposed, (K, V_out) (ops/sparse/
// rulebook.py transpose_rulebook, built once a rulebook by the backbone), and
// split the hits over many blocks, so that even K = 3 (conv_out) fills the
// card: the tensor-core route cuts the rows into slices (a block owns one
// offset k, one Cout tile and one slice), the CUDA-core route gives each
// block an equal share of all the hits.  The blocks' partial tiles go to
// scratch and a second kernel sums them in a fixed order: no float atomics,
// the same bits on every run.
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
// which a TF32 or split-operand tensor-core product loses): CUDA cores in
// exact f32 (wgrad_fma_kernel)
//   * what bounds it: at the AL retrain's shapes (batch 4, 64 000 rows) the
//     64 x 64 layers are bound by their products at the card's 67 TFLOP/s of
//     f32 FMA (40-60 us each), the others by bytes (4-15 us).  The first
//     kernel ran at 10-14 % of the FMA peak where operations bound it and
//     lost to the f32 matmul over the dense gather at seven of twelve layers,
//     because (1) each thread read the (V_out, K) rulebook one entry at a
//     stride of K * 4 bytes, (2) it listed the hits of 256 rows at a time
//     and worked them in chunks of 32, so every 256 rows ended in a
//     part-filled chunk, two barriers each, (3) it gathered a chunk's rows
//     with scalar loads after a barrier, nothing in flight under the FMAs,
//     (4) a thread held 4 x 4 outputs or fewer, and conv_input's 64 outputs a
//     tile were 16 groups of 16 threads with a row each, (5) its grid was 4
//     blocks an SM, whatever the kernel's residency;
//   * (1, 2) two small kernels read the transposed (K, V_out) rulebook
//     coalesced: the first counts each offset's hits in each CHUNK rows, the
//     second writes the offsets' hit lists end to end (offset-major, rows
//     ascending: ballots and one prefix a chunk) as (feature row, dout row)
//     pairs.  The list is cut into B equal shares, B one wave of resident
//     blocks a Cout tile (at most one a hit): rows that miss cost no block,
//     and a subm rulebook's centre offset, which hits every valid row, no
//     longer makes its blocks four times longer than the rest.  A block
//     copies its share to shared memory an offset at a time, at most
//     LIST_CAP hits a copy;
//   * (3) stages of H >= STAGE listed hits: their feature rows (Cin floats)
//     and dout rows (TN floats) are copied with cp.async, 16 B a lane, into
//     the other half of a double buffer while this stage's FMAs run, one
//     barrier a stage; rows past the list are zero-filled, so that the FMA
//     loop runs without a test a hit (an exact zero leaves an fmaf chain as
//     it is);
//   * (4) a thread holds 8 x 8 outputs of the (Cin, TN) tile (4 x 4 below
//     WIDE outputs), read per hit as float4s of both staged rows, split in
//     halves half a row apart so that a quarter warp's loads are 128
//     contiguous bytes; below THREADS x 64 outputs a tile, G groups of
//     threads take every G-th listed hit.  conv_input (4 x 16) is 64 groups
//     of 4 threads, each with 4 x 4 outputs a hit;
//   * (5) TN is 128 at Cout 128 (conv_out reads its rows once), and the
//     grid is one wave of the kernel's resident blocks
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) a Cout tile;
//   * the order rule: block b's tile of offset k is G fmaf chains from 0.0f,
//     group g's over the block's hits g, g + G, g + 2G, ... of offset k in
//     row order, added in group order (0.0f + group 0 + group 1 ...) into
//     partial slot b + k; sum_blocks_kernel adds the slots of the blocks
//     that hold offset k's hits in a fixed order (lane l of a warp the l-th,
//     (l + 32)-th, ... in block order, then the lanes pairwise).  No float
//     atomics, no TF32: the same bits on every run.
//
// Measurement builds (chip_smoke.py --ablate-wgrad): GW_ABLATE_GATHER stages
// zeros instead of gathering rows (both routes), GW_ABLATE_MMA leaves out the
// tensor-core route's mmas, GW_ABLATE_FMA the f32 route's FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST_CAP = 2048;       // hits a list holds (tensor cores: rows a slice at most)
constexpr int SCAN = 8;              // rulebook entries a thread reads a round
constexpr int MAX_K = 32;            // offsets a rulebook row may hold

// ---------------------------------------------------------------- CUDA cores

constexpr int THREADS = 256;         // f32 route: threads a block
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS * SCAN;     // rows a round of a block's scan
constexpr int WIDE = 2048;           // outputs a tile from which a thread holds 8 x 8
constexpr int STAGE = 32;            // fewest listed hits a stage holds

template <int CIN, int TN>
struct FmaTile {
  static constexpr int OUT = CIN * TN;                   // outputs a block
  static constexpr int M = OUT >= WIDE ? 8 : 4;          // a thread's M x M outputs
  static constexpr int Q = M / 4;                        // float4s of each row a hit
  static constexpr int PC = TN / M;                      // threads along the Cout tile
  static constexpr int P = (CIN / M) * PC;               // threads a group
  static constexpr int G = THREADS / P;                  // groups
  static constexpr int H = 2 * G > STAGE ? 2 * G : STAGE;   // listed hits a stage
  static constexpr int LIST_BYTES = LIST_CAP * 8;
  static constexpr int STAGE_BYTES = 2 * H * (CIN + TN) * 4;   // double buffer
  static constexpr int RED_BYTES = G > 1 ? G * OUT * 4 : 0;
  static constexpr int SMEM = LIST_BYTES + STAGE_BYTES > RED_BYTES
                                  ? LIST_BYTES + STAGE_BYTES : RED_BYTES;
  static_assert(P * G == THREADS && CIN % M == 0 && TN % M == 0 && H % G == 0 &&
                    LIST_CAP % G == 0, "tile does not fit the block");
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

#ifdef GW_ABLATE_GATHER
constexpr int GATHER_BYTES = 0;      // zero-fill: no row is read
#else
constexpr int GATHER_BYTES = 16;
#endif

// The offsets' hit lists laid end to end (offset-major, rows ascending) are
// cut into min(B, nnz) equal shares: block b of a Cout tile owns hits
// [first_hit(b), first_hit(b + 1)), at least one
__device__ __forceinline__ int used_blocks(int blocks, int nnz) {
  return blocks < nnz ? blocks : nnz;
}
__device__ __forceinline__ int first_hit(int b, int blocks, int nnz) {
  return (int)((long long)b * nnz / blocks);
}

// exclusive and total sums of one int a lane (of the first 32 offsets)
__device__ __forceinline__ int warp_exclusive(int x, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(FULL, incl, 31);
  return incl - x;
}

// counts[k * chunks + c]: the hits of offset k among rows [c, c + 1) * CHUNK;
// totals[k] (zeroed first) adds them up (integer adds: the same on every run)
__global__ void __launch_bounds__(THREADS)
count_hits_kernel(const int* __restrict__ rbt, int* __restrict__ counts,
                  int* __restrict__ totals, int v_out, int chunks) {
  __shared__ int warp_s[WARPS];
  const int c = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int* column = rbt + (size_t)k * v_out;
  int n = 0;
#pragma unroll
  for (int j = 0; j < SCAN; ++j) {
    const int v = c * CHUNK + j * THREADS + tid;
    n += v < v_out && __ldg(column + v) >= 0;
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
  if ((tid & 31) == 0) warp_s[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += warp_s[w];
    counts[(size_t)k * chunks + c] = sum;
    atomicAdd(totals + k, sum);
  }
}

// The hit lists laid end to end: list[i] = (feature row, dout row) of hit i.
// Block (c, k) writes offset k's hits among rows [c, c + 1) * CHUNK in row
// order (row c * CHUNK + j * THREADS + tid is entry j of thread tid, so (j,
// warp, lane) is row order: ballots and one prefix)
__global__ void __launch_bounds__(THREADS)
list_hits_kernel(const int* __restrict__ rbt, const int* __restrict__ counts,
                 const int* __restrict__ totals, int2* __restrict__ list, int v_out,
                 int chunks) {
  __shared__ int cnt_s[SCAN][WARPS];
  __shared__ int base_s;
  const int c = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {                     // the hits ahead of this chunk's
    int x = lane < k ? totals[lane] : 0;
    for (int c0 = lane; c0 < c; c0 += 32) x += counts[(size_t)k * chunks + c0];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    if (lane == 0) base_s = x;
  }
  const int* column = rbt + (size_t)k * v_out;
  int e[SCAN];
  unsigned bits[SCAN];
#pragma unroll
  for (int j = 0; j < SCAN; ++j) {
    const int v = c * CHUNK + j * THREADS + tid;
    e[j] = v < v_out ? __ldg(column + v) : -1;
    bits[j] = __ballot_sync(FULL, e[j] >= 0);
    if (lane == 0) cnt_s[j][warp] = __popc(bits[j]);
  }
  __syncthreads();
  int run = base_s;
#pragma unroll
  for (int j = 0; j < SCAN; ++j) {
    int at = run;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = cnt_s[j][w];
      at += w < warp ? n : 0;
      run += n;
    }
    if (e[j] >= 0)
      list[at + __popc(bits[j] & ((1u << lane) - 1u))] =
          make_int2(e[j], c * CHUNK + j * THREADS + tid);
  }
}

template <int CIN, int TN>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_fma_kernel(const float* __restrict__ feat, const float* __restrict__ dout,
                 const int2* __restrict__ list, const int* __restrict__ totals,
                 float* __restrict__ partial, int num_k, int cout) {
  using L = FmaTile<CIN, TN>;
  constexpr int M = L::M, Q = L::Q, G = L::G, H = L::H;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* list_s = reinterpret_cast<int2*>(smem);            // a list: (feature row, dout row)
  float* f_s = reinterpret_cast<float*>(smem + L::LIST_BYTES);   // [2][H][CIN]
  float* d_s = f_s + 2 * H * CIN;                          // [2][H][TN]
  __shared__ int start_s[MAX_K + 1];   // offset k's hits are [start_s[k], start_s[k + 1])

  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (warp == 0) {                     // num_k <= MAX_K = 32: one lane an offset
    int nnz;
    const int lane = tid & 31;
    start_s[lane] = warp_exclusive(lane < num_k ? totals[lane] : 0, &nnz);
    if (lane == 0) start_s[MAX_K] = nnz;
  }
  __syncthreads();
  const int nnz = start_s[MAX_K], blocks = used_blocks(gridDim.x, nnz), b = blockIdx.x;
  if (b >= blocks) return;
  const int lo = first_hit(b, blocks, nnz), hi = first_hit(b + 1, blocks, nnz);

  // thread p of group grp holds rows cr + {0..3} + q * CIN / Q and columns
  // cc + {0..3} + q * TN / Q of the tile, q < Q
  const int grp = tid / L::P, p = tid % L::P;
  const int cr = 4 * (p / L::PC), cc = 4 * (p % L::PC);
  float acc[M][M];

  // listed hits h0 .. h0 + H - 1 of m into buffer buf, zeros past m
  auto stage = [&](int h0, int m, int buf) {
    float* fb = f_s + buf * H * CIN;
    float* db = d_s + buf * H * TN;
#pragma unroll
    for (int j = 0; j < (H * CIN / 4 + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS, h = h0 + i / (CIN / 4);
      if (i < H * CIN / 4)
        cp_async16(fb + 4 * i,
                   h < m ? feat + (size_t)list_s[h].x * CIN + 4 * (i % (CIN / 4)) : feat,
                   h < m ? GATHER_BYTES : 0);
    }
#pragma unroll
    for (int j = 0; j < (H * TN / 4 + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS, h = h0 + i / (TN / 4);
      if (i < H * TN / 4)
        cp_async16(db + 4 * i,
                   h < m ? dout + (size_t)list_s[h].y * cout + n0 + 4 * (i % (TN / 4)) : dout,
                   h < m ? GATHER_BYTES : 0);
    }
    cp_async_commit();
  };

  for (int k = 0; k < num_k; ++k) {
    const int a = max(lo, start_s[k]), e = min(hi, start_s[k + 1]);
    if (a >= e) continue;              // this block holds none of offset k's hits
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) acc[i][j] = 0.f;
    // lists of at most LIST_CAP of the hits a .. e - 1 (a multiple of G each
    // but the last, so that group g's hits are a + g, a + g + G, ...)
    for (int q = a; q < e; q += LIST_CAP) {
      const int m = min(LIST_CAP, e - q);
      __syncthreads();                 // the last list, stages and tile are done with
      for (int i = tid; i < m; i += THREADS) list_s[i] = __ldg(list + q + i);
      __syncthreads();

      // stages of H listed hits, the next stage's rows copied while this
      // one's FMAs run; group grp takes listed hits grp + G s
      stage(0, m, 0);
      for (int h0 = 0, buf = 0; h0 < m; h0 += H, buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();               // this stage has landed; the other buffer is free
        if (h0 + H < m) stage(h0 + H, m, buf ^ 1);
#ifndef GW_ABLATE_FMA
        const float* fb = f_s + buf * H * CIN + grp * CIN + cr;
        const float* db = d_s + buf * H * TN + grp * TN + cc;
#pragma unroll
        for (int s = 0; s < H / G; ++s) {       // rows past the list are zeros
          float f[M], d[M];
#pragma unroll
          for (int q4 = 0; q4 < Q; ++q4) {
            const float4 x = *reinterpret_cast<const float4*>(fb + G * s * CIN + q4 * (CIN / Q));
            const float4 y = *reinterpret_cast<const float4*>(db + G * s * TN + q4 * (TN / Q));
            f[4 * q4] = x.x; f[4 * q4 + 1] = x.y; f[4 * q4 + 2] = x.z; f[4 * q4 + 3] = x.w;
            d[4 * q4] = y.x; d[4 * q4 + 1] = y.y; d[4 * q4 + 2] = y.z; d[4 * q4 + 3] = y.w;
          }
#pragma unroll
          for (int i = 0; i < M; ++i)
#pragma unroll
            for (int j = 0; j < M; ++j) acc[i][j] = fmaf(f[i], d[j], acc[i][j]);
        }
#endif
      }
    }

    // the tile (the groups added in group order) to partial slot b + k
    float* out = partial + (size_t)(b + k) * CIN * cout + n0;
    auto row = [&](int i) { return cr + (i & 3) + (i >> 2) * (CIN / Q); };
    if constexpr (G == 1) {
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int q4 = 0; q4 < Q; ++q4)
          *reinterpret_cast<float4*>(out + (size_t)row(i) * cout + cc + q4 * (TN / Q)) =
              make_float4(acc[i][4 * q4], acc[i][4 * q4 + 1], acc[i][4 * q4 + 2],
                          acc[i][4 * q4 + 3]);
    } else {
      float* red = reinterpret_cast<float*>(smem);         // [G][CIN][TN]
      __syncthreads();                                     // the list and stages are done
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int q4 = 0; q4 < Q; ++q4)
          *reinterpret_cast<float4*>(red + ((size_t)grp * CIN + row(i)) * TN + cc +
                                     q4 * (TN / Q)) =
              make_float4(acc[i][4 * q4], acc[i][4 * q4 + 1], acc[i][4 * q4 + 2],
                          acc[i][4 * q4 + 3]);
      __syncthreads();
      for (int o = tid; o < L::OUT; o += THREADS) {
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) sum += red[g * L::OUT + o];
        out[(size_t)(o / TN) * cout + o % TN] = sum;
      }
    }
  }
}

// dw[k] from the partial slots b + k of the blocks b that hold hits of
// offset k (0 where it has none).  Each element of dw is summed by a warp:
// lane l adds the slots of the l-th, (l + 32)-th, ... of those blocks in
// block order from 0.0f, then the lanes' sums are added pairwise, lane l
// with l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1.  A warp does so for 8 consecutive
// elements of one offset at once (tile = cin * cout is a multiple of 8),
// two float4s of each slot a lane, several slots in flight
__global__ void sum_blocks_kernel(const float* __restrict__ partial,
                                  const int* __restrict__ totals, float* __restrict__ dw,
                                  int num_k, int tile, int grid_blocks) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * 8, lane = threadIdx.x & 31;
  if (i0 >= num_k * tile) return;      // the same for the whole warp
  const int k = i0 / tile;
  const int t = lane < num_k ? totals[lane] : 0;
  int nnz;
  const int start = __shfl_sync(FULL, warp_exclusive(t, &nnz), k);
  const int end = start + __shfl_sync(FULL, t, k);
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if (end > start) {                   // the blocks that hold hits start and end - 1
    const int blocks = used_blocks(grid_blocks, nnz);
    const int first = (int)(((long long)(start + 1) * blocks - 1) / nnz);
    const int last = (int)(((long long)end * blocks - 1) / nnz);
#pragma unroll 4
    for (int b = first + lane; b <= last; b += 32) {
      const float4* slot =
          reinterpret_cast<const float4*>(partial + (size_t)(b + k) * tile + i0 % tile);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = __ldg(slot + h);
        acc[h].x += v.x;
        acc[h].y += v.y;
        acc[h].z += v.z;
        acc[h].w += v.w;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[h].x += __shfl_xor_sync(FULL, acc[h].x, off);
      acc[h].y += __shfl_xor_sync(FULL, acc[h].y, off);
      acc[h].z += __shfl_xor_sync(FULL, acc[h].z, off);
      acc[h].w += __shfl_xor_sync(FULL, acc[h].w, off);
    }
  if (lane < 2) *reinterpret_cast<float4*>(dw + i0 + 4 * lane) = lane == 0 ? acc[0] : acc[1];
}

// ---------------------------------------------------------------- tensor cores

constexpr int MMA_THREADS = 128;     // also the rows a slice is a multiple of
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int TARGET_BLOCKS = 4 * 132;   // blocks a grid aims at
constexpr int GROUP = 64;            // listed hits staged at a time (4 depth steps)
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

// The f32 route's Cout tile: 128 at Cout 128 (conv_out), else at most 64
int fma_tn(int cout) { return cout % 128 == 0 ? 128 : cout < 64 ? cout : 64; }

// fn(CIN, TN) with both as compile-time constants, for every tile the f32
// route has
template <class Fn>
cudaError_t with_fma_tile(int cin, int tn, Fn&& fn) {
  auto by_tn = [&](auto c) -> cudaError_t {
    switch (tn) {
      case 16: return fn(c, std::integral_constant<int, 16>{});
      case 32: return fn(c, std::integral_constant<int, 32>{});
      case 64: return fn(c, std::integral_constant<int, 64>{});
      case 128: return fn(c, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (cin) {
    case 4: return by_tn(std::integral_constant<int, 4>{});
    case 8: return by_tn(std::integral_constant<int, 8>{});
    case 16: return by_tn(std::integral_constant<int, 16>{});
    case 32: return by_tn(std::integral_constant<int, 32>{});
    case 64: return by_tn(std::integral_constant<int, 64>{});
    case 128: return by_tn(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// One wave of wgrad_fma_kernel<CIN, TN>: its resident blocks per SM (after
// opting in to its dynamic shared memory) times the card's SMs; found once
template <int CIN, int TN>
cudaError_t fma_wave(int* blocks_per_sm, int* wave) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    constexpr int smem = FmaTile<CIN, TN>::SMEM;
    int dev = 0, n = 0;
    cudaError_t e = cudaFuncSetAttribute(wgrad_fma_kernel<CIN, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wgrad_fma_kernel<CIN, TN>,
                                                        THREADS, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm = n;
  }
  *blocks_per_sm = per_sm;
  *wave = per_sm * sms;
  return cudaSuccess;
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

// How a call is cut, and the scratch it needs
struct Cut {
  int slices = 0;       // tensor cores: row slices; CUDA cores: blocks a Cout tile
  int rps = 0;          // tensor cores: rows a slice
  int chunks = 0;       // CUDA cores: CHUNK-row rounds of the rulebook
  int per_sm = 0;       // CUDA cores: resident blocks per SM
  int partial = 0;      // floats of partial tiles
  int ints = 0;         // CUDA cores: ints of the hit list and counts
};

// The tensor-core route cuts the rows into slices of at most LIST_CAP rows,
// aiming at TARGET_BLOCKS blocks.  The CUDA-core route gives each Cout tile
// one wave of its resident blocks, each an equal share of all the hits
cudaError_t cut_call(int v_out, int num_k, int cin, int cout, int is_bf16, Cut* c) {
  if (is_bf16) {
    const int tiles = num_k * (cout >= 64 ? cout / 64 : 1);
    const int chunks = (v_out + MMA_THREADS - 1) / MMA_THREADS;
    int slices = (TARGET_BLOCKS + tiles - 1) / tiles;
    slices = slices < chunks ? slices : chunks;
    slices = slices > 1 ? slices : 1;
    int rps = ((chunks + slices - 1) / slices) * MMA_THREADS;
    if (rps > LIST_CAP) rps = LIST_CAP;
    c->slices = v_out > 0 ? (v_out + rps - 1) / rps : 1;
    c->rps = rps;
    c->partial = c->slices * num_k * cin * cout;
    return cudaSuccess;
  }
  const int tn = fma_tn(cout);
  int wave = 0;
  const cudaError_t e = with_fma_tile(cin, tn, [&](auto ci, auto ni) {
    return fma_wave<decltype(ci)::value, decltype(ni)::value>(&c->per_sm, &wave);
  });
  if (e != cudaSuccess) return e;
  const int tiles = cout / tn;
  c->slices = wave / tiles > 1 ? wave / tiles : 1;
  c->chunks = (v_out + CHUNK - 1) / CHUNK;
  c->partial = (c->slices + num_k - 1) * cin * cout;
  c->ints = 2 * num_k * v_out + num_k * c->chunks + num_k;   // list, counts, totals
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch a call needs, for the wrapper to allocate: writes {slices (f32:
// blocks a Cout tile), floats of partial tiles, ints of hit counts (0 for
// bf16), resident blocks per SM of the f32 kernel (0 for bf16)}; returns a
// CUDA error code (0 on success).
int gather_gemm_wgrad_slices(int v_out, int num_k, int cin, int cout, int is_bf16, int* out) {
  Cut c;
  const cudaError_t e = cut_call(v_out, num_k, cin, cout, is_bf16, &c);
  out[0] = c.slices;
  out[1] = c.partial;
  out[2] = c.ints;
  out[3] = c.per_sm;
  return static_cast<int>(e);
}

// feat (V_in, cin) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); rbt (num_k,
// v_out) int32, the rulebook transposed (-1 = none); dout (v_out, cout) f32;
// feat, rbt and dout 16-byte aligned; dw (num_k, cin, cout) f32; partial
// and ints: scratch of the sizes gather_gemm_wgrad_slices gives (ints may be
// null for bf16).  cin in {4, 8, 16, 32, 64, 128}; cout in {16, 32} or a
// multiple of 64; num_k <= 32.
int gather_gemm_wgrad_launch(const void* feat, const int* rbt, const float* dout,
                             float* partial, int* ints, float* dw, int v_out, int num_k,
                             int cin, int cout, int is_bf16, void* stream) {
  if (num_k < 1 || num_k > MAX_K || rbt == nullptr) return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout % 64 != 0) return cudaErrorInvalidValue;
  Cut c;
  cudaError_t e = cut_call(v_out, num_k, cin, cout, is_bf16, &c);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_k * cin * cout;
  if (is_bf16) {
    e = launch_mma(static_cast<const __nv_bfloat16*>(feat), rbt, dout, partial, v_out, num_k,
                   cin, cout, cout >= 64 ? 64 : cout, c.slices, c.rps, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    sum_slices_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, c.slices);
    return static_cast<int>(cudaGetLastError());
  }
  if (ints == nullptr) return cudaErrorInvalidValue;
  int2* list = reinterpret_cast<int2*>(ints);
  int* counts = ints + 2 * (size_t)num_k * v_out;
  int* totals = counts + num_k * c.chunks;
  e = cudaMemsetAsync(totals, 0, num_k * sizeof(int), s);
  if (e == cudaSuccess && c.chunks > 0) {
    const dim3 rounds(c.chunks, num_k);
    count_hits_kernel<<<rounds, THREADS, 0, s>>>(rbt, counts, totals, v_out, c.chunks);
    list_hits_kernel<<<rounds, THREADS, 0, s>>>(rbt, counts, totals, list, v_out, c.chunks);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess)
    e = with_fma_tile(cin, fma_tn(cout), [&](auto ci, auto ni) {
      constexpr int CIN = decltype(ci)::value, TN = decltype(ni)::value;
      wgrad_fma_kernel<CIN, TN><<<dim3(c.slices, cout / TN), THREADS, FmaTile<CIN, TN>::SMEM,
                                  s>>>(static_cast<const float*>(feat), dout, list, totals,
                                       partial, num_k, cout);
      return cudaGetLastError();
    });
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_blocks_kernel<<<(4 * n + 255) / 256, 256, 0, s>>>(partial, totals, dw, num_k,
                                                        cin * cout, c.slices);
  return static_cast<int>(cudaGetLastError());
}

const char* gather_gemm_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
