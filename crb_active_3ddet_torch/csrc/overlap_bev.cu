// Rotated BEV overlap for Hopper (sm_90a), two entry points over raw
// (x, y, z, dx, dy, dz, heading) boxes:
//   overlap_bev_launch  out[b, i, j] = area(box_A(b, i) ∩ box_B(b, j)), f32;
//   nms_mask_launch     the NMS's suppression words: bit (j mod 32) of
//                       words[b, i, j / 32] is set iff j < i, both boxes are
//                       alive and ov / max((area_i + area_j) − ov, 1e-8) >
//                       thresh, with ov = overlap(i, j) and area = dx·dy.
//
// Replaces the Pallas kernel crb_active_3ddet_tpu/ops/pallas_overlap.py:122
// (boxes_overlap_bev_pallas: _overlap_kernel -> _overlap_tile ->
// _clip_halfplane_slots), and for the mask also what the JAX package does
// with its result (ops/nms.py:214-220: IoU, threshold, lower triangle,
// alive masks; :147-150: packing into 32-bit words).  The clip is the same:
// A's 4 CCW corners are clipped against B's 4 edges (Sutherland-Hodgman) in
// an 8-slot polygon, with the same candidate order [v_i, x_i], the same
// |denom| < 1e-8 guard and the same one-hot compaction into slots, then the
// shoelace area.  Degenerate (zero) A boxes give 0; a degenerate B gives
// area(A) (its zero-length edges keep every vertex), as in the reference.
//
// Bit-equality with the plain PyTorch version: the corners are computed here
// with the arithmetic of cuda_overlap.corners_xy (dx/2, cosf, sinf,
// (lx·c − ly·s) + x), and every product, sum and quotient of the corners, the
// clip and the IoU is written as a round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, ...), which the compiler never fuses into a multiply-add.  The
// file is built with nvcc's default flags otherwise, so cosf and sinf are
// compiled as PyTorch's own cos and sin kernels compile them.
//
// What bounds it on the H100: arithmetic.  A clip is ~440 f32 operations,
// 32 divisions and ~800 selects on 16 floats, against 4 bytes of output (1
// bit for the mask).  The first form of this kernel clipped every pair of the
// (B, K, K) matrix, one thread a pair, and the NMS then read the 32 MB float
// matrix back in ~15 torch ops.  What the design does about it:
// - The mask entry computes only what the NMS reads.  A block takes 32 rows
//   (one bit of a word each) and 256 columns (8 words), and only blocks
//   with columns left of the diagonal run, so every block has the same
//   short path.  A cheap pass tests each pair for j < i, both alive and
//   axis-aligned bounds within MARGIN of each other, and appends the pairs
//   that need the clip to a list in shared memory (one ballot, __popc and
//   one shared atomicAdd a warp); a dense pass then gives each lane one
//   listed pair, so a warp's clips are all real work; bits are ORed into
//   shared words (order-free) and stored coalesced, zeros included.
// - Corners, areas, bounds and flags of a block's boxes are computed once
//   into shared memory, so no corner op runs outside the kernel.
// - The float entry (the recall record's (8, 40) x (8, 500), and callers of
//   boxes_iou_bev) clips every pair, one thread a pair (8 rows × 32
//   columns a block), from corners the block computed once; it takes no
//   early-out, since at its shapes the call's host time, not the clips,
//   sets what a caller waits.
// What is left: at an eval step's NMS about 1 % of the pairs reach the clip,
// so the mask's time is one block's chain (prologue, cheap pass, one round
// of clips) and not the arithmetic of the clips; with every box at one point
// (the worst case) every pair is clipped.
//
// The early-out may only skip a pair whose clip gives exactly 0.0.  Two
// convex quads whose corner bounds are MARGIN apart have an empty
// intersection, and the last clip stage then sees every vertex at least
// ~MARGIN·|edge| outside its half-plane, far above the f32 rounding of
// coordinates under ~250 m, so no vertex survives and the area is 0.  That
// argument needs B's four edges to be real: a box whose side is below
// MIN_SIDE (the zero-padded rows, which return area(A)), outside the size or
// position limits, or not finite never takes part in a skipped pair.

#include <cuda_runtime.h>

namespace {

constexpr int CAP = 8;
constexpr float EPS = 1e-8f;
constexpr float MARGIN = 1e-2f;     // m between corner bounds for a skip
constexpr float MIN_SIDE = 1e-2f;   // m; thinner boxes never skip
constexpr float MAX_SIDE = 50.f;    // m
constexpr float MAX_POS = 200.f;    // m, |x| and |y| of the centre
constexpr int TILE = 32;            // rows of a block = bits of a word
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS;      // columns of one cheap pass: 8 words
constexpr int FROWS = THREADS / 32; // rows of a float-entry block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The boxes of one side of a tile, in shared memory, one column per box.
template <int N>
struct BoxTile {
  float cx[4][N], cy[4][N];      // CCW corners
  float x0[N], x1[N], y0[N], y1[N];  // bounds of the corners
  float area[N];                 // dx · dy
  unsigned char flags[N];        // ALIVE | FAR_OK
};

// FAR_OK: may take part in a skipped pair.
constexpr unsigned char ALIVE = 1, FAR_OK = 2;

template <int N>
__device__ __forceinline__ void load_box(BoxTile<N>& t, int s, const float* p,
                                         bool alive) {
  const float x = p[0], y = p[1], dx = p[3], dy = p[4], h = p[6];
  const float dx2 = mul(dx, 0.5f), dy2 = mul(dy, 0.5f);
  const float c = cosf(h), sn = sinf(h);
  const float lx[4] = {dx2, -dx2, -dx2, dx2};
  const float ly[4] = {dy2, dy2, -dy2, -dy2};
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float cx = add(sub(mul(lx[e], c), mul(ly[e], sn)), x);
    const float cy = add(add(mul(lx[e], sn), mul(ly[e], c)), y);
    t.cx[e][s] = cx;
    t.cy[e][s] = cy;
    x0 = e ? fminf(x0, cx) : cx;
    x1 = e ? fmaxf(x1, cx) : cx;
    y0 = e ? fminf(y0, cy) : cy;
    y1 = e ? fmaxf(y1, cy) : cy;
  }
  t.x0[s] = x0; t.x1[s] = x1; t.y0[s] = y0; t.y1[s] = y1;
  t.area[s] = mul(dx, dy);
  // NaN fails every comparison, so a non-finite box is never skipped
  const bool far_ok = isfinite(h) && fabsf(x) <= MAX_POS && fabsf(y) <= MAX_POS
                      && dx >= MIN_SIDE && dx <= MAX_SIDE
                      && dy >= MIN_SIDE && dy <= MAX_SIDE;
  t.flags[s] = (alive ? ALIVE : 0) | (far_ok ? FAR_OK : 0);
}

// Bounds of box a (tile A, slot s) and box b (tile B, slot u) more than
// MARGIN apart, and both boxes fit for the skip.
template <int N, int M>
__device__ __forceinline__ bool apart(const BoxTile<N>& A, int s,
                                      const BoxTile<M>& B, int u) {
  return (A.flags[s] & B.flags[u] & FAR_OK)
         && (sub(A.x0[s], B.x1[u]) > MARGIN || sub(B.x0[u], A.x1[s]) > MARGIN
             || sub(A.y0[s], B.y1[u]) > MARGIN || sub(B.y0[u], A.y1[s]) > MARGIN);
}

__device__ __forceinline__ void clip_halfplane(float (&px)[CAP], float (&py)[CAP],
                                               int& n, float e1x, float e1y,
                                               float e2x, float e2y) {
  const float ex = sub(e2x, e1x), ey = sub(e2y, e1y);
  float d[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    d[i] = sub(mul(ex, sub(py[i], e1y)), mul(ey, sub(px[i], e1x)));

  float cx[2 * CAP], cy[2 * CAP];
  bool fl[2 * CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int j = (i + 1) % CAP;
    const bool nxt_ok = (i + 1) < n;
    const float dn = nxt_ok ? d[j] : d[0];
    const float vnx = nxt_ok ? px[j] : px[0];
    const float vny = nxt_ok ? py[j] : py[0];
    const bool valid = i < n;
    const bool inside = d[i] >= 0.f;
    const bool inside_n = dn >= 0.f;
    const float denom = sub(d[i], dn);
    const float t = __fdiv_rn(d[i], fabsf(denom) < EPS ? 1.f : denom);
    cx[2 * i] = px[i];
    cy[2 * i] = py[i];
    fl[2 * i] = inside && valid;
    cx[2 * i + 1] = add(px[i], mul(t, sub(vnx, px[i])));
    cy[2 * i + 1] = add(py[i], mul(t, sub(vny, py[i])));
    fl[2 * i + 1] = (inside != inside_n) && valid;
  }

  float nx[CAP], ny[CAP];
#pragma unroll
  for (int s = 0; s < CAP; ++s) { nx[s] = 0.f; ny[s] = 0.f; }
  int cnt = 0;
#pragma unroll
  for (int jc = 0; jc < 2 * CAP; ++jc) {
#pragma unroll
    for (int s = 0; s < (jc + 1 < CAP ? jc + 1 : CAP); ++s) {
      const bool hit = fl[jc] && cnt == s;
      nx[s] = hit ? cx[jc] : nx[s];
      ny[s] = hit ? cy[jc] : ny[s];
    }
    cnt += fl[jc] ? 1 : 0;
  }
#pragma unroll
  for (int s = 0; s < CAP; ++s) { px[s] = nx[s]; py[s] = ny[s]; }
  n = cnt;
}

// Intersection area of box A (tile slot s) clipped by box B (tile slot u).
template <int N, int M>
__device__ __forceinline__ float overlap_area(const BoxTile<N>& A, int s,
                                              const BoxTile<M>& B, int u) {
  float px[CAP], py[CAP], bx[4], by[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    px[e] = A.cx[e][s];
    py[e] = A.cy[e][s];
    bx[e] = B.cx[e][u];
    by[e] = B.cy[e][u];
  }
#pragma unroll
  for (int e = 4; e < CAP; ++e) { px[e] = 0.f; py[e] = 0.f; }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    clip_halfplane(px, py, n, bx[e], by[e], bx[(e + 1) % 4], by[(e + 1) % 4]);

  float acc = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < CAP; ++s2) {
    const int j2 = (s2 + 1) % CAP;
    const bool nxt_ok = (s2 + 1) < n;
    const float vnx = nxt_ok ? px[j2] : px[0];
    const float vny = nxt_ok ? py[j2] : py[0];
    acc = add(acc, s2 < n ? sub(mul(px[s2], vny), mul(vnx, py[s2])) : 0.f);
  }
  return mul(0.5f, fabsf(acc));
}

// Float entry: one pair a thread.  A block computes an 8 × 32 tile of
// out[b] with 256 threads; warp = row, lane = column.
__global__ void __launch_bounds__(THREADS)
overlap_bev_kernel(const float* __restrict__ a, long long a_batch, long long a_row,
                   const float* __restrict__ b, long long b_batch, long long b_row,
                   float* __restrict__ out, int N, int M) {
  __shared__ BoxTile<FROWS> A;
  __shared__ BoxTile<32> B;
  const int bi = blockIdx.z;
  const int row0 = blockIdx.y * FROWS, col0 = blockIdx.x * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < FROWS && row0 + tid < N)
    load_box(A, tid, a + bi * a_batch + (row0 + tid) * a_row, true);
  else if (tid >= 32 && tid < 64 && col0 + lane < M)
    load_box(B, lane, b + bi * b_batch + (col0 + lane) * b_row, true);
  __syncthreads();
  const int i = row0 + warp, j = col0 + lane;
  if (i < N && j < M)
    out[((long long)bi * N + i) * M + j] = overlap_area(A, warp, B, lane);
}

// Mask entry: a block takes rows row0 .. row0 + 31 (row tile blockIdx.y)
// of frame blockIdx.z against the 256 columns of chunk blockIdx.x, if any
// of them lies left of the diagonal (j < min(K, row0 + 32)): load the boxes,
// cheap pass into the list, dense pass, store the chunk's 8 words of each
// row.  The block of a row tile's last chunk also zeroes the words right of
// it, which hold only pairs with j >= i.
__global__ void __launch_bounds__(THREADS)
nms_mask_kernel(const float* __restrict__ boxes, long long batch_stride,
                long long row_stride, const unsigned char* __restrict__ alive,
                int K, int W, float thresh, unsigned* __restrict__ words,
                unsigned long long* __restrict__ n_clipped) {
  __shared__ BoxTile<TILE> R;
  __shared__ BoxTile<CHUNK> C;
  __shared__ unsigned short list[TILE * CHUNK];   // (row << 8) | column
  __shared__ unsigned sw[TILE * (CHUNK / 32)];     // [row][word of chunk]
  __shared__ int count;

  const int row0 = blockIdx.y * TILE, c0 = blockIdx.x * CHUNK;
  const int ncols = min(K, row0 + TILE);         // j < i <= row0 + 31
  if (c0 >= ncols) return;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const float* fb = boxes + bi * batch_stride;
  const unsigned char* al = alive + (long long)bi * K;
  unsigned* wout = words + (long long)bi * K * W;

  if (tid < TILE) {
    if (row0 + tid < K)
      load_box(R, tid, fb + (row0 + tid) * row_stride, al[row0 + tid] != 0);
    else
      R.flags[tid] = 0;
  }
  const int j = c0 + tid;
  if (j < ncols)
    load_box(C, tid, fb + j * row_stride, al[j] != 0);
  else
    C.flags[tid] = 0;
  sw[tid] = 0;
  if (tid == 0) count = 0;
  __syncthreads();

  // cheap pass: warp w owns the chunk's word w, a lane its column
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const bool need = (R.flags[r] & C.flags[tid] & ALIVE) && j < row0 + r
                      && !apart(R, r, C, tid);
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (m) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&count, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (need)
        list[base + __popc(m & ((1u << lane) - 1u))] =
            static_cast<unsigned short>((r << 8) | tid);
    }
  }
  __syncthreads();

  // dense pass: one listed pair a lane
  const int n = count;
  if (n_clipped != nullptr && tid == 0 && n > 0)
    atomicAdd(n_clipped, static_cast<unsigned long long>(n));
#pragma unroll 1
  for (int e = tid; e < n; e += THREADS) {
    const int r = list[e] >> 8, u = list[e] & 255;
    const float ov = overlap_area(R, r, C, u);
    float den = sub(add(R.area[r], C.area[u]), ov);
    den = den < EPS ? EPS : den;         // torch.clamp(min=1e-8): NaN stays NaN
    if (__fdiv_rn(ov, den) > thresh)
      atomicOr(&sw[r * (CHUNK / 32) + (u >> 5)], 1u << (u & 31));
  }
  __syncthreads();

  // store: 8 consecutive words of a row per 8 threads
  const int r = tid >> 3, w = (c0 >> 5) + (tid & 7);
  if (row0 + r < K && w < W) wout[(long long)(row0 + r) * W + w] = sw[tid];
  if (c0 + CHUNK < ncols) return;
  const int done = min(W, (c0 + CHUNK) / 32);
  const int rest = W - done;
#pragma unroll 1
  for (int idx = tid; idx < TILE * rest; idx += THREADS) {
    const int rr = idx / rest;
    if (row0 + rr < K) wout[(long long)(row0 + rr) * W + done + idx % rest] = 0u;
  }
}

}  // namespace

extern "C" {

// a (B, N, 7+), b (B, M, 7+) f32 boxes with the given batch and row strides
// (in floats; the last dimension contiguous); out (B, N, M) f32.
int overlap_bev_launch(const float* a, long long a_batch, long long a_row,
                       const float* b, long long b_batch, long long b_row,
                       float* out, int B, int N, int M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  dim3 grid((M + 31) / 32, (N + FROWS - 1) / FROWS, B);
  overlap_bev_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_batch, a_row, b, b_batch, b_row, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

// boxes (B, K, 7+) f32 with the given batch and row strides (in floats);
// alive (B, K) bytes, 0 or 1; words (B, K, ceil(K / 32)) 32-bit, every word
// written.  n_clipped, if not null, receives += the number of pairs that went
// through the clip.
int nms_mask_launch(const float* boxes, long long batch_stride,
                    long long row_stride, const unsigned char* alive, int B,
                    int K, float thresh, unsigned* words,
                    unsigned long long* n_clipped, void* stream) {
  if (B == 0 || K == 0) return 0;
  dim3 grid((K + CHUNK - 1) / CHUNK, (K + TILE - 1) / TILE, B);
  nms_mask_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, batch_stride, row_stride, alive, K, (K + 31) / 32, thresh, words,
      n_clipped);
  return static_cast<int>(cudaGetLastError());
}

const char* overlap_bev_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
