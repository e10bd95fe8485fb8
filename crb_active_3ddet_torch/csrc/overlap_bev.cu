// Rotated BEV overlap matrix for Hopper (sm_90a):
//     out[b, i, j] = area(poly_A(b, i) ∩ poly_B(b, j))
// for boxes given as CCW corners [cx0..cx3, cy0..cy3] (computed once per box
// by the wrapper).
//
// Replaces the Pallas kernel crb_active_3ddet_tpu/ops/pallas_overlap.py
// (boxes_overlap_bev_pallas: _overlap_kernel -> _overlap_tile ->
// _clip_halfplane_slots).  The clip is the same: A's 4 corners are clipped
// against B's 4 edges (Sutherland-Hodgman) in an 8-slot polygon, with the
// same candidate order [v_i, x_i], the same |denom| < 1e-8 guard and the same
// one-hot compaction into slots, then the shoelace area.  Degenerate (zero)
// A boxes give 0.
//
// What bounds it on the H100: arithmetic.  Each pair does a few hundred f32
// operations on 16 loaded floats and stores one float, so the (B, N, M)
// output write is far below the FP32 time.  The design keeps the whole
// polygon in registers (every slot loop is unrolled, so no local memory),
// runs one thread per (b, i, j) pair with neighbouring threads on
// neighbouring j (coalesced stores), and takes the batch as grid.z so the NMS
// of a whole eval step is one launch.
//
// It is built with -fmad=false: every product and sum is rounded on its own,
// as in the plain PyTorch version, so the two agree bit for bit on the same
// corners.  (The shoelace cancels terms of size |x|^2; at coordinates of tens
// of metres a fused multiply-add moved areas by up to 3e-4.)
//
// Later work: fuse the IoU threshold, the lower-triangle mask and the 32-bit
// packing so the float matrix never reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int CAP = 8;
constexpr float EPS = 1e-8f;

__device__ __forceinline__ void clip_halfplane(float (&px)[CAP], float (&py)[CAP],
                                               int& n, float e1x, float e1y,
                                               float e2x, float e2y) {
  const float ex = e2x - e1x, ey = e2y - e1y;
  float d[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) d[i] = ex * (py[i] - e1y) - ey * (px[i] - e1x);

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
    const float denom = d[i] - dn;
    const float t = d[i] / (fabsf(denom) < EPS ? 1.f : denom);
    cx[2 * i] = px[i];
    cy[2 * i] = py[i];
    fl[2 * i] = inside && valid;
    cx[2 * i + 1] = px[i] + t * (vnx - px[i]);
    cy[2 * i + 1] = py[i] + t * (vny - py[i]);
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

__global__ void overlap_bev_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int N, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int bi = blockIdx.z;
  if (i >= N || j >= M) return;
  const float* ar = a + ((long long)bi * N + i) * 8;
  const float* br = b + ((long long)bi * M + j) * 8;

  float px[CAP], py[CAP], bx[4], by[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    px[e] = __ldg(ar + e);
    py[e] = __ldg(ar + 4 + e);
    bx[e] = __ldg(br + e);
    by[e] = __ldg(br + 4 + e);
  }
#pragma unroll
  for (int s = 4; s < CAP; ++s) { px[s] = 0.f; py[s] = 0.f; }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    clip_halfplane(px, py, n, bx[e], by[e], bx[(e + 1) % 4], by[(e + 1) % 4]);

  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < CAP; ++s) {
    const int j2 = (s + 1) % CAP;
    const bool nxt_ok = (s + 1) < n;
    const float vnx = nxt_ok ? px[j2] : px[0];
    const float vny = nxt_ok ? py[j2] : py[0];
    acc += s < n ? px[s] * vny - vnx * py[s] : 0.f;
  }
  out[((long long)bi * N + i) * M + j] = 0.5f * fabsf(acc);
}

}  // namespace

extern "C" {

// a (B, N, 8), b (B, M, 8) f32 corners [cx0..3, cy0..3]; out (B, N, M) f32.
int overlap_bev_launch(const float* a, const float* b, float* out, int B,
                       int N, int M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  dim3 block(32, 8);
  dim3 grid((M + 31) / 32, (N + 7) / 8, B);
  overlap_bev_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

const char* overlap_bev_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
