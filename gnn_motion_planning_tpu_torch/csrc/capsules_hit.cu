// Batched capsule-vs-AABB contact decisions on Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_motion_planning_tpu/ops/pallas_capsule.py::
// capsules_hit (body _capsules_hit_kernel, distance _seg_box_contact_rows):
// out[b] != 0 iff some capsule c of configuration b (segment p0 -> p1,
// radius r[c]) comes closer than r[c] to some active box o, by the exact
// segment-box squared distance: candidates t = 0, 1 and the +-h crossing
// of each axis, the minimiser bracketed by the sign of f', and the vertex
// of the active-set quadratic inside the bracket.
//
// Bound. 680 fp32 operations per (state, capsule, active box), counting
// each add, multiply, divide, compare, select, min, max and abs as one
// (ops/capsule.py::OPS_PER_PAIR), against 2 x 12 bytes of endpoints per
// (state, capsule): at B = 4096, C = 24, O = 16 that is 1.07 GFLOP against
// 2.4 MB, so the card's fp32 rate bounds it (16 us at 67 TFLOP/s), not its
// memory (under 1 us).
//
// Design. One thread per (state, capsule): the endpoints are read once,
// coalesced, into registers; the O <= 1024 boxes (centre, half-extent,
// mask) sit in shared memory and every thread walks them, skipping the
// inactive ones, so all the arithmetic runs from registers. The per-state
// "any" is an atomicOr into the int32 output (zeroed by the caller), done
// only by threads that found a contact. The ragged end of B * C is masked.
//
// Built with -fmad=false: every multiply and add rounds on its own, as in
// the plain PyTorch version (ops/capsule.py::capsules_hit_reference), so
// the contact decisions at the boundary d2 == r^2 are the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define CAP_EPS 1e-12f

__device__ __forceinline__ float sgn(float w) {
  return (float)(w > 0.f) - (float)(w < 0.f);
}

__device__ __forceinline__ float f_at(const float u[3], const float v[3],
                                      const float h[3], float t) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float d = fmaxf(fabsf(u[i] + t * v[i]) - h[i], 0.f);
    acc = acc + d * d;
  }
  return acc;
}

__device__ __forceinline__ float g_at(const float u[3], const float v[3],
                                      const float h[3], float t) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float w = u[i] + t * v[i];
    float e = fmaxf(fabsf(w) - h[i], 0.f);
    acc = acc + 2.f * sgn(w) * e * v[i];
  }
  return acc;
}

__device__ __forceinline__ bool seg_box_contact(const float u[3], const float v[3],
                                                const float h[3], float r2) {
  float cands[8];
  cands[0] = 0.f;
  cands[1] = 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bool ok = fabsf(v[i]) > CAP_EPS;
    float safe = ok ? v[i] : 1.f;
    float ta = ok ? (h[i] - u[i]) / safe : 0.f;
    float tb = ok ? (-h[i] - u[i]) / safe : 0.f;
    cands[2 + 2 * i] = fminf(fmaxf(ta, 0.f), 1.f);
    cands[3 + 2 * i] = fminf(fmaxf(tb, 0.f), 1.f);
  }

  float t_lo = 0.f, t_hi = 1.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float gt = g_at(u, v, h, cands[k]);
    t_lo = fmaxf(t_lo, gt < 0.f ? cands[k] : 0.f);
    t_hi = fminf(t_hi, gt > 0.f ? cands[k] : 1.f);
  }
  t_hi = fmaxf(t_hi, t_lo);

  float mid = 0.5f * (t_lo + t_hi);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float wm = u[i] + mid * v[i];
    bool active = fabsf(wm) > h[i];
    float s = sgn(wm);
    float alpha = active ? s * v[i] : 0.f;
    float beta = active ? s * u[i] - h[i] : 0.f;
    num = num + alpha * beta;
    den = den + alpha * alpha;
  }
  float t_star = fminf(fmaxf(-num / fmaxf(den, CAP_EPS), t_lo), t_hi);

  float d2 = f_at(u, v, h, cands[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d2 = fminf(d2, f_at(u, v, h, cands[k]));
  d2 = fminf(d2, f_at(u, v, h, t_lo));
  d2 = fminf(d2, f_at(u, v, h, t_hi));
  d2 = fminf(d2, f_at(u, v, h, t_star));
  return d2 < r2;
}

__global__ void capsules_hit_kernel(const float* __restrict__ p0,
                                    const float* __restrict__ p1,
                                    const float* __restrict__ r,
                                    const float* __restrict__ centers,
                                    const float* __restrict__ halfs,
                                    const uint8_t* __restrict__ mask, int B,
                                    int C, int O, int32_t* __restrict__ out) {
  extern __shared__ float boxes[];  // O rows of [cx cy cz hx hy hz active]
  for (int k = threadIdx.x; k < O; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      boxes[7 * k + i] = centers[3 * k + i];
      boxes[7 * k + 3 + i] = halfs[3 * k + i];
    }
    boxes[7 * k + 6] = mask[k] ? 1.f : 0.f;
  }
  __syncthreads();

  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * C) return;
  int b = (int)(idx / C);
  int c = (int)(idx - (int64_t)b * C);

  float a[3], v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = p0[3 * idx + i];
    v[i] = p1[3 * idx + i] - a[i];
  }
  float rc = r[c];
  float r2 = rc * rc;

  bool hit = false;
  for (int o = 0; o < O; ++o) {
    const float* bx = boxes + 7 * o;
    if (bx[6] == 0.f) continue;
    float u[3] = {a[0] - bx[0], a[1] - bx[1], a[2] - bx[2]};
    float h[3] = {bx[3], bx[4], bx[5]};
    hit |= seg_box_contact(u, v, h, r2);
  }
  if (hit) atomicOr(out + b, 1);
}

extern "C" int capsules_hit_launch(const float* p0, const float* p1,
                                   const float* r, const float* centers,
                                   const float* halfs, const uint8_t* mask,
                                   int B, int C, int O, int32_t* out,
                                   void* stream) {
  const int threads = 256;
  int64_t work = (int64_t)B * C;
  int blocks = (int)((work + threads - 1) / threads);
  size_t smem = sizeof(float) * 7 * (size_t)O;
  capsules_hit_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      p0, p1, r, centers, halfs, mask, B, C, O, out);
  return (int)cudaGetLastError();
}
