// Capsule-vs-AABB contact decisions on Hopper (sm_90a): one narrow phase,
// two entry points.
//
// Replaces the TPU kernel gnn_motion_planning_tpu/ops/pallas_capsule.py:120
// capsules_hit (body _capsules_hit_kernel, distance _seg_box_contact_rows),
// together with the vmap(capsules_world) that XLA fused around it in one
// program (gnn_motion_planning_tpu/envs/kuka.py:143).
//
//   capsules_hit_launch       hit[b] from (B, C, 3) capsule endpoints: the
//                             Pallas kernel's direct counterpart.
//   chain_states_free_launch  free[b] and n_checks[b] from (B, dof) joint
//                             configurations: joint limits, forward
//                             kinematics (FK) and the narrow phase in one
//                             launch (envs/kuka.py::batch_state_free).
//
// A capsule c (segment p0 -> p1, radius r[c]) touches an active box when
// the exact segment-box squared distance is below r^2: candidates t = 0, 1
// and the +-h crossing of each axis, the minimiser bracketed by the sign of
// f', and the vertex of the active-set quadratic inside the bracket.
//
// Bound. 680 fp32 operations per (state, capsule, active box) in the narrow
// phase, 144 per joint and 39 per capsule in FK (ops/capsule.py counts
// them), against 4 bytes a joint angle in and 5 bytes a state out: kuka7 at
// problem 2000 needs some 49,000 operations per state for 33 bytes, so the
// card's fp32 throughput bounds the kernel, never its memory. What it
// reaches is set by instruction issue: with -fmad=false each counted
// operation is an instruction of its own (the peak counts an FMA as two),
// and lanes whose round has no pair left idle. At the main path's small
// batches (31 states an edge check, 1 a goal test) the launch itself takes
// longer than the work.
//
// Design.
// - A group of G lanes serves one configuration (G = 16 or 32, chosen by
//   the caller from the batch: ops/capsule.py::lanes_for). Its lanes walk
//   the (capsule, active box) pairs in rounds of G, capsule-major; after
//   each round a warp vote forms each group's "any" and a group stops at
//   its first round with a contact. A whole warp (G = 32) leaves up to 31 lanes idle in the last
//   round (kuka7 at problem 2000: 72 pairs, 3 rounds, a quarter idle);
//   narrower groups waste less there, at the cost of longer rounds. Lane 0
//   of the group writes the result itself: no atomics, no zeroed output,
//   one launch per call.
// - Each block compacts the active boxes of the mask into shared memory
//   once, so the pair loop walks only those and has no branch on the mask.
// - chain_states_free: the chain's constants sit in shared memory; one lane
//   per joint builds every joint's rotation first (cos, sin, Rodrigues:
//   they depend on the angle only), then the group's lanes build the 12
//   numbers of each link frame in turn into the configuration's slice of
//   shared memory, and place the capsule endpoints there. Endpoints never
//   go through device memory, and a collision call is one launch instead
//   of some 550 small PyTorch ops of FK.
// - Block shape: up to 8 warps (256 threads), fewer when the batch is
//   small, so that it still spreads over the 132 SMs. `nvcc -Xptxas -v`
//   (printed by chip_smoke.py phase 0) gives about 64 registers a thread
//   and no spills for each kernel at each width, so four blocks of
//   256 fit an SM and B = 4096 runs in one wave, with 8 warps sharing each
//   block's copy of the chain and the boxes. Above 48 KB of shared memory (hundreds of
//   boxes) a launch opts in, up to the 227 KB of a block.
//
// - Lanes: a launch takes L problems ("lanes", the port of jax.vmap over
//   the Pallas kernel), each with its own scene and B configurations. The
//   grid is (blocks a lane, L); blockIdx.y is the lane, so a block never
//   spans two lanes and loads only its lane's boxes. A single problem is
//   L = 1.
//
// Built with -fmad=false: no multiply and add is contracted by the
// compiler, as in the plain PyTorch versions
// (ops/capsule.py::capsules_hit_reference, envs/kinematics.py::
// capsules_world). The narrow phase and FK call fmaf (one rounding)
// exactly where XLA's CPU code contracts the JAX package's seg_box_sq_dist
// (u + t v, the sums of f, f' and the vertex denominator;
// envs/geometry.py says how they were read) and its FK (Rodrigues and the
// frame products; envs/kinematics.py's docstring), and the plain version
// forms the same fused multiply-adds (envs/kinematics.py::fma32). FK's
// cos and sin are glibc's algorithm in double (sincosf_glibc), as the
// plain version's (envs/kinematics.py::sincosf32). So the kernel sees the
// same endpoints as the plain version and XLA, and decides the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define CAP_EPS 1e-12f
#define FULL_MASK 0xffffffffu
#define MAX_WARPS 8
#define N_SM 132

__device__ __forceinline__ float sgn(float w) {
  return (float)(w > 0.f) - (float)(w < 0.f);
}

__device__ __forceinline__ float f_at(const float u[3], const float v[3],
                                      const float h[3], float t) {
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = fmaxf(fabsf(fmaf(t, v[i], u[i])) - h[i], 0.f);
  return fmaf(d[2], d[2], fmaf(d[0], d[0], d[1] * d[1]));
}

__device__ __forceinline__ float g_at(const float u[3], const float v[3],
                                      const float h[3], float t) {
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float w = fmaf(t, v[i], u[i]);
    x[i] = 2.f * sgn(w) * fmaxf(fabsf(w) - h[i], 0.f);
  }
  return fmaf(x[2], v[2], fmaf(x[1], v[1], x[0] * v[0]));
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
  float alpha[3], beta[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float wm = fmaf(mid, v[i], u[i]);
    bool active = fabsf(wm) > h[i];
    float s = sgn(wm);
    alpha[i] = active ? s * v[i] : 0.f;
    beta[i] = active ? s * u[i] - h[i] : 0.f;
  }
  const float num = (alpha[0] * beta[0] + alpha[1] * beta[1]) + alpha[2] * beta[2];
  const float den = fmaf(alpha[2], alpha[2], fmaf(alpha[1], alpha[1], alpha[0] * alpha[0]));
  float t_star = fminf(fmaxf(-num / fmaxf(den, CAP_EPS), t_lo), t_hi);

  float d2 = f_at(u, v, h, cands[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d2 = fminf(d2, f_at(u, v, h, cands[k]));
  d2 = fminf(d2, f_at(u, v, h, t_lo));
  d2 = fminf(d2, f_at(u, v, h, t_hi));
  d2 = fminf(d2, f_at(u, v, h, t_star));
  return d2 < r2;
}

// Warp 0 copies the active boxes, in index order, into shared memory as
// rows [cx cy cz hx hy hz] and their number into *n_active. The caller
// synchronises the block before reading them.
__device__ void load_active_boxes(const float* __restrict__ centers,
                                  const float* __restrict__ halfs,
                                  const uint8_t* __restrict__ mask, int O,
                                  float* boxes, int* n_active) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int base = 0;
  for (int k0 = 0; k0 < O; k0 += 32) {
    const int k = k0 + lane;
    const bool on = k < O && mask[k];
    const unsigned ballot = __ballot_sync(FULL_MASK, on);
    if (on) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        boxes[6 * slot + i] = centers[3 * k + i];
        boxes[6 * slot + 3 + i] = halfs[3 * k + i];
      }
    }
    base += __popc(ballot);
  }
  if (lane == 0) *n_active = base;
}

// Does any capsule of one configuration touch any of the A active boxes?
// A group of G lanes (G = 16 or 32, aligned in the warp) serves one
// configuration: p0, p1 (C, 3) and r (C,), in device or shared memory. The
// group takes the C x A pairs in rounds of G, capsule-major, and stops after
// the first round with a contact. `live` is false for a group with nothing
// to check. All 32 lanes of the warp must call it (its votes span the
// warp); it returns the same value on every lane of a group.
template <int G>
__device__ bool group_any_contact(const float* p0, const float* p1, const float* r,
                                  const float* boxes, int A, int C, int lane, bool live) {
  const unsigned group = G == 32 ? FULL_MASK : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int n = C * A;
  bool found = false;
  for (int base = 0; base < n; base += G) {
    const int k = base + (lane & (G - 1));
    bool hit = false;
    if (live && k < n) {
      const int c = k / A;
      const float* bx = boxes + 6 * (k - c * A);
      float u[3], v[3], h[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a = p0[3 * c + i];
        u[i] = a - bx[i];
        v[i] = p1[3 * c + i] - a;
        h[i] = bx[3 + i];
      }
      const float rc = r[c];
      hit = seg_box_contact(u, v, h, rc * rc);
    }
    // every lane votes, also in groups that are done: a lane that skipped
    // the vote would leave the warp's other groups waiting
    const unsigned hits = __ballot_sync(FULL_MASK, hit);
    found = found || (hits & group) != 0;
    live = live && !found;
    if (!__any_sync(FULL_MASK, live)) break;  // every group of the warp is done
  }
  return found;
}

template <int G>
__global__ void __launch_bounds__(32 * MAX_WARPS)
capsules_hit_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                    const float* __restrict__ r, const float* __restrict__ centers,
                    const float* __restrict__ halfs, const uint8_t* __restrict__ mask,
                    int B, int C, int O, uint8_t* __restrict__ out) {
  extern __shared__ float boxes[];  // up to O rows of [cx cy cz hx hy hz]
  __shared__ int n_active;
  // blockIdx.y is the lane: its scene and its B configurations
  const int64_t lane_id = blockIdx.y;
  centers += 3 * O * lane_id;
  halfs += 3 * O * lane_id;
  mask += O * lane_id;
  p0 += 3 * (int64_t)C * B * lane_id;
  p1 += 3 * (int64_t)C * B * lane_id;
  out += B * lane_id;
  load_active_boxes(centers, halfs, mask, O, boxes, &n_active);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x;
  if ((first + (threadIdx.x & ~31)) / G >= B) return;  // whole warps leave together
  const int64_t b = (first + threadIdx.x) / G;
  const bool in = b < B;
  const int64_t row = 3 * (int64_t)C * (in ? b : B - 1);
  const bool hit = group_any_contact<G>(p0 + row, p1 + row, r, boxes, n_active, C, lane, in);
  if (in && (lane & (G - 1)) == 0) out[b] = hit;
}

// glibc's cosf and sinf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c), which
// XLA's CPU code calls for the JAX package's FK, in double as there: the
// same reduction and table as envs/kinematics.py::sincosf32. Every joint
// limit lies within 9, far inside the |x| < 120 that this reduction
// covers; a configuration beyond it is out of its limits and never free.
#define TRIG_HPI_INV 0x1.45f306dc9c883p+23
#define TRIG_HPI 0x1.921fb54442d18p+0
#define TRIG_C0 0x1p+0
#define TRIG_C1 -0x1.ffffffd0c621cp-2
#define TRIG_C2 0x1.55553e1068f19p-5
#define TRIG_C3 -0x1.6c087e89a359dp-10
#define TRIG_C4 0x1.99343027bf8c3p-16
#define TRIG_S1 -0x1.555545995a603p-3
#define TRIG_S2 0x1.1107605230bc4p-7
#define TRIG_S3 -0x1.994eb3774cf24p-13

__device__ __forceinline__ void sincosf_glibc(float y, float* c_out, float* s_out) {
  if (fabsf(y) < 0x1p-12f) {  // cosf returns 1 and sinf its argument
    *c_out = 1.f;
    *s_out = y;
    return;
  }
  if (isinf(y)) {  // glibc: NaN
    *c_out = *s_out = __int_as_float(0x7fc00000);
    return;
  }
  const double x = (double)y;
  const long long n = ((long long)(x * TRIG_HPI_INV) + 0x800000) >> 24;
  const double r = x - (double)n * TRIG_HPI;
  // sign[n & 3] = 1, -1, -1, 1; for n & 2 the table negates c0..c4
  const double xs = ((n + 1) & 2) ? -r : r;
  const double x2 = r * r, x3 = xs * x2, x4 = x2 * x2;
  const double odd = (xs + x3 * TRIG_S1) + (x3 * x2) * (TRIG_S2 + x2 * TRIG_S3);
  double even = ((TRIG_C0 + x2 * TRIG_C1) + x4 * TRIG_C2) + (x4 * x2) * (TRIG_C3 + x2 * TRIG_C4);
  if (n & 2) even = -even;
  *c_out = (float)((n & 1) ? odd : even);
  *s_out = (float)((n & 1) ? even : odd);
}

// The Rodrigues rotation about the unit axis (x, y, z) by angle, row-major
// into rq[0..8], with the fused multiply-adds of XLA's compiled
// _axis_angle (envs/kinematics.py::_rotations).
__device__ __forceinline__ void rodrigues(const float* ax, float angle, float* rq) {
  const float x = ax[0], y = ax[1], z = ax[2];
  float c, s;
  sincosf_glibc(angle, &c, &s);
  const float C = 1.f - c;
  rq[0] = fmaf(x * x, C, c);
  rq[4] = fmaf(y * y, C, c);
  rq[8] = fmaf(z * z, C, c);
  rq[1] = fmaf(x * y, C, -(z * s));
  rq[5] = fmaf(y * z, C, -(x * s));
  rq[6] = fmaf(x * z, C, -(y * s));
  rq[2] = fmaf(y, s, (x * z) * C);
  rq[3] = fmaf(z, s, (x * y) * C);
  rq[7] = fmaf(x, s, (y * z) * C);
}

// a[0] b[0] + a[1] b[s] + a[2] b[2 s] as XLA's dot emitter contracts it:
// fma(a2, b2, fma(a1, b1, a0 b0)) (envs/kinematics.py::dot3_fused)
__device__ __forceinline__ float dot3_fused(const float* a, const float* b, int stride) {
  return fmaf(a[2], b[2 * stride], fmaf(a[1], b[stride], a[0] * b[0]));
}

// floats of one configuration's shared-memory slice: J + 1 link frames of
// [R (row-major 3x3), t], the J joint rotations (row-major 3x3), then the
// endpoints p0 and p1 of C capsules
__host__ __device__ __forceinline__ int slice_floats(int J, int C) {
  return 12 * (J + 1) + 9 * J + 6 * C;
}

template <int G>
__global__ void __launch_bounds__(32 * MAX_WARPS)
chain_states_free_kernel(const float* __restrict__ qs, int B, int dof,
                         const float* __restrict__ chain_f,
                         const int32_t* __restrict__ chain_i, int J, int C,
                         const float* __restrict__ centers,
                         const float* __restrict__ halfs,
                         const uint8_t* __restrict__ mask, int O,
                         uint8_t* __restrict__ free_out,
                         int32_t* __restrict__ checks_out,
                         float* __restrict__ p0_out, float* __restrict__ p1_out) {
  // shared memory: boxes (6 O) | chain floats (nf) | one slice a
  // configuration | chain ints (ni)
  extern __shared__ float smem[];
  __shared__ int n_active;
  // blockIdx.y is the lane: its scene and its B configurations
  const int64_t lane_id = blockIdx.y;
  qs += (int64_t)dof * B * lane_id;
  centers += 3 * O * lane_id;
  halfs += 3 * O * lane_id;
  mask += O * lane_id;
  free_out += B * lane_id;
  checks_out += B * lane_id;
  if (p0_out != nullptr) {
    p0_out += 3 * (int64_t)C * B * lane_id;
    p1_out += 3 * (int64_t)C * B * lane_id;
  }
  const int nf = 15 * J + 7 * C + 2 * dof;
  const int ni = 2 * J + C;
  float* boxes = smem;
  float* cf = boxes + 6 * O;
  float* slices = cf + nf;
  int* ci = (int*)(slices + (blockDim.x / G) * slice_floats(J, C));
  for (int k = threadIdx.x; k < nf; k += blockDim.x) cf[k] = chain_f[k];
  for (int k = threadIdx.x; k < ni; k += blockDim.x) ci[k] = chain_i[k];
  load_active_boxes(centers, halfs, mask, O, boxes, &n_active);
  __syncthreads();

  // the layout of ops/capsule.py::PackedChain
  const float* origin_rot = cf;          // (J, 3, 3)
  const float* origin_trans = cf + 9 * J;  // (J, 3)
  const float* axis = cf + 12 * J;       // (J, 3)
  const float* cap_p0 = cf + 15 * J;     // (C, 3)
  const float* cap_p1 = cap_p0 + 3 * C;  // (C, 3)
  const float* cap_r = cap_p1 + 3 * C;   // (C,)
  const float* lower = cap_r + C;        // (dof,)
  const float* upper = lower + dof;      // (dof,)
  const int* q_index = ci;               // (J,)
  const int* parent_frame = ci + J;      // (J,)
  const int* cap_link = ci + 2 * J;      // (C,)

  // G lanes a configuration; every lane stays to the end of the warp's
  // votes and __syncwarp()s, so lanes past B work on row B - 1 unseen
  const int lane = threadIdx.x & 31, g = lane & (G - 1);
  const unsigned group = G == 32 ? FULL_MASK : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int64_t first = (int64_t)blockIdx.x * (blockDim.x / G);
  if (first + (threadIdx.x & ~31) / G >= B) return;  // whole warps leave together
  const int slot = threadIdx.x / G;
  const int64_t b = first + slot;
  const bool in = b < B;
  const float* q = qs + (int64_t)dof * (in ? b : B - 1);
  float* frames = slices + slot * slice_floats(J, C);
  float* rots = frames + 12 * (J + 1);
  float* p0 = rots + 9 * J;
  float* p1 = p0 + 3 * C;

  // joint limits; NaN fails both comparisons
  bool ok = true;
  for (int d = g; d < dof; d += G) {
    const float x = q[d];
    ok = ok && (x >= lower[d]) && (x <= upper[d]);
  }
  const bool valid = (__ballot_sync(FULL_MASK, !ok) & group) == 0;
  const bool want_endpoints = p0_out != nullptr;
  const bool any_work = __any_sync(FULL_MASK, in && valid);
  if (!want_endpoints && !any_work) {
    // nothing in this warp needs FK or the narrow phase
    if (in && g == 0) {
      free_out[b] = 0;
      checks_out[b] = 0;
    }
    return;
  }

  // joint rotations, one lane per joint: they depend on the angle only, so
  // the serial chain below keeps just the products
  for (int j = g; j < J; j += G) {
    const int qi = q_index[j];
    rodrigues(axis + 3 * j, qi >= 0 ? q[qi] : 0.f, rots + 9 * j);
  }
  // link frames (envs/kinematics.py::fk_link_frames): frame 0 is the root,
  // the identity; topo joint j writes the 12 numbers of frame j + 1 from its
  // parent's frame
  for (int e = g; e < 12; e += G) frames[e] = (e == 0 || e == 4 || e == 8) ? 1.f : 0.f;
  __syncwarp();
  for (int j = 0; j < J; ++j) {
    const float* R = frames + 12 * parent_frame[j];
    const float* t = R + 9;
    for (int e = g; e < 12; e += G) {
      float val;
      if (e < 9) {
        // R_new[i][k] = ((R @ origin_rot[j]) @ Rq[j])[i][k]
        const int i = e / 3, k = e - 3 * (e / 3);
        const float* Or = origin_rot + 9 * j;
        const float* Rq = rots + 9 * j;
        // (R @ origin_rot): columns 0 and 1 in-order sums, column 2 fused
        float m[3];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          m[n] = (R[3 * i] * Or[n] + R[3 * i + 1] * Or[3 + n]) + R[3 * i + 2] * Or[6 + n];
        m[2] = dot3_fused(R + 3 * i, Or + 2, 3);
        val = dot3_fused(m, Rq + k, 3);
      } else {
        // t_new[i] = (R @ origin_trans[j])[i] + t[i]
        const int i = e - 9;
        val = dot3_fused(R + 3 * i, origin_trans + 3 * j, 1) + t[i];
      }
      frames[12 * (j + 1) + e] = val;
    }
    __syncwarp();
  }

  // capsule endpoints (envs/kinematics.py::capsules_world): R @ cap_p + t
  for (int c = g; c < C; c += G) {
    const float* R = frames + 12 * cap_link[c];
    const float* t = R + 9;
    const float* a = cap_p0 + 3 * c;
    const float* e = cap_p1 + 3 * c;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p0[3 * c + i] = dot3_fused(R + 3 * i, a, 1) + t[i];
      p1[3 * c + i] = dot3_fused(R + 3 * i, e, 1) + t[i];
    }
    if (want_endpoints && in) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p0_out[(3 * C) * b + 3 * c + i] = p0[3 * c + i];
        p1_out[(3 * C) * b + 3 * c + i] = p1[3 * c + i];
      }
    }
  }
  __syncwarp();

  const bool hit =
      group_any_contact<G>(p0, p1, cap_r, boxes, n_active, C, lane, in && valid);
  if (in && g == 0) {
    free_out[b] = valid && !hit;
    checks_out[b] = valid ? 1 : 0;
  }
}

// warps a block: 8, or fewer so that a small batch still spans the SMs
static int warps_per_block(int64_t warps_needed) {
  const int64_t w = warps_needed / N_SM;
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : (int)w);
}

// Launch kernel<G> over B configurations with `smem` bytes of shared memory
// for `warps` warps a block, opting in above the 48 KB a launch gets
// without it. Returns the CUDA error, 0 on success.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 blocks, int warps, size_t smem, void* stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The grid of a launch over L lanes of B configurations, G lanes a
// configuration: (blocks a lane, L), so that a block never spans two lanes,
// and the warps a block, sized from the warps of all lanes together.
struct Grid {
  dim3 blocks;
  int warps;
};

static Grid lane_grid(int L, int B, int G) {
  const int64_t warps_lane = ((int64_t)B * G + 31) / 32;
  const int warps = warps_per_block(warps_lane * L);
  return {dim3((unsigned)((warps_lane + warps - 1) / warps), (unsigned)L), warps};
}

template <int G>
static int capsules_hit_g(const float* p0, const float* p1, const float* r,
                          const float* centers, const float* halfs, const uint8_t* mask,
                          int L, int B, int C, int O, uint8_t* out, void* stream) {
  const Grid grid = lane_grid(L, B, G);
  const size_t smem = sizeof(float) * 6 * (size_t)O;
  return launch(capsules_hit_kernel<G>, grid.blocks, grid.warps, smem, stream, p0, p1, r,
                centers, halfs, mask, B, C, O, out);
}

template <int G>
static int chain_states_free_g(const float* qs, int L, int B, int dof, const float* chain_f,
                               const int32_t* chain_i, int J, int C, const float* centers,
                               const float* halfs, const uint8_t* mask, int O,
                               uint8_t* free_out, int32_t* checks_out, float* p0_out,
                               float* p1_out, void* stream) {
  const Grid grid = lane_grid(L, B, G);
  const size_t smem =
      sizeof(float) * (6 * (size_t)O + 15 * J + 7 * C + 2 * dof +
                       (size_t)(32 * grid.warps / G) * slice_floats(J, C)) +
      sizeof(int32_t) * (2 * J + C);
  return launch(chain_states_free_kernel<G>, grid.blocks, grid.warps, smem, stream, qs, B,
                dof, chain_f, chain_i, J, C, centers, halfs, mask, O, free_out, checks_out,
                p0_out, p1_out);
}

// the grid's y extent bounds the lanes of one launch
#define MAX_LANES 65535

extern "C" int capsules_hit_launch(const float* p0, const float* p1, const float* r,
                                   const float* centers, const float* halfs,
                                   const uint8_t* mask, int L, int B, int C, int O,
                                   uint8_t* out, int lanes, void* stream) {
  if (L > MAX_LANES) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 16:
      return capsules_hit_g<16>(p0, p1, r, centers, halfs, mask, L, B, C, O, out, stream);
    case 32:
      return capsules_hit_g<32>(p0, p1, r, centers, halfs, mask, L, B, C, O, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int chain_states_free_launch(const float* qs, int L, int B, int dof,
                                        const float* chain_f, const int32_t* chain_i,
                                        int J, int C, const float* centers,
                                        const float* halfs, const uint8_t* mask, int O,
                                        uint8_t* free_out, int32_t* checks_out,
                                        float* p0_out, float* p1_out, int lanes,
                                        void* stream) {
  if (L > MAX_LANES) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 16:
      return chain_states_free_g<16>(qs, L, B, dof, chain_f, chain_i, J, C, centers, halfs, mask,
                                     O, free_out, checks_out, p0_out, p1_out, stream);
    case 32:
      return chain_states_free_g<32>(qs, L, B, dof, chain_f, chain_i, J, C, centers, halfs, mask,
                                     O, free_out, checks_out, p0_out, p1_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
