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
//   (printed by chip_smoke.py phase 0) gives 63 registers a thread and no
//   spills for each kernel at each width (32 bytes of stack in
//   chain_states_free: the slow path of cosf and sinf), so four blocks of
//   256 fit an SM and B = 4096 runs in one wave, with 8 warps sharing each
//   block's copy of the chain and the boxes. Above 48 KB of shared memory (hundreds of
//   boxes) a launch opts in, up to the 227 KB of a block.
//
// Built with -fmad=false: every multiply and add rounds on its own, as in
// the plain PyTorch versions (ops/capsule.py::capsules_hit_reference,
// envs/kinematics.py::capsules_world), and FK uses the CUDA math library's
// cosf and sinf, which PyTorch's own cos and sin call on the card. So the
// kernel sees the same endpoints and decides the same bits.

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

// The Rodrigues rotation about the unit axis (x, y, z) by angle, row-major
// into rq[0..8], in the operand order of envs/kinematics.py::_axis_angle.
__device__ __forceinline__ void rodrigues(const float* ax, float angle, float* rq) {
  const float x = ax[0], y = ax[1], z = ax[2];
  const float c = cosf(angle), s = sinf(angle);
  const float C = 1.f - c;
  rq[0] = x * x * C + c;
  rq[1] = x * y * C - z * s;
  rq[2] = x * z * C + y * s;
  rq[3] = y * x * C + z * s;
  rq[4] = y * y * C + c;
  rq[5] = y * z * C - x * s;
  rq[6] = z * x * C - y * s;
  rq[7] = z * y * C + x * s;
  rq[8] = z * z * C + c;
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
        // R_new[i][k] = ((R @ origin_rot[j]) @ Rq[j])[i][k], in-order sums
        const int i = e / 3, k = e - 3 * (e / 3);
        const float* Or = origin_rot + 9 * j;
        const float* Rq = rots + 9 * j;
        float m[3];
#pragma unroll
        for (int n = 0; n < 3; ++n)
          m[n] = (R[3 * i] * Or[n] + R[3 * i + 1] * Or[3 + n]) + R[3 * i + 2] * Or[6 + n];
        val = (m[0] * Rq[k] + m[1] * Rq[3 + k]) + m[2] * Rq[6 + k];
      } else {
        // t_new[i] = (R @ origin_trans[j])[i] + t[i]
        const int i = e - 9;
        const float* ot = origin_trans + 3 * j;
        val = ((R[3 * i] * ot[0] + R[3 * i + 1] * ot[1]) + R[3 * i + 2] * ot[2]) + t[i];
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
      p0[3 * c + i] = ((R[3 * i] * a[0] + R[3 * i + 1] * a[1]) + R[3 * i + 2] * a[2]) + t[i];
      p1[3 * c + i] = ((R[3 * i] * e[0] + R[3 * i + 1] * e[1]) + R[3 * i + 2] * e[2]) + t[i];
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
static int launch(Kernel kernel, int blocks, int warps, size_t smem, void* stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int G>
static int capsules_hit_g(const float* p0, const float* p1, const float* r,
                          const float* centers, const float* halfs, const uint8_t* mask,
                          int B, int C, int O, uint8_t* out, void* stream) {
  const int64_t warps_needed = ((int64_t)B * G + 31) / 32;
  const int warps = warps_per_block(warps_needed);
  const int blocks = (int)((warps_needed + warps - 1) / warps);
  const size_t smem = sizeof(float) * 6 * (size_t)O;
  return launch(capsules_hit_kernel<G>, blocks, warps, smem, stream, p0, p1, r, centers,
                halfs, mask, B, C, O, out);
}

template <int G>
static int chain_states_free_g(const float* qs, int B, int dof, const float* chain_f,
                               const int32_t* chain_i, int J, int C, const float* centers,
                               const float* halfs, const uint8_t* mask, int O,
                               uint8_t* free_out, int32_t* checks_out, float* p0_out,
                               float* p1_out, void* stream) {
  const int64_t warps_needed = ((int64_t)B * G + 31) / 32;
  const int warps = warps_per_block(warps_needed);
  const int blocks = (int)((warps_needed + warps - 1) / warps);
  const size_t smem =
      sizeof(float) * (6 * (size_t)O + 15 * J + 7 * C + 2 * dof +
                       (size_t)(32 * warps / G) * slice_floats(J, C)) +
      sizeof(int32_t) * (2 * J + C);
  return launch(chain_states_free_kernel<G>, blocks, warps, smem, stream, qs, B, dof,
                chain_f, chain_i, J, C, centers, halfs, mask, O, free_out, checks_out,
                p0_out, p1_out);
}

extern "C" int capsules_hit_launch(const float* p0, const float* p1, const float* r,
                                   const float* centers, const float* halfs,
                                   const uint8_t* mask, int B, int C, int O,
                                   uint8_t* out, int lanes, void* stream) {
  switch (lanes) {
    case 16: return capsules_hit_g<16>(p0, p1, r, centers, halfs, mask, B, C, O, out, stream);
    case 32: return capsules_hit_g<32>(p0, p1, r, centers, halfs, mask, B, C, O, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int chain_states_free_launch(const float* qs, int B, int dof,
                                        const float* chain_f, const int32_t* chain_i,
                                        int J, int C, const float* centers,
                                        const float* halfs, const uint8_t* mask, int O,
                                        uint8_t* free_out, int32_t* checks_out,
                                        float* p0_out, float* p1_out, int lanes,
                                        void* stream) {
  switch (lanes) {
    case 16:
      return chain_states_free_g<16>(qs, B, dof, chain_f, chain_i, J, C, centers, halfs, mask,
                                     O, free_out, checks_out, p0_out, p1_out, stream);
    case 32:
      return chain_states_free_g<32>(qs, B, dof, chain_f, chain_i, J, C, centers, halfs, mask,
                                     O, free_out, checks_out, p0_out, p1_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
