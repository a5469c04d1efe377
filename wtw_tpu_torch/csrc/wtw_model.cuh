// Robot constants, the team-of-lanes scaffolding and small vector helpers
// shared by kernels A and B.
//
// The robot model travels as one read-only device buffer holding a
// WtwModel, written once per (model, engine params, device) by
// wtw_tpu_torch/physics/kernels.py, whose ctypes mirror of this struct must
// match it field for field (wtw_model_bytes() is checked at load).
// Dimensions are runtime values under the compile-time maxima below; the
// Python wrapper raises for a robot that exceeds them.
//
// Both kernels give each env a team of lanes inside one warp and put
// several teams in a block (each kernel's source sets both). A kernel body is a sequence of phases
// (team_phase): inside a phase each lane works on its own share of the
// env's data in shared memory, and a phase ends with a sync of the team.
// State that crosses a phase lives in the shared-memory struct, never in a
// lane's locals. A block first stages its envs' input rows into shared
// memory (threads over (row, env), env fastest: coalesced) and at the end
// writes the output rows the same way.
//
// A mixed-robot batch passes the models of R robots back to back and a
// slot table: slot s of the launch holds env slot_env[s] (-1: no env),
// whose robot is slot_robot[s]. The host sorts the envs by robot and pads
// each robot's run to a multiple of both kernels' envs per block, so every
// block holds envs of one robot and stages that robot's model only. The
// staging reads and the stores then go through slot_env (MAPPED below).
//
// The same sources also build as plain C++ (no __CUDACC__): team_phase
// then runs the phase for every lane of the team in turn, in forward or in
// reverse lane order (wtw_set_lane_order). A phase that reads what another
// lane writes in the same phase gives different results in the two orders,
// so the CPU tests catch a missing sync where no nvcc exists.
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WTW_FN __device__ __forceinline__
#define WTW_UNROLL _Pragma("unroll")
#else
#define WTW_UNROLL
#define WTW_FN static inline
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif


#define WTW_MAX_BODIES 16
#define WTW_MAX_JOINTS 15
#define WTW_MAX_DOFS 21
#define WTW_MAX_SPHERES 64
#define WTW_N_GROUPS 13  // foot x4, thigh x4, calf x4, base
#define WTW_MAX_FKB (WTW_MAX_BODIES * 7 + WTW_MAX_JOINTS * 6)

struct WtwModel {
  int nb, nj, nv, P;
  int lo;                                       // first free dof (6: fixed base)
  int parent[WTW_MAX_BODIES];
  int n_anc[WTW_MAX_BODIES];                    // ancestor-or-self dofs per body
  int anc_dofs[WTW_MAX_BODIES][WTW_MAX_DOFS];   // ascending
  int sph_body[WTW_MAX_SPHERES];
  int sph_group[WTW_MAX_SPHERES];               // contact group or -1
  int feet_body[4];
  float joint_pos[WTW_MAX_JOINTS][3];
  float joint_quat[WTW_MAX_JOINTS][4];
  float joint_axis[WTW_MAX_JOINTS][3];
  float joint_damping[WTW_MAX_JOINTS];
  float mass[WTW_MAX_BODIES];
  float com[WTW_MAX_BODIES][3];
  float inertia[WTW_MAX_BODIES][9];
  float sph_pos[WTW_MAX_SPHERES][3];
  float sph_radius[WTW_MAX_SPHERES];
  float feet_pos[4][3];
  float dt;
  float gravity[3];
  float k_contact, c_contact, vel_eps, v_maxdep, armature;
  // the tree by levels (depth from the base): bodies of level l are
  // lvl_body[lvl_off[l] .. lvl_off[l + 1]), and the children of body b,
  // which sit together in the next level, are lvl_body[child_off[b] ..
  // child_off[b] + n_child[b])
  int n_lvl;
  int lvl_off[WTW_MAX_BODIES + 1];
  int lvl_body[WTW_MAX_BODIES];
  int child_off[WTW_MAX_BODIES];
  int n_child[WTW_MAX_BODIES];
  int anc_mask[WTW_MAX_BODIES];   // bit i: dof i is an ancestor-or-self dof
};

#ifdef __CUDACC__
// run phase f for this thread's lane, then sync the team: LANES lanes
// (a power of two up to 32) that sit together in one warp
template <int LANES, class F>
WTW_FN void team_phase(int lane, F&& f) {
  f(lane);
  __syncwarp(LANES == 32 ? 0xffffffffu
                         : ((1u << LANES) - 1u) << (threadIdx.x & 31 & ~(LANES - 1)));
}
#else
// the team emulated on the host: every lane in turn, in the order set by
// wtw_set_lane_order (0 forward, 1 reverse)
inline int wtw_lane_reverse = 0;
template <int LANES, class F>
static inline void team_phase(int, F&& f) {
  for (int k = 0; k < LANES; ++k) f(wtw_lane_reverse ? LANES - 1 - k : k);
}
#endif

// floats of padding that make a per-env struct of n floats a stride of
// 32 / ENVS banks mod 32 (1 for ENVS > 32), so the staging threads of one
// warp (rows x ENVS envs) hit 32 different banks
template <int ENVS>
constexpr int wtw_pad(int n) {
  return ((ENVS >= 32 ? 1 : 32 / ENVS) - n % 32 + 32) % 32 == 0
             ? 32 : ((ENVS >= 32 ? 1 : 32 / ENVS) - n % 32 + 32) % 32;
}

// Set bits of a team's shared int: an integer OR, exact in any order, so
// the result does not depend on the lanes' order.
WTW_FN void team_or(int* p, int bits) {
#ifdef __CUDACC__
  atomicOr(p, bits);
#else
  *p |= bits;
#endif
}

// Index of the lowest set bit of a nonzero mask.
WTW_FN int lowest_bit(unsigned m) {
#ifdef __CUDACC__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// One float from global to shared memory without passing through a
// register (cp.async): a thread's copies all stay in flight until
// stage_wait, instead of one load latency each.
WTW_FN void copy_async4(float* dst, const float* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  memcpy(dst, src, 4);  // bytes: the model's ints travel as words too
#endif
}

// Wait for this thread's copies; a __syncthreads() must follow before
// other threads read them.
WTW_FN void stage_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The robot model into shared memory (words of 4 bytes), next to the
// block's input rows, so that the phases read it without a trip to L2.
WTW_FN void stage_model(const WtwModel* __restrict__ g, WtwModel* sm, int tid,
                        int nthr) {
  const float* src = (const float*)g;
  float* dst = (float*)sm;
  for (int x = tid; x < (int)(sizeof(WtwModel) / 4); x += nthr)
    copy_async4(&dst[x], &src[x]);
}

// The env (column) of slot s: s itself, or slot_env[s] in a mixed batch
// (-1 for an empty slot).
template <bool MAPPED>
WTW_FN int slot_col(const int* __restrict__ slot_env, int s) {
  if constexpr (MAPPED) return slot_env[s];
  return s;
}

// False for an empty slot of a mixed batch (the padding at the end of a
// robot's run): its team skips the body. Its inputs are staged as 0, which
// would put every sphere of the env in the ground, its rows are not
// stored, and a team syncs only its own lanes, so no other team waits on
// it. A single-robot launch runs every team.
template <bool MAPPED>
WTW_FN bool slot_live(const int* __restrict__ slot_env, int s) {
  if constexpr (MAPPED) return slot_env[s] >= 0;
  return true;
}

// Rows [0, nrows) of a (nrows, B) array, slots e0 .. e0 + ENVS, into float
// `off` onward of each env's struct (stride floats apart); slots past B (or
// empty) read 0. Threads tid, tid + nthr, ... go over (row, env), env
// fastest.
template <int ENVS, bool MAPPED = false>
WTW_FN void stage_rows(const float* __restrict__ g, int nrows, int B, int e0,
                       float* sm, int stride, int off, int tid, int nthr,
                       const int* __restrict__ slot_env = nullptr) {
  for (int x = tid; x < nrows * ENVS; x += nthr) {
    const int r = x / ENVS, t = x % ENVS;
    const int e = slot_col<MAPPED>(slot_env, e0 + t);
    float* dst = &sm[t * stride + off + r];
    if ((!MAPPED || e >= 0) && e < B)
      copy_async4(dst, &g[(size_t)r * B + e]);
    else
      *dst = 0.0f;
  }
}

// The reverse: rows out of shared memory, stores masked at the ragged edge
// and at empty slots.
template <int ENVS, bool MAPPED = false>
WTW_FN void store_rows(float* __restrict__ g, int nrows, int B, int e0,
                       const float* sm, int stride, int off, int tid,
                       int nthr, const int* __restrict__ slot_env = nullptr) {
  for (int x = tid; x < nrows * ENVS; x += nthr) {
    const int r = x / ENVS, t = x % ENVS;
    const int e = slot_col<MAPPED>(slot_env, e0 + t);
    if ((!MAPPED || e >= 0) && e < B)
      g[(size_t)r * B + e] = sm[t * stride + off + r];
  }
}


WTW_FN void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

WTW_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Hamilton product a (x) b, xyzw
WTW_FN void qmul(const float* a, const float* b, float* o) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

// rotate v by unit quaternion q: v + w t + xyz x t, t = 2 xyz x v
WTW_FN void qrot(const float* q, const float* v, float* o) {
  float t[3], c[3];
  cross3(q, v, t);
  t[0] *= 2.0f; t[1] *= 2.0f; t[2] *= 2.0f;
  cross3(q, t, c);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + q[3] * t[k] + c[k];
}

// row-major 3x3 rotation matrix of a unit quaternion
WTW_FN void quat_to_R(const float* q, float* R) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}

WTW_FN void mat_vec3(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}
