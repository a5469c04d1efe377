// Robot constants and small vector helpers shared by kernels A and B.
//
// The robot model travels as one read-only device buffer holding a
// WtwModel, written once per (model, engine params, device) by
// wtw_tpu_torch/physics/kernels.py, whose ctypes mirror of this struct must
// match it field for field (wtw_model_bytes() is checked at load).
// Dimensions are runtime values under the compile-time maxima below; the
// Python wrapper raises for a robot that exceeds them.
//
// The same sources also build as plain C++ (no __CUDACC__): the device
// bodies then become inline host functions driven by a loop over envs,
// which lets the CPU tests check the kernels' arithmetic where no nvcc
// exists.
#pragma once
#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WTW_FN __device__ __forceinline__
#else
#define WTW_FN static inline
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

#define WTW_MAX_BODIES 16
#define WTW_MAX_JOINTS 15
#define WTW_MAX_DOFS 21
#define WTW_MAX_SPHERES 64
#define WTW_N_GROUPS 13  // foot x4, thigh x4, calf x4, base
#define WTW_BLOCK 128

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
};

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
