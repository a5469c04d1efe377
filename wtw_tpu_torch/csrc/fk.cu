// Kernel A: forward kinematics over the static tree plus the world xyz of
// every collision sphere, one thread per env.
//
// Replaces the Pallas kernel `_pallas_fk` (wtw_tpu/physics/batched.py:882,
// pallas_call at :908), which runs `fk_core` + `sphere_pos_core` per
// (8, 128) env tile.
//
// Layout (struct of arrays, env index fastest, so a warp's loads and
// stores of one row are coalesced):
//   in   (7 + nj, B): base_pos 3, base_quat 4 (xyzw), joint_q nj
//   fk_b (nb*7 + nj*6, B): body_pos nb x 3, body_quat nb x 4,
//        joint anchors nj x 3, world joint axes nj x 3
//   fk_p (3, P, B): sphere world x, y, z
//
// Bound on the H100: bytes. Per env it reads 19 floats and writes
// 163 + 3 * 39 = 280 (go1), ~1.2 KB, against ~2.6 k flops: far below the
// card's ~20 flop/byte fp32 ridge. The design writes each output once,
// coalesced; the tree walk lives in registers/local memory.
#include "wtw_model.cuh"

WTW_FN void fk_env(const WtwModel& m, const float* __restrict__ in,
                   float* __restrict__ fk_b, float* __restrict__ fk_p,
                   int B, int e) {
  const int nb = m.nb, nj = m.nj, P = m.P;
  float pos[WTW_MAX_BODIES][3], quat[WTW_MAX_BODIES][4];
  for (int k = 0; k < 3; ++k) pos[0][k] = in[(size_t)k * B + e];
  for (int k = 0; k < 4; ++k) quat[0][k] = in[(size_t)(3 + k) * B + e];
  float* anchors = fk_b + (size_t)(nb * 7) * B;
  float* axes = fk_b + (size_t)(nb * 7 + nj * 3) * B;
  for (int j = 0; j < nj; ++j) {
    const int child = j + 1, p = m.parent[child];
    float r[3], qf[4], qj[4], ax[3];
    qrot(quat[p], m.joint_pos[j], r);
    for (int k = 0; k < 3; ++k) pos[child][k] = pos[p][k] + r[k];
    qmul(quat[p], m.joint_quat[j], qf);
    const float half = 0.5f * in[(size_t)(7 + j) * B + e];
    const float s = sinf(half), c = cosf(half);
    qj[0] = m.joint_axis[j][0] * s;
    qj[1] = m.joint_axis[j][1] * s;
    qj[2] = m.joint_axis[j][2] * s;
    qj[3] = c;
    qmul(qf, qj, quat[child]);
    qrot(qf, m.joint_axis[j], ax);
    for (int k = 0; k < 3; ++k) {
      anchors[(size_t)(j * 3 + k) * B + e] = pos[child][k];
      axes[(size_t)(j * 3 + k) * B + e] = ax[k];
    }
  }
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < 3; ++k) fk_b[(size_t)(b * 3 + k) * B + e] = pos[b][k];
    for (int k = 0; k < 4; ++k)
      fk_b[(size_t)(nb * 3 + b * 4 + k) * B + e] = quat[b][k];
  }
  float R[WTW_MAX_BODIES][9];
  for (int b = 0; b < nb; ++b) quat_to_R(quat[b], R[b]);
  for (int p = 0; p < P; ++p) {
    const int b = m.sph_body[p];
    float o[3];
    mat_vec3(R[b], m.sph_pos[p], o);
    for (int k = 0; k < 3; ++k)
      fk_p[(size_t)(k * P + p) * B + e] = pos[b][k] + o[k];
  }
}

extern "C" int wtw_model_bytes() { return (int)sizeof(WtwModel); }

#ifdef __CUDACC__
__global__ void __launch_bounds__(WTW_BLOCK)
wtw_fk_kernel(const WtwModel* __restrict__ m, const float* __restrict__ in,
              float* __restrict__ fk_b, float* __restrict__ fk_p, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < B) fk_env(*m, in, fk_b, fk_p, B, e);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int wtw_fk_launch(const void* m, const float* in, float* fk_b,
                             float* fk_p, int B, void* stream) {
  const int blocks = (B + WTW_BLOCK - 1) / WTW_BLOCK;
  wtw_fk_kernel<<<blocks, WTW_BLOCK, 0, (cudaStream_t)stream>>>(
      (const WtwModel*)m, in, fk_b, fk_p, B);
  return (int)cudaGetLastError();
}
#else
// Host build of the same body (CPU tests of the kernel's arithmetic).
extern "C" int wtw_fk_host(const void* m, const float* in, float* fk_b,
                           float* fk_p, int B) {
  for (int e = 0; e < B; ++e)
    fk_env(*(const WtwModel*)m, in, fk_b, fk_p, B, e);
  return 0;
}
#endif
