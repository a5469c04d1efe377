// Kernel A: forward kinematics over the static tree plus the world xyz of
// every collision sphere, a team of FK_LANES lanes per env.
//
// Replaces the Pallas kernel `_pallas_fk` (wtw_tpu/physics/batched.py:882,
// pallas_call at :908), which runs `fk_core` + `sphere_pos_core` per
// (8, 128) env tile.
//
// Layout (struct of arrays, env index fastest):
//   in   (7 + nj, B): base_pos 3, base_quat 4 (xyzw), joint_q nj
//   fk_b (nb*7 + nj*6, B): body_pos nb x 3, body_quat nb x 4,
//        joint anchors nj x 3, world joint axes nj x 3
//   fk_p (3, P, B): sphere world x, y, z
//
// Bound on the H100: bytes. Per env it reads 7 + nj floats and writes
// nb*7 + nj*6 + 3P (go1 280, Go2 316 floats), against ~3 k flops: far below
// the card's ~20 flop/byte fp32 ridge. What stands in the way is latency:
// run by one thread, an env's tree walk is one dependent chain, and 4096
// envs make only 128 warps for 132 SMs. Here a block stages its
// FK_ENVS envs' input rows in shared memory, each env's team of FK_LANES
// lanes walks the tree level by level (lanes over a level's bodies, a sync
// between levels: 3 steps for a 12-joint quadruped, whose levels hold 4
// bodies), then computes the spheres with lanes over P, and the block
// writes the output rows coalesced. A team narrower than a warp keeps the
// lanes busy: a warp-wide team would issue every instruction of a level for
// 32 lanes of which 4 work.
//
// A mixed-robot batch (wtw_fk_multi_launch) runs the same body through the
// slot table of wtw_model.cuh: a block reads its robot from slot_robot and
// stages that model alone, so the static shared memory and the blocks per
// SM stay those of a single robot; the rows are read and written at the
// slots' env columns.
#include "wtw_model.cuh"

#define FK_LANES 8   // lanes per env: a level of a quadruped has 4 bodies
#define FK_ENVS 16   // envs per block: 4 teams per warp, 64-byte row segments

struct FkEnvCore {
  float in[7 + WTW_MAX_JOINTS];
  float pos[WTW_MAX_BODIES][3];
  float quat[WTW_MAX_BODIES][4];
  float R[WTW_MAX_BODIES][9];
  float fkb[WTW_MAX_FKB];              // output rows of fk_b
  float fkp[3 * WTW_MAX_SPHERES];      // output rows of fk_p
};
struct FkEnv : FkEnvCore {
  float pad[wtw_pad<FK_ENVS>(sizeof(FkEnvCore) / 4)];
};
constexpr int FK_STRIDE = sizeof(FkEnv) / 4;
constexpr int FK_SMEM = FK_ENVS * sizeof(FkEnv) + sizeof(WtwModel);

// body b's pose is known: its rotation matrix and its fk_b rows
WTW_FN void fk_body_out(const WtwModel& m, FkEnv* w, int b) {
  quat_to_R(w->quat[b], w->R[b]);
  for (int k = 0; k < 3; ++k) w->fkb[b * 3 + k] = w->pos[b][k];
  for (int k = 0; k < 4; ++k) w->fkb[m.nb * 3 + b * 4 + k] = w->quat[b][k];
}

// one env's tree walk and spheres; every lane of the team calls it
WTW_FN void fk_team(const WtwModel& m, FkEnv* w, int lane) {
  const int nb = m.nb, nj = m.nj, P = m.P;
  team_phase<FK_LANES>(lane, [&](int l) {
    if (l == 0) {
      for (int k = 0; k < 3; ++k) w->pos[0][k] = w->in[k];
      for (int k = 0; k < 4; ++k) w->quat[0][k] = w->in[3 + k];
      fk_body_out(m, w, 0);
    }
  });
  for (int lv = 1; lv < m.n_lvl; ++lv) {
    const int o = m.lvl_off[lv], n = m.lvl_off[lv + 1] - o;
    team_phase<FK_LANES>(lane, [&](int l) {
      for (int x = l; x < n; x += FK_LANES) {
        const int c = m.lvl_body[o + x], j = c - 1, p = m.parent[c];
        float r[3], qf[4], qj[4], ax[3];
        qrot(w->quat[p], m.joint_pos[j], r);
        for (int k = 0; k < 3; ++k) w->pos[c][k] = w->pos[p][k] + r[k];
        qmul(w->quat[p], m.joint_quat[j], qf);
        const float half = 0.5f * w->in[7 + j];
        const float s = sinf(half), cs = cosf(half);
        qj[0] = m.joint_axis[j][0] * s;
        qj[1] = m.joint_axis[j][1] * s;
        qj[2] = m.joint_axis[j][2] * s;
        qj[3] = cs;
        qmul(qf, qj, w->quat[c]);
        qrot(qf, m.joint_axis[j], ax);
        for (int k = 0; k < 3; ++k) {
          w->fkb[nb * 7 + j * 3 + k] = w->pos[c][k];
          w->fkb[nb * 7 + nj * 3 + j * 3 + k] = ax[k];
        }
        fk_body_out(m, w, c);
      }
    });
  }
  team_phase<FK_LANES>(lane, [&](int l) {
    for (int p = l; p < P; p += FK_LANES) {
      const int b = m.sph_body[p];
      float o[3];
      mat_vec3(w->R[b], m.sph_pos[p], o);
      for (int k = 0; k < 3; ++k) w->fkp[k * P + p] = w->pos[b][k] + o[k];
    }
  });
}

// one block: stage FK_ENVS envs and the robot model, run the teams, store
// their rows (tid/nthr: this thread among the block's; the host passes 0/1;
// MAPPED: slots e0 .. through slot_env)
template <bool MAPPED>
WTW_FN void fk_stage(const WtwModel* __restrict__ m,
                     const float* __restrict__ in, FkEnv* sm, WtwModel* msm,
                     int B, int e0, int tid, int nthr,
                     const int* __restrict__ slot_env) {
  stage_rows<FK_ENVS, MAPPED>(in, 7 + m->nj, B, e0, (float*)sm, FK_STRIDE,
                              offsetof(FkEnvCore, in) / 4, tid, nthr,
                              slot_env);
  stage_model(m, msm, tid, nthr);
}

template <bool MAPPED>
WTW_FN void fk_store(const WtwModel& m, float* __restrict__ fk_b,
                     float* __restrict__ fk_p, const FkEnv* sm, int B, int e0,
                     int tid, int nthr, const int* __restrict__ slot_env) {
  store_rows<FK_ENVS, MAPPED>(fk_b, m.nb * 7 + m.nj * 6, B, e0,
                              (const float*)sm, FK_STRIDE,
                              offsetof(FkEnvCore, fkb) / 4, tid, nthr,
                              slot_env);
  store_rows<FK_ENVS, MAPPED>(fk_p, 3 * m.P, B, e0, (const float*)sm,
                              FK_STRIDE, offsetof(FkEnvCore, fkp) / 4, tid,
                              nthr, slot_env);
}

extern "C" int wtw_model_bytes() { return (int)sizeof(WtwModel); }

#ifdef __CUDACC__
// MAPPED: a mixed batch, m holds one model per robot and the block's slots
// go through slot_env / slot_robot
template <bool MAPPED>
__global__ void __launch_bounds__(FK_LANES * FK_ENVS)
wtw_fk_kernel(const WtwModel* __restrict__ m, const int* __restrict__ slot_env,
              const int* __restrict__ slot_robot,
              const float* __restrict__ in, float* __restrict__ fk_b,
              float* __restrict__ fk_p, int B) {
  __shared__ FkEnv sm[FK_ENVS];
  __shared__ WtwModel msm;
  const int e0 = blockIdx.x * FK_ENVS;
  if constexpr (MAPPED) m += slot_robot[e0];
  fk_stage<MAPPED>(m, in, sm, &msm, B, e0, threadIdx.x, blockDim.x,
                   slot_env);
  stage_wait();
  __syncthreads();
  // every team runs every phase, also past the ragged edge (its inputs are
  // 0 there and its rows are not stored), but for an empty slot's
  // (slot_live); the block's barriers are outside the body
  if (slot_live<MAPPED>(slot_env, e0 + threadIdx.x / FK_LANES))
    fk_team(msm, &sm[threadIdx.x / FK_LANES], threadIdx.x % FK_LANES);
  __syncthreads();
  fk_store<MAPPED>(msm, fk_b, fk_p, sm, B, e0, threadIdx.x, blockDim.x,
                   slot_env);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int wtw_fk_launch(const void* m, const float* in, float* fk_b,
                             float* fk_p, int B, void* stream) {
  const int blocks = (B + FK_ENVS - 1) / FK_ENVS;
  wtw_fk_kernel<false><<<blocks, FK_LANES * FK_ENVS, 0,
                         (cudaStream_t)stream>>>(
      (const WtwModel*)m, nullptr, nullptr, in, fk_b, fk_p, B);
  return (int)cudaGetLastError();
}

// A mixed batch: models of R robots back to back, n_slots slots (a
// multiple of FK_ENVS) of the slot table. Returns a cudaError.
extern "C" int wtw_fk_multi_launch(const void* m, const int* slot_env,
                                   const int* slot_robot, int n_slots,
                                   const float* in, float* fk_b, float* fk_p,
                                   int B, void* stream) {
  if (n_slots % FK_ENVS) return (int)cudaErrorInvalidValue;
  wtw_fk_kernel<true><<<n_slots / FK_ENVS, FK_LANES * FK_ENVS, 0,
                        (cudaStream_t)stream>>>(
      (const WtwModel*)m, slot_env, slot_robot, in, fk_b, fk_p, B);
  return (int)cudaGetLastError();
}

// lanes per env, envs per block, shared bytes per block, resident blocks
// per SM; returns a cudaError (0 = ok)
template <bool MAPPED>
static int fk_info(int* info) {
  info[0] = FK_LANES;
  info[1] = FK_ENVS;
  info[2] = FK_SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[3], wtw_fk_kernel<MAPPED>, FK_LANES * FK_ENVS, 0);
}
extern "C" int wtw_fk_info(int* info) { return fk_info<false>(info); }
extern "C" int wtw_fk_multi_info(int* info) { return fk_info<true>(info); }
#else
#include <vector>

// Host build of the same body (CPU tests of the kernel's arithmetic and
// of its phases): blocks one after another, each team's lanes in turn.
template <bool MAPPED>
static int fk_host(const WtwModel* m, const int* slot_env,
                   const int* slot_robot, int n_slots, const float* in,
                   float* fk_b, float* fk_p, int B) {
  std::vector<FkEnv> sm(FK_ENVS);
  WtwModel msm{};
  if (n_slots % FK_ENVS) return 1;
  for (int e0 = 0; e0 < n_slots; e0 += FK_ENVS) {
    // NaN everywhere first: a read of what no phase wrote shows
    for (FkEnv& w : sm)
      for (int i = 0; i < FK_STRIDE; ++i) ((float*)&w)[i] = NAN;
    const WtwModel* mb = MAPPED ? m + slot_robot[e0] : m;
    fk_stage<MAPPED>(mb, in, sm.data(), &msm, B, e0, 0, 1, slot_env);
    for (int t = 0; t < FK_ENVS; ++t)
      if (slot_live<MAPPED>(slot_env, e0 + t)) fk_team(msm, &sm[t], 0);
    fk_store<MAPPED>(msm, fk_b, fk_p, sm.data(), B, e0, 0, 1, slot_env);
  }
  return 0;
}

extern "C" int wtw_fk_host(const void* m, const float* in, float* fk_b,
                           float* fk_p, int B) {
  const int n = (B + FK_ENVS - 1) / FK_ENVS * FK_ENVS;
  return fk_host<false>((const WtwModel*)m, nullptr, nullptr, n, in, fk_b,
                        fk_p, B);
}

extern "C" int wtw_fk_multi_host(const void* m, const int* slot_env,
                                 const int* slot_robot, int n_slots,
                                 const float* in, float* fk_b, float* fk_p,
                                 int B) {
  return fk_host<true>((const WtwModel*)m, slot_env, slot_robot, n_slots, in,
                       fk_b, fk_p, B);
}

extern "C" void wtw_set_lane_order(int reverse) { wtw_lane_reverse = reverse; }

extern "C" int wtw_fk_info(int* info) {
  info[0] = FK_LANES;
  info[1] = FK_ENVS;
  info[2] = FK_SMEM;
  info[3] = 0;
  return 0;
}
extern "C" int wtw_fk_multi_info(int* info) { return wtw_fk_info(info); }
#endif
