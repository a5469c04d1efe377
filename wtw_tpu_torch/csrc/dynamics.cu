// Kernel B: one whole contact-dynamics substep per env, one thread per env.
//
// Replaces the Pallas kernel `_pallas_dynamics`
// (wtw_tpu/physics/batched.py:926, pallas_call at :1024), which runs all of
// `dynamics_core` (:314) per (8, 128) env tile: body velocities, compact
// inertias with payload/CoM randomization, RNEA bias forces with the
// gravity trick and an external acceleration, the joint-space mass matrix
// by CRBA over composite inertias, sphere contacts against a heightfield
// (bilinear height, analytic normal, depth along the normal, elastic force
// capped by the depenetration speed, implicit normal and friction damping),
// the same spheres against an optional ceiling (overhead obstacles,
// :516-533), a right-looking Cholesky with inverted diagonals, semi-implicit Euler with
// quaternion renormalization, and the foot/thigh/calf/base contact sums.
//
// Layout (struct of arrays, env index fastest):
//   st   (3 + 4 + nj + nv + nj, B): base_pos, base_quat, joint_q,
//        u = (ang vel 3, lin vel 3, joint qd nj), tau nj
//   fk_b, fk_p: kernel A's outputs, read in place
//   hc   (4, P, B): terrain corner heights h00, h10, h01, h11 per sphere
//   duv  (2, P, B): in-cell offsets du, dv per sphere
//   ceil_h (P, B): ceiling height over each sphere, or null (no ceiling)
//   env  (9, B): friction, restitution, payload, com_off 3, g_ext 3
//   out  (3+4+3+3+nj+nj+12+12+12+4+4+1+1, B): base_pos, base_quat,
//        base_lin_vel, base_ang_vel, joint_q, joint_qd, foot_forces 4x3,
//        foot_positions 4x3, foot_velocities 4x3, thigh 4, calf 4,
//        base_contact, total_normal_force
//
// Bound on the H100: per env ~2.6 KB of inputs and outputs against a few
// thousand to ~30 k fp32 operations (the count depends on how many spheres
// touch the ground: a sphere out of contact contributes exactly zero and is
// skipped). That is near the fp32 ridge (67 TFLOP/s over 3.35 TB/s), so
// neither bound is far ahead. The practical limit of this first version is
// latency: each thread's 21x21 system matrix and per-body arrays live in
// local memory, and 4096 envs fill only 32 blocks of 128 threads on 132 SMs.
// The design keeps every global access coalesced, walks the tree with
// runtime loops over the constant buffer (no generated code), rank-updates
// only the ancestor dofs of each touching sphere, and leaves occupancy for
// a later version.
//
// The ceiling doubles the contact set without doubling the code: both
// contact loops run two passes over the spheres, ground then ceiling (the
// order of the JAX engine's concatenation), and only the geometry differs
// (contact_geom). The ceiling's normal is the constant (0, 0, -1): the
// open-sky sentinel (1e6 m) blends bilinearly with real heights at crawl
// cell edges, and slopes taken from those heights would overflow.
#include "wtw_model.cuh"

// Contact normal n and depth of sphere p against the ground (pass 0: the
// bilinear patch of its corner rows, depth along the analytic normal) or
// the ceiling (pass 1); false when out of contact, where the sphere
// contributes exactly zero.
WTW_FN bool contact_geom(const WtwModel& m, const float* __restrict__ fkp,
                         const float* __restrict__ hc,
                         const float* __restrict__ duv,
                         const float* __restrict__ ceil_h, float inv_s,
                         int pass, int p, int B, int e, float* n,
                         float* depth) {
#define ROW(ptr, r) (ptr)[(size_t)(r) * B + e]
  const int P = m.P;
  const float z = ROW(fkp, 2 * P + p);
  if (pass == 1) {
    n[0] = 0.0f;
    n[1] = 0.0f;
    n[2] = -1.0f;
    *depth = z + m.sph_radius[p] - ROW(ceil_h, p);
    return *depth > 0.0f;
  }
  const float h00 = ROW(hc, p), h10 = ROW(hc, P + p);
  const float h01 = ROW(hc, 2 * P + p), h11 = ROW(hc, 3 * P + p);
  const float du = ROW(duv, p), dv = ROW(duv, P + p);
#undef ROW
  const float h = h00 * (1.0f - du) * (1.0f - dv) + h10 * du * (1.0f - dv)
                + h01 * (1.0f - du) * dv + h11 * du * dv;
  const float dhdx = ((h10 - h00) * (1.0f - dv) + (h11 - h01) * dv) * inv_s;
  const float dhdy = ((h01 - h00) * (1.0f - du) + (h11 - h10) * du) * inv_s;
  const float inv_n = rsqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
  n[0] = -dhdx * inv_n;
  n[1] = -dhdy * inv_n;
  n[2] = inv_n;
  *depth = (z - h) * (-inv_n) + m.sph_radius[p];
  return *depth > 0.0f;
}

WTW_FN void dynamics_env(const WtwModel& m, const float* __restrict__ st,
                         const float* __restrict__ fkb,
                         const float* __restrict__ fkp,
                         const float* __restrict__ hc,
                         const float* __restrict__ duv,
                         const float* __restrict__ ceil_h,
                         const float* __restrict__ env, float inv_s,
                         float* __restrict__ out, int B, int e) {
#define ROW(ptr, r) (ptr)[(size_t)(r) * B + e]
  const int nb = m.nb, nj = m.nj, nv = m.nv, P = m.P, lo = m.lo;
  const float dt = m.dt;

  float p0[3], q0[4], u[WTW_MAX_DOFS];
  for (int k = 0; k < 3; ++k) p0[k] = ROW(st, k);
  for (int k = 0; k < 4; ++k) q0[k] = ROW(st, 3 + k);
  for (int i = 0; i < nv; ++i) u[i] = ROW(st, 7 + nj + i);
  const float fric = ROW(env, 0), rest = ROW(env, 1), payload = ROW(env, 2);
  float com_off[3], g[3];
  for (int k = 0; k < 3; ++k) {
    com_off[k] = ROW(env, 3 + k);
    g[k] = m.gravity[k] + ROW(env, 6 + k);
  }

  // ---- body poses (kernel A) and dof spatial axes S_i = (sw, sv) ----
  float bpos[WTW_MAX_BODIES][3], R[WTW_MAX_BODIES][9];
  for (int b = 0; b < nb; ++b) {
    float q[4];
    for (int k = 0; k < 3; ++k) bpos[b][k] = ROW(fkb, b * 3 + k);
    for (int k = 0; k < 4; ++k) q[k] = ROW(fkb, nb * 3 + b * 4 + k);
    quat_to_R(q, R[b]);
  }
  float S[WTW_MAX_DOFS][6];
  for (int i = 0; i < 6; ++i)
    for (int k = 0; k < 6; ++k) S[i][k] = (i == k) ? 1.0f : 0.0f;
  for (int j = 0; j < nj; ++j) {
    float r[3];
    for (int k = 0; k < 3; ++k) {
      S[6 + j][k] = ROW(fkb, nb * 7 + nj * 3 + j * 3 + k);
      r[k] = ROW(fkb, nb * 7 + j * 3 + k) - p0[k];
    }
    cross3(r, S[6 + j], &S[6 + j][3]);
  }

  // ---- body spatial velocities down the tree ----
  float V[WTW_MAX_BODIES][6];
  for (int k = 0; k < 6; ++k) V[0][k] = u[k];
  for (int j = 0; j < nj; ++j) {
    const int c = j + 1, p = m.parent[c];
    for (int k = 0; k < 6; ++k) V[c][k] = V[p][k] + u[6 + j] * S[6 + j][k];
  }

  // ---- compact spatial inertias (I_o, h = m c, m) about base_pos ----
  float Io[WTW_MAX_BODIES][9], hv[WTW_MAX_BODIES][3], ms[WTW_MAX_BODIES];
  for (int b = 0; b < nb; ++b) {
    float c[3], t[3];
    mat_vec3(R[b], m.com[b], t);
    for (int k = 0; k < 3; ++k) c[k] = bpos[b][k] + t[k] - p0[k];
    if (b == 0) {
      mat_vec3(R[0], com_off, t);
      for (int k = 0; k < 3; ++k) c[k] += t[k];
    }
    const float mass = m.mass[b] + (b == 0 ? payload : 0.0f);
    float RI[9];  // R Ic, then (R Ic) R^T
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        RI[3 * i + j] = R[b][3 * i] * m.inertia[b][j]
                      + R[b][3 * i + 1] * m.inertia[b][3 + j]
                      + R[b][3 * i + 2] * m.inertia[b][6 + j];
    const float c2 = dot3(c, c);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float iw = RI[3 * i] * R[b][3 * j] + RI[3 * i + 1] * R[b][3 * j + 1]
                       + RI[3 * i + 2] * R[b][3 * j + 2];
        Io[b][3 * i + j] = iw + mass * ((i == j ? c2 : 0.0f) - c[i] * c[j]);
      }
    for (int k = 0; k < 3; ++k) hv[b][k] = mass * c[k];
    ms[b] = mass;
  }

  // ---- bias forces: RNEA with the gravity trick ----
  float acc[WTW_MAX_BODIES][6];
  acc[0][0] = acc[0][1] = acc[0][2] = 0.0f;
  for (int k = 0; k < 3; ++k) acc[0][3 + k] = -g[k];
  for (int j = 0; j < nj; ++j) {
    const int c = j + 1, p = m.parent[c];
    float sw[3], sv[3], cw[3], cv[3], t[3];
    for (int k = 0; k < 3; ++k) {
      sw[k] = u[6 + j] * S[6 + j][k];
      sv[k] = u[6 + j] * S[6 + j][3 + k];
    }
    cross3(V[c], sw, cw);
    cross3(V[c], sv, cv);
    cross3(&V[c][3], sw, t);
    for (int k = 0; k < 3; ++k) {
      acc[c][k] = acc[p][k] + cw[k];
      acc[c][3 + k] = acc[p][3 + k] + cv[k] + t[k];
    }
  }
  // f_b = I_b a_b + V_b x* (I_b V_b), accumulated into subtree sums
  float F[WTW_MAX_BODIES][6];
  for (int b = 0; b < nb; ++b) {
    float t1[3], f1[3], tV[3], fV[3], x[3], y[3];
    mat_vec3(Io[b], acc[b], t1);
    cross3(hv[b], &acc[b][3], x);
    cross3(acc[b], hv[b], y);
    for (int k = 0; k < 3; ++k) {
      t1[k] += x[k];
      f1[k] = ms[b] * acc[b][3 + k] + y[k];
    }
    mat_vec3(Io[b], V[b], tV);
    cross3(hv[b], &V[b][3], x);
    cross3(V[b], hv[b], y);
    for (int k = 0; k < 3; ++k) {
      tV[k] += x[k];
      fV[k] = ms[b] * V[b][3 + k] + y[k];
    }
    cross3(V[b], tV, x);
    cross3(&V[b][3], fV, y);
    for (int k = 0; k < 3; ++k) F[b][k] = t1[k] + x[k] + y[k];
    cross3(V[b], fV, x);
    for (int k = 0; k < 3; ++k) F[b][3 + k] = f1[k] + x[k];
  }
  for (int b = nb - 1; b > 0; --b)
    for (int k = 0; k < 6; ++k) F[m.parent[b]][k] += F[b][k];
  float C[WTW_MAX_DOFS];
  for (int k = 0; k < 6; ++k) C[k] = F[0][k];
  for (int j = 0; j < nj; ++j)
    C[6 + j] = dot3(S[6 + j], F[j + 1]) + dot3(&S[6 + j][3], &F[j + 1][3]);

  // ---- mass matrix by CRBA over composite inertias (in place) ----
  for (int b = nb - 1; b > 0; --b) {
    const int p = m.parent[b];
    for (int k = 0; k < 9; ++k) Io[p][k] += Io[b][k];
    for (int k = 0; k < 3; ++k) hv[p][k] += hv[b][k];
    ms[p] += ms[b];
  }
  float A[WTW_MAX_DOFS * WTW_MAX_DOFS];
  for (int i = 0; i < nv * nv; ++i) A[i] = 0.0f;
#define AM(i, j) A[(i) * nv + (j)]
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) AM(i, j) = Io[0][3 * i + j];
  {
    const float hx = hv[0][0], hy = hv[0][1], hz = hv[0][2];
    const float sk[9] = {0.0f, -hz, hy, hz, 0.0f, -hx, -hy, hx, 0.0f};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        AM(i, 3 + j) = sk[3 * i + j];
        AM(3 + j, i) = sk[3 * i + j];
      }
    for (int i = 0; i < 3; ++i) AM(3 + i, 3 + i) = ms[0];
  }
  for (int j = 0; j < nj; ++j) {
    const int b = j + 1;
    const float* sw = S[6 + j];
    const float* sv = &S[6 + j][3];
    float Fw[3], Fv[3], x[3];
    mat_vec3(Io[b], sw, Fw);
    cross3(hv[b], sv, x);
    for (int k = 0; k < 3; ++k) Fw[k] += x[k];
    cross3(sw, hv[b], x);
    for (int k = 0; k < 3; ++k) Fv[k] = ms[b] * sv[k] + x[k];
    for (int a = 0; a < m.n_anc[b]; ++a) {
      const int i = m.anc_dofs[b][a];
      if (i > 6 + j) continue;
      const float val = dot3(S[i], Fw) + dot3(&S[i][3], Fv);
      AM(i, 6 + j) = val;
      AM(6 + j, i) = val;
    }
    AM(6 + j, 6 + j) += m.armature;
  }

  // ---- rhs = M u + dt (tau - C); implicit joint damping ----
  float rhs[WTW_MAX_DOFS];
  for (int i = 0; i < nv; ++i) {
    float s = 0.0f;
    for (int j = 0; j < nv; ++j) s += AM(i, j) * u[j];
    const float tau = i >= 6 ? ROW(st, 7 + nj + nv + (i - 6)) : 0.0f;
    rhs[i] = s + dt * (tau - C[i]);
  }
  for (int j = 0; j < nj; ++j) AM(6 + j, 6 + j) += dt * m.joint_damping[j];

  // ---- sphere contacts: implicit normal + friction damping rows ----
  const float c_n_imp = m.c_contact * (1.0f - rest) + dt * m.k_contact;
  const float f_cap = c_n_imp * m.v_maxdep;
  const float eps2 = m.vel_eps * m.vel_eps;
  const int n_pass = ceil_h ? 2 : 1;
  for (int pass = 0; pass < n_pass; ++pass)
  for (int p = 0; p < P; ++p) {
    float n[3], depth;
    if (!contact_geom(m, fkp, hc, duv, ceil_h, inv_s, pass, p, B, e, n, &depth))
      continue;
    const int b = m.sph_body[p];
    float r[3], vel[3];
    for (int k = 0; k < 3; ++k) r[k] = ROW(fkp, k * P + p) - p0[k];
    cross3(V[b], r, vel);
    for (int k = 0; k < 3; ++k) vel[k] += V[b][3 + k];
    const float fn0 = fminf(fmaxf(m.k_contact * depth, 0.0f), f_cap);
    const float vn = dot3(vel, n);
    float vt[3];
    for (int k = 0; k < 3; ++k) vt[k] = vel[k] - vn * n[k];
    const float ct = fric * fn0 * rsqrtf(dot3(vt, vt) + eps2);
    const float coef = c_n_imp - ct;
    const int na = m.n_anc[b];
    float J[WTW_MAX_DOFS][3], w[WTW_MAX_DOFS];
    for (int a = 0; a < na; ++a) {
      const int i = m.anc_dofs[b][a];
      cross3(S[i], r, J[a]);
      for (int k = 0; k < 3; ++k) J[a][k] += S[i][3 + k];
      w[a] = dot3(J[a], n);
    }
    for (int a = 0; a < na; ++a) {
      const int i = m.anc_dofs[b][a];
      for (int c = 0; c < na; ++c)
        AM(i, m.anc_dofs[b][c]) += dt * (coef * w[a] * w[c]
                                         + ct * dot3(J[a], J[c]));
      rhs[i] += dt * w[a] * fn0;
    }
  }

  // ---- right-looking Cholesky, inverted diagonal, two triangular solves ----
  float dinv[WTW_MAX_DOFS];
  for (int k = lo; k < nv; ++k) {
    const float dk = rsqrtf(AM(k, k));
    dinv[k] = dk;
    for (int i = k + 1; i < nv; ++i) AM(i, k) *= dk;
    for (int j = k + 1; j < nv; ++j) {
      const float ljk = AM(j, k);
      for (int i = j; i < nv; ++i) AM(i, j) -= AM(i, k) * ljk;
    }
  }
  float un[WTW_MAX_DOFS];
  for (int k = 0; k < lo; ++k) un[k] = 0.0f;
  for (int k = lo; k < nv; ++k) {
    float s = rhs[k];
    for (int j = lo; j < k; ++j) s -= AM(k, j) * un[j];
    un[k] = s * dinv[k];
  }
  for (int k = nv - 1; k >= lo; --k) {
    float s = un[k];
    for (int j = k + 1; j < nv; ++j) s -= AM(j, k) * un[j];
    un[k] = s * dinv[k];
  }
#undef AM

  // ---- realized contact forces at the new velocities (diagnostics) ----
  float gacc[WTW_N_GROUPS][3];
  for (int gk = 0; gk < WTW_N_GROUPS; ++gk)
    gacc[gk][0] = gacc[gk][1] = gacc[gk][2] = 0.0f;
  float total_fn = 0.0f;
  for (int pass = 0; pass < n_pass; ++pass)
  for (int p = 0; p < P; ++p) {
    float n[3], depth;
    if (!contact_geom(m, fkp, hc, duv, ceil_h, inv_s, pass, p, B, e, n, &depth))
      continue;
    const int b = m.sph_body[p];
    float r[3], vel[3], cv[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) r[k] = ROW(fkp, k * P + p) - p0[k];
    cross3(V[b], r, vel);
    for (int k = 0; k < 3; ++k) vel[k] += V[b][3 + k];
    const float fn0 = fminf(fmaxf(m.k_contact * depth, 0.0f), f_cap);
    const float vn = dot3(vel, n);
    float vt[3];
    for (int k = 0; k < 3; ++k) vt[k] = vel[k] - vn * n[k];
    const float ct = fric * fn0 * rsqrtf(dot3(vt, vt) + eps2);
    for (int a = 0; a < m.n_anc[b]; ++a) {
      const int i = m.anc_dofs[b][a];
      float Ji[3];
      cross3(S[i], r, Ji);
      for (int k = 0; k < 3; ++k) cv[k] += (Ji[k] + S[i][3 + k]) * un[i];
    }
    const float vn_new = dot3(cv, n);
    const float fn_lin = fn0 - c_n_imp * vn_new;
    total_fn += fmaxf(fn_lin, 0.0f);
    const int gk = m.sph_group[p];  // a ceiling copy keeps its group
    if (gk >= 0)
      for (int k = 0; k < 3; ++k)
        gacc[gk][k] += fn_lin * n[k] - ct * (cv[k] - vn_new * n[k]);
  }

  // ---- semi-implicit Euler, quaternion renormalization ----
  int o = 0;
  float dpos[3], wxd[3];
  for (int k = 0; k < 3; ++k) dpos[k] = dt * un[3 + k];
  cross3(un, dpos, wxd);
  for (int k = 0; k < 3; ++k) ROW(out, o++) = p0[k] + dpos[k];
  {
    const float theta = sqrtf(un[0] * un[0] + un[1] * un[1] + un[2] * un[2]
                              + 1e-30f);
    const float half = 0.5f * dt * theta;
    const float kf = theta > 1e-9f ? sinf(half) / fmaxf(theta, 1e-9f)
                                   : 0.5f * dt;
    const float dq[4] = {un[0] * kf, un[1] * kf, un[2] * kf, cosf(half)};
    float qn[4];
    qmul(dq, q0, qn);
    const float inv = rsqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                             + qn[3] * qn[3]);
    for (int k = 0; k < 4; ++k) ROW(out, o++) = qn[k] * inv;
  }
  for (int k = 0; k < 3; ++k) ROW(out, o++) = un[3 + k] + wxd[k];
  for (int k = 0; k < 3; ++k) ROW(out, o++) = un[k];
  for (int j = 0; j < nj; ++j) ROW(out, o++) = ROW(st, 7 + j) + dt * un[6 + j];
  for (int j = 0; j < nj; ++j) ROW(out, o++) = un[6 + j];
  for (int l = 0; l < 4; ++l)
    for (int k = 0; k < 3; ++k) ROW(out, o++) = gacc[l][k];

  // ---- foot kinematics ----
  float fpos[4][3], fvel[4][3];
  for (int l = 0; l < 4; ++l) {
    const int fb = m.feet_body[l];
    float t[3], r[3];
    mat_vec3(R[fb], m.feet_pos[l], t);
    for (int k = 0; k < 3; ++k) {
      fpos[l][k] = bpos[fb][k] + t[k];
      r[k] = fpos[l][k] - p0[k];
    }
    cross3(V[fb], r, t);
    for (int k = 0; k < 3; ++k) fvel[l][k] = V[fb][3 + k] + t[k];
  }
  for (int l = 0; l < 4; ++l)
    for (int k = 0; k < 3; ++k) ROW(out, o++) = fpos[l][k];
  for (int l = 0; l < 4; ++l)
    for (int k = 0; k < 3; ++k) ROW(out, o++) = fvel[l][k];
  for (int gk = 4; gk < WTW_N_GROUPS; ++gk)
    ROW(out, o++) = sqrtf(dot3(gacc[gk], gacc[gk]) + 1e-30f);
  ROW(out, o++) = total_fn;
#undef ROW
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(WTW_BLOCK)
wtw_dynamics_kernel(const WtwModel* __restrict__ m,
                    const float* __restrict__ st, const float* __restrict__ fkb,
                    const float* __restrict__ fkp, const float* __restrict__ hc,
                    const float* __restrict__ duv,
                    const float* __restrict__ ceil_h,
                    const float* __restrict__ env, float inv_s,
                    float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < B)
    dynamics_env(*m, st, fkb, fkp, hc, duv, ceil_h, env, inv_s, out, B, e);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int wtw_dynamics_launch(const void* m, const float* st,
                                   const float* fkb, const float* fkp,
                                   const float* hc, const float* duv,
                                   const float* ceil_h, const float* env,
                                   float inv_s, float* out, int B,
                                   void* stream) {
  const int blocks = (B + WTW_BLOCK - 1) / WTW_BLOCK;
  wtw_dynamics_kernel<<<blocks, WTW_BLOCK, 0, (cudaStream_t)stream>>>(
      (const WtwModel*)m, st, fkb, fkp, hc, duv, ceil_h, env, inv_s, out, B);
  return (int)cudaGetLastError();
}
#else
extern "C" int wtw_dynamics_host(const void* m, const float* st,
                                 const float* fkb, const float* fkp,
                                 const float* hc, const float* duv,
                                 const float* ceil_h, const float* env,
                                 float inv_s, float* out, int B) {
  for (int e = 0; e < B; ++e)
    dynamics_env(*(const WtwModel*)m, st, fkb, fkp, hc, duv, ceil_h, env, inv_s,
                 out, B, e);
  return 0;
}
#endif
