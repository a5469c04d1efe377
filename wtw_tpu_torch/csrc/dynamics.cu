// Kernel B: one whole contact-dynamics substep per env, a team of DYN_LANES
// lanes per env.
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
// :516-533), a right-looking Cholesky with inverted diagonals, semi-implicit
// Euler with quaternion renormalization, and the foot/thigh/calf/base
// contact sums.
//
// Layout (struct of arrays, env index fastest):
//   st   (3 + 4 + nj + nv + nj, B): base_pos, base_quat, joint_q,
//        u = (ang vel 3, lin vel 3, joint qd nj), tau nj
//   fk_b, fk_p: kernel A's outputs
//   hc   (4, P, B): terrain corner heights h00, h10, h01, h11 per sphere
//   duv  (2, P, B): in-cell offsets du, dv per sphere
//   ceil_h (P, B): ceiling height over each sphere, or null (no ceiling)
//   env  (9, B): friction, restitution, payload, com_off 3, g_ext 3
//   out  (3+4+3+3+nj+nj+12+12+12+4+4+1+1, B): base_pos, base_quat,
//        base_lin_vel, base_ang_vel, joint_q, joint_qd, foot_forces 4x3,
//        foot_positions 4x3, foot_velocities 4x3, thigh 4, calf 4,
//        base_contact, total_normal_force
//
// Bound on the H100: per env ~3.3 KB of inputs and outputs against a few
// thousand to ~30 k fp32 operations (the count depends on how many spheres
// touch: a sphere out of contact contributes exactly zero and is skipped),
// so bytes bound it, at a few microseconds for 4096 envs. What stands in
// the way is latency: run by one thread, an env's ~30 k operations are one
// dependent chain out of a local-memory stack, and 4096 envs make only 128
// warps for 132 SMs. The design shortens the chain and fills the card:
//
// - a team of DYN_LANES lanes (one warp) per env and DYN_ENVS envs per
//   block, so 4096 envs make 4096 warps;
// - the env's working set (system matrix, body arrays, contact slots) in
//   shared memory, with the block's input rows staged there coalesced and
//   its output rows written from there;
// - phases with lanes over independent work: bodies, dofs, a level of the
//   tree, contact candidates (ground then ceiling, DYN_LANES at a time)
//   and lower-triangle entries of the system;
// - every sum over the tree as a subtree sum, level by level up the tree
//   with lanes over (parent, component): bias forces, composite inertias,
//   momenta (M u = sum over dof i's subtree of I_b V_b), and the contacts.
//   A touching contact with arm r and normal n adds to the system
//   S^T H S, with the 6x6 H = coef psi psi^T + ct [|r|^2 I - r r^T, [r]x;
//   [r]x^T, I], psi = (r x n, n) (this is the Jacobian form
//   coef w w^T + ct J^T J of the plain version, with J_i = sw_i x r + sv_i
//   and w = J^T n), and fn0 psi to the right-hand side. Summing H and
//   fn0 psi over each body's contacts and then over its subtree gives the
//   contact part of every entry (i, j) as S_i^T K S_j, the CRBA form: no
//   per-contact rank update of the 18x18 system;
// - the system factored leaves first, A = L^T L (the LTL factorization of
//   a tree's mass matrix): eliminating a dof touches only its ancestors,
//   so there is no fill-in, where a right-looking Cholesky in base-first
//   order fills the whole matrix, and the dofs of one tree level (one per
//   leg) are eliminated together, a phase per level. The base rows they
//   share are summed by one lane each in level order, and the 6x6 base
//   block is factored by one lane in registers. The solve L^T z = rhs
//   rides along; L un = z then runs level by level and gives the bodies'
//   new velocities on the way;
// - no floating-point atomics: every sum across lanes is taken by one lane
//   in a fixed order (contacts in candidate order, children in level
//   order), so two launches on the same inputs give the same bits.
//
// The ceiling doubles the contact candidates without doubling the code:
// candidates 0 .. P-1 are the spheres against the ground, P .. 2P-1 the
// same spheres against the ceiling (the order of the JAX engine's
// concatenation), and only contact_geom differs. The ceiling's normal is
// the constant (0, 0, -1): the open-sky sentinel (1e6 m) blends bilinearly
// with real heights at crawl cell edges, and slopes taken from those
// heights would overflow.
//
// A mixed-robot batch (wtw_dynamics_multi_launch) runs the same body
// through the slot table of wtw_model.cuh: a block reads its robot from
// slot_robot and stages that model alone, so the shared memory a block and
// the blocks per SM stay those of a single robot; the rows are read and
// written at the slots' env columns. A robot's padded spheres (radius
// -1e3, which no term divides by or takes a root of) never touch: their
// candidates are skipped like any other sphere out of contact, so they add
// nothing to any sum, and the sums over the touching ones keep their order.
#include "wtw_model.cuh"

#define DYN_LANES 32  // lanes per env: one warp, whose contact loops are the env's own
#define DYN_ENVS 8    // envs per block: 8 floats = one 32-byte sector a row
#define WTW_MAX_ST (7 + WTW_MAX_JOINTS + WTW_MAX_DOFS + WTW_MAX_JOINTS)
#define WTW_MAX_OUT (13 + 2 * WTW_MAX_JOINTS + 36 + 8 + 2)
#define WTW_TRI (WTW_MAX_DOFS * (WTW_MAX_DOFS + 1) / 2)
#define WTW_LD WTW_MAX_DOFS   // row stride of the system matrix (odd)
#define AM(i, j) w->A[(i) * WTW_LD + (j)]
// a body's subtree quantities, contiguous so that one loop sums them: bias
// force F 6, rotational inertia about base_pos Io 9, first moment h 3,
// mass 1, momentum 6; the contact sums K (21 + 6) follow in their own array
#define G_F 0
#define G_IO 6
#define G_HV 15
#define G_MS 18
#define G_PM 19
#define G_N 25
#define NSUB (G_N + 27)

struct DynEnvCore {
  // staged input rows of this env
  float st[WTW_MAX_ST];
  float fkp[3 * WTW_MAX_SPHERES];
  float hc[4 * WTW_MAX_SPHERES];
  float duv[2 * WTW_MAX_SPHERES];
  float ceil[WTW_MAX_SPHERES];
  float env[9];
  union {
    float fkb[WTW_MAX_FKB];            // until the bodies are set up
    float K[WTW_MAX_BODIES][27];       // then contact sums: 6x6 H (lower
                                       // triangle, 21) and fn0 psi (6)
  };
  union {
    float A[WTW_MAX_DOFS * WTW_LD];    // until the solve is done
    float out[WTW_MAX_OUT];            // then the output rows
  };
  float G[WTW_MAX_BODIES][G_N];
  float S[WTW_MAX_DOFS][6];
  float V[WTW_MAX_BODIES][6];
  float acc[WTW_MAX_BODIES][6];  // accelerations, then I_c S_j, then new V
  float KS[WTW_MAX_BODIES][6];   // K_b S_j
  float R[WTW_MAX_BODIES][9];
  float bpos[WTW_MAX_BODIES][3];
  float rhs[WTW_MAX_DOFS];
  float dinv[WTW_MAX_DOFS];      // 1 / L_kk
  float z[WTW_MAX_DOFS];         // L^T z = rhs
  float un[WTW_MAX_DOFS];        // L un = z
  // one chunk of contact candidates, one per lane
  float cr[DYN_LANES][3];        // sphere centre - base_pos
  float cn[DYN_LANES][3];        // contact normal
  float cfn0[DYN_LANES];         // elastic force
  float cct[DYN_LANES];          // friction damping
  union {
    struct {
      float ca[DYN_LANES][3];    // r x n
      float ccoef[DYN_LANES];    // normal minus friction damping
    };
    struct {
      float cf[DYN_LANES][3];    // realized force
      float cfp[DYN_LANES];      // realized normal force, clamped at 0
    };
  };
  int cbody[DYN_LANES];
  int cgrp[DYN_LANES];
  int tmask[2];                  // touching slots of even / odd chunks
  float gacc[WTW_N_GROUPS * 3 + 1];  // group sums, then total_fn
};
struct DynEnv : DynEnvCore {
  float pad[wtw_pad<DYN_ENVS>(sizeof(DynEnvCore) / 4)];
};
constexpr int DYN_STRIDE = sizeof(DynEnv) / 4;
// the envs, the robot model, then the table of lower-triangle entries
constexpr int DYN_SMEM = DYN_ENVS * sizeof(DynEnv) + sizeof(WtwModel)
                       + 4 * ((WTW_TRI + 1) / 2);

// Row-major lower triangle: entry e -> (r, c), c <= r.
WTW_FN void tri_rc(int e, int* r, int* c) {
  int k = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  if ((k + 1) * (k + 2) / 2 <= e) ++k;
  if (k * (k + 1) / 2 > e) --k;
  *r = k;
  *c = e - k * (k + 1) / 2;
}

// Index of entry (p, q) of a symmetric matrix in its row-major lower
// triangle.
WTW_FN int sym(int p, int q) {
  return p >= q ? p * (p + 1) / 2 + q : q * (q + 1) / 2 + p;
}

WTW_FN float dot6(const float* a, const float* b) {
  return dot3(a, b) + dot3(&a[3], &b[3]);
}

// Contact normal n and depth of candidate `cand` (sphere p = cand % P)
// against the ground (cand < P: the bilinear patch of its corner rows,
// depth along the analytic normal) or the ceiling; false when out of
// contact, where the candidate contributes exactly zero.
WTW_FN bool contact_geom(const WtwModel& m, const DynEnv* w, float inv_s,
                         int cand, float* n, float* depth) {
  const int P = m.P, p = cand % P;
  const float z = w->fkp[2 * P + p];
  if (cand >= P) {
    n[0] = 0.0f;
    n[1] = 0.0f;
    n[2] = -1.0f;
    *depth = z + m.sph_radius[p] - w->ceil[p];
    return *depth > 0.0f;
  }
  const float h00 = w->hc[p], h10 = w->hc[P + p];
  const float h01 = w->hc[2 * P + p], h11 = w->hc[3 * P + p];
  const float du = w->duv[p], dv = w->duv[P + p];
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

// Geometry and elastic/friction terms of candidate `cand` into slot s
// (r x n and coef only with `moment`); returns whether it touches.
WTW_FN bool contact_terms(const WtwModel& m, DynEnv* w, float inv_s,
                          int cand, int s, bool moment) {
  float n[3], depth;
  if (!contact_geom(m, w, inv_s, cand, n, &depth)) return false;
  const int P = m.P, p = cand % P, b = m.sph_body[p];
  const float rest = w->env[1], fric = w->env[0];
  const float c_n_imp = m.c_contact * (1.0f - rest) + m.dt * m.k_contact;
  const float f_cap = c_n_imp * m.v_maxdep;
  float r[3], vel[3];
  for (int k = 0; k < 3; ++k) r[k] = w->fkp[k * P + p] - w->st[k];
  cross3(w->V[b], r, vel);
  for (int k = 0; k < 3; ++k) vel[k] += w->V[b][3 + k];
  const float fn0 = fminf(fmaxf(m.k_contact * depth, 0.0f), f_cap);
  const float vn = dot3(vel, n);
  float vt[3];
  for (int k = 0; k < 3; ++k) vt[k] = vel[k] - vn * n[k];
  const float ct = fric * fn0 * rsqrtf(dot3(vt, vt) + m.vel_eps * m.vel_eps);
  for (int k = 0; k < 3; ++k) {
    w->cr[s][k] = r[k];
    w->cn[s][k] = n[k];
  }
  if (moment) {
    cross3(r, n, w->ca[s]);
    w->ccoef[s] = c_n_imp - ct;
  }
  w->cfn0[s] = fn0;
  w->cct[s] = ct;
  w->cbody[s] = b;
  w->cgrp[s] = m.sph_group[p];  // a ceiling copy keeps its group
  return true;
}

// Component k of slot s's contact sums: k < 21 entry (p, q), q <= p, of
// H = coef psi psi^T + ct [|r|^2 I - r r^T, [r]x; [r]x^T, I]; k >= 21 entry
// k - 21 of fn0 psi. psi = (r x n, n).
WTW_FN float contact_h(const DynEnv* w, int s, int k, int p, int q) {
  const float* a = w->ca[s];
  const float* n = w->cn[s];
  const float* r = w->cr[s];
  if (k >= 21) {
    const int i = k - 21;
    return w->cfn0[s] * (i < 3 ? a[i] : n[i - 3]);
  }
  const float psp = p < 3 ? a[p] : n[p - 3];
  const float psq = q < 3 ? a[q] : n[q - 3];
  float f;
  if (p < 3) {                      // both angular
    f = (p == q ? dot3(r, r) : 0.0f) - r[p] * r[q];
  } else if (q < 3) {               // row linear p - 3, column angular q:
    const int i = p - 3;            // ([r]x)^T = -[r]x, entry (i, q)
    f = i == q ? 0.0f : (q == (i + 1) % 3 ? r[(i + 2) % 3] : -r[(i + 1) % 3]);
  } else {
    f = p == q ? 1.0f : 0.0f;
  }
  return w->ccoef[s] * psp * psq + w->cct[s] * f;
}

// Body b: pose from kernel A, rotation, compact spatial inertia (I_o,
// h = m c, m) about base_pos with the payload and CoM offset on the base.
WTW_FN void body_setup(const WtwModel& m, DynEnv* w, int b) {
  const int nb = m.nb;
  const float* p0 = w->st;
  float* g = w->G[b];
  float q[4], c[3], t[3];
  for (int k = 0; k < 3; ++k) w->bpos[b][k] = w->fkb[b * 3 + k];
  for (int k = 0; k < 4; ++k) q[k] = w->fkb[nb * 3 + b * 4 + k];
  float* R = w->R[b];
  quat_to_R(q, R);
  mat_vec3(R, m.com[b], t);
  for (int k = 0; k < 3; ++k) c[k] = w->bpos[b][k] + t[k] - p0[k];
  if (b == 0) {
    mat_vec3(R, &w->env[3], t);
    for (int k = 0; k < 3; ++k) c[k] += t[k];
  }
  const float mass = m.mass[b] + (b == 0 ? w->env[2] : 0.0f);
  float RI[9];  // R Ic, then (R Ic) R^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      RI[3 * i + j] = R[3 * i] * m.inertia[b][j]
                    + R[3 * i + 1] * m.inertia[b][3 + j]
                    + R[3 * i + 2] * m.inertia[b][6 + j];
  const float c2 = dot3(c, c);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float iw = RI[3 * i] * R[3 * j] + RI[3 * i + 1] * R[3 * j + 1]
                     + RI[3 * i + 2] * R[3 * j + 2];
      g[G_IO + 3 * i + j] = iw + mass * ((i == j ? c2 : 0.0f) - c[i] * c[j]);
    }
  for (int k = 0; k < 3; ++k) g[G_HV + k] = mass * c[k];
  g[G_MS] = mass;
}

// Dof i's spatial axis S_i = (sw, sv) about base_pos.
WTW_FN void dof_axis(const WtwModel& m, DynEnv* w, int i) {
  const int nb = m.nb, nj = m.nj;
  if (i < 6) {
    for (int k = 0; k < 6; ++k) w->S[i][k] = (i == k) ? 1.0f : 0.0f;
    return;
  }
  const int j = i - 6;
  float r[3];
  for (int k = 0; k < 3; ++k) {
    w->S[i][k] = w->fkb[nb * 7 + nj * 3 + j * 3 + k];
    r[k] = w->fkb[nb * 7 + j * 3 + k] - w->st[k];
  }
  cross3(r, w->S[i], &w->S[i][3]);
}

// Body c (not the base): velocity and RNEA acceleration from its parent's.
WTW_FN void forward_body(const WtwModel& m, DynEnv* w, const float* u, int c) {
  const int j = c - 1, p = m.parent[c];
  const float* Sj = w->S[6 + j];
  float* V = w->V[c];
  for (int k = 0; k < 6; ++k) V[k] = w->V[p][k] + u[6 + j] * Sj[k];
  float sw[3], sv[3], cw[3], cv[3], t[3];
  for (int k = 0; k < 3; ++k) {
    sw[k] = u[6 + j] * Sj[k];
    sv[k] = u[6 + j] * Sj[3 + k];
  }
  cross3(V, sw, cw);
  cross3(V, sv, cv);
  cross3(&V[3], sw, t);
  for (int k = 0; k < 3; ++k) {
    w->acc[c][k] = w->acc[p][k] + cw[k];
    w->acc[c][3 + k] = w->acc[p][3 + k] + cv[k] + t[k];
  }
}

// Body b's own bias force f_b = I_b a_b + V_b x* (I_b V_b) and momentum
// I_b V_b.
WTW_FN void body_force(DynEnv* w, int b) {
  float* g = w->G[b];
  const float* acc = w->acc[b];
  const float* V = w->V[b];
  const float* hv = &g[G_HV];
  const float ms = g[G_MS];
  float t1[3], f1[3], tV[3], fV[3], x[3], y[3];
  mat_vec3(&g[G_IO], acc, t1);
  cross3(hv, &acc[3], x);
  cross3(acc, hv, y);
  for (int k = 0; k < 3; ++k) {
    t1[k] += x[k];
    f1[k] = ms * acc[3 + k] + y[k];
  }
  mat_vec3(&g[G_IO], V, tV);
  cross3(hv, &V[3], x);
  cross3(V, hv, y);
  for (int k = 0; k < 3; ++k) {
    tV[k] += x[k];
    fV[k] = ms * V[3 + k] + y[k];
    g[G_PM + k] = tV[k];
    g[G_PM + 3 + k] = fV[k];
  }
  cross3(V, tV, x);
  cross3(&V[3], fV, y);
  for (int k = 0; k < 3; ++k) g[G_F + k] = t1[k] + x[k] + y[k];
  cross3(V, fV, x);
  for (int k = 0; k < 3; ++k) g[G_F + 3 + k] = f1[k] + x[k];
}

// Joint j's composite force of its axis, I_c S_j, into acc[j+1], and the
// contact sums' K S_j into KS[j+1].
WTW_FN void joint_axis_forces(DynEnv* w, int j) {
  const int b = j + 1;
  const float* g = w->G[b];
  const float* Sj = w->S[6 + j];
  const float* sw = Sj;
  const float* sv = &Sj[3];
  float Fw[3], Fv[3], x[3];
  mat_vec3(&g[G_IO], sw, Fw);
  cross3(&g[G_HV], sv, x);
  for (int k = 0; k < 3; ++k) Fw[k] += x[k];
  cross3(sw, &g[G_HV], x);
  for (int k = 0; k < 3; ++k) Fv[k] = g[G_MS] * sv[k] + x[k];
  for (int k = 0; k < 3; ++k) {
    w->acc[b][k] = Fw[k];
    w->acc[b][3 + k] = Fv[k];
  }
  for (int p = 0; p < 6; ++p) {
    float s = 0.0f;
    for (int q = 0; q < 6; ++q) s += w->K[b][sym(p, q)] * Sj[q];
    w->KS[b][p] = s;
  }
}

// Entry (r, c) of the 6x6 base block of the mass matrix.
WTW_FN float base_block(const DynEnv* w, int r, int c) {
  const float* g = w->G[0];
  if (r < 3 && c < 3) return g[G_IO + 3 * r + c];
  if (r >= 3 && c >= 3) return r == c ? g[G_MS] : 0.0f;
  // the skew of h: (angular row a, linear column l), symmetric across
  const int a = r < 3 ? r : c, l = (r < 3 ? c : r) - 3;
  const float* h = &g[G_HV];
  return a == l ? 0.0f : (l == (a + 1) % 3 ? -h[(a + 2) % 3] : h[(a + 1) % 3]);
}

// Dof k's ancestor dofs that take part in the solve: the list anc[0 .. n),
// ascending (the base dofs form a chain, and a fixed base's are left out).
WTW_FN const int* dof_ancestors(const WtwModel& m, int k, int* n) {
  if (k < 6) {
    *n = k;  // a floating base only
    return m.anc_dofs[0];
  }
  *n = m.n_anc[k - 5] - 1 - m.lo;
  return m.anc_dofs[k - 5] + m.lo;
}

// x = t * width + a for the few dofs of a level, without a division.
WTW_FN void split(int x, int width, int* t, int* a) {
  int q = 0;
  while (x >= width) {
    x -= width;
    ++q;
  }
  *t = q;
  *a = x;
}

// The longest ancestor list among the n dofs of the level at lvl_off o.
WTW_FN int level_width(const WtwModel& m, int o, int n) {
  int wmax = 0;
  for (int t = 0; t < n; ++t) {
    int na;
    dof_ancestors(m, m.lvl_body[o + t] + 5, &na);
    wmax = na > wmax ? na : wmax;
  }
  return wmax;
}

// The floating base's 6x6 block, leaves first as the tree (dof k's
// ancestors are dofs 0 .. k-1), with L^T z = rhs and then L un = z, by one
// lane in registers; the base's new velocity into acc[0].
WTW_FN void base_ltl_solve(DynEnv* w) {
  float L[6][6], z[6], x[6], d[6];
WTW_UNROLL
  for (int i = 0; i < 6; ++i) {
    z[i] = w->rhs[i];
WTW_UNROLL
    for (int j = 0; j <= i; ++j) L[i][j] = AM(i, j);
  }
WTW_UNROLL
  for (int k = 5; k >= 0; --k) {
    d[k] = rsqrtf(L[k][k]);
WTW_UNROLL
    for (int i = 0; i < k; ++i) L[k][i] *= d[k];
    z[k] *= d[k];
WTW_UNROLL
    for (int i = 0; i < k; ++i) {
WTW_UNROLL
      for (int j = 0; j <= i; ++j) L[i][j] -= L[k][i] * L[k][j];
      z[i] -= L[k][i] * z[k];
    }
  }
WTW_UNROLL
  for (int k = 0; k < 6; ++k) {
    float s = z[k];
WTW_UNROLL
    for (int i = 0; i < k; ++i) s -= L[k][i] * x[i];
    x[k] = s * d[k];
    w->un[k] = x[k];
    w->acc[0][k] = x[k];
  }
}

// One env's substep; every lane of the team calls it. Each team_phase ends
// with a sync of the team, and what one phase hands to the next is in *w.
// tri: the block's table of lower-triangle entries (r << 8 | c).
WTW_FN void dynamics_team(const WtwModel& m, DynEnv* w,
                          const unsigned short* tri, float inv_s,
                          bool has_ceil, int lane) {
  const int nb = m.nb, nj = m.nj, nv = m.nv, P = m.P, lo = m.lo;
  const float dt = m.dt;
  const float* u = w->st + 7 + nj;
  const int ncand = has_ceil ? 2 * P : P;

  // ---- bodies, dof axes, the base's velocity and acceleration ----
  team_phase<DYN_LANES>(lane, [&](int l) {
    for (int b = l; b < nb; b += DYN_LANES) body_setup(m, w, b);
    for (int i = l; i < nv; i += DYN_LANES) dof_axis(m, w, i);
    if (l < 6) {
      w->V[0][l] = u[l];
      w->acc[0][l] = l < 3 ? 0.0f : -(m.gravity[l - 3] + w->env[3 + l]);
    }
  });
  // ---- velocities and RNEA accelerations down the tree, level by level ----
  for (int lv = 1; lv < m.n_lvl; ++lv) {
    const int o = m.lvl_off[lv], n = m.lvl_off[lv + 1] - o;
    team_phase<DYN_LANES>(lane, [&](int l) {
      for (int x = l; x < n; x += DYN_LANES)
        forward_body(m, w, u, m.lvl_body[o + x]);
    });
  }
  // ---- each body's own bias force and momentum; contact sums cleared ----
  team_phase<DYN_LANES>(lane, [&](int l) {
    for (int b = l; b < nb; b += DYN_LANES) body_force(w, b);
    for (int x = l; x < nb * 27; x += DYN_LANES) w->K[x / 27][x % 27] = 0.0f;
    if (l == 0) w->tmask[0] = 0;
  });
  // ---- contacts, DYN_LANES candidates at a time: terms per candidate,
  //      then summed into each body's K, touching slots in order ----
  for (int c0 = 0, h = 0; c0 < ncand; c0 += DYN_LANES, h ^= 1) {
    team_phase<DYN_LANES>(lane, [&](int l) {
      if (c0 + l < ncand && contact_terms(m, w, inv_s, c0 + l, l, true))
        team_or(&w->tmask[h], 1 << l);
    });
    team_phase<DYN_LANES>(lane, [&](int k) {
      if (k == 0) w->tmask[h ^ 1] = 0;
      if (k >= 27) return;
      int p = 0, q = 0;
      if (k < 21) tri_rc(k, &p, &q);
      for (unsigned t = (unsigned)w->tmask[h]; t; t &= t - 1) {
        const int s = lowest_bit(t);
        w->K[w->cbody[s]][k] += contact_h(w, s, k, p, q);
      }
    });
  }
  // ---- subtree sums up the tree: lanes over (parent, component),
  //      children in level order ----
  for (int lv = m.n_lvl - 1; lv > 0; --lv) {
    const int o = m.lvl_off[lv - 1], n = m.lvl_off[lv] - o;
    team_phase<DYN_LANES>(lane, [&](int l) {
      for (int x = l; x < n * NSUB; x += DYN_LANES) {
        const int p = m.lvl_body[o + x / NSUB], k = x % NSUB;
        const int c0 = m.child_off[p], nc = m.n_child[p];
        float* base = k < G_N ? &w->G[0][k] : &w->K[0][k - G_N];
        const int stride = k < G_N ? G_N : 27;
        float s = base[p * stride];
        for (int c = 0; c < nc; ++c) s += base[m.lvl_body[c0 + c] * stride];
        base[p * stride] = s;
      }
    });
  }
  // ---- rhs = M u + dt (tau - C) + dt S^T (sum of fn0 psi); each joint
  //      axis's composite force I_c S_j and contact K S_j ----
  team_phase<DYN_LANES>(lane, [&](int l) {
    for (int i = l; i < nv; i += DYN_LANES) {
      float C, Mu, Cn;
      if (i < 6) {
        C = w->G[0][G_F + i];
        Mu = w->G[0][G_PM + i];
        Cn = w->K[0][21 + i];
      } else {
        const int b = i - 5;
        C = dot6(w->S[i], &w->G[b][G_F]);
        Mu = dot6(w->S[i], &w->G[b][G_PM]) + m.armature * u[i];
        Cn = dot6(w->S[i], &w->K[b][21]);
      }
      const float tau = i >= 6 ? w->st[7 + nj + nv + (i - 6)] : 0.0f;
      w->rhs[i] = Mu + dt * (tau - C) + dt * Cn;
      if (i < lo) w->un[i] = 0.0f;
    }
    for (int j = l; j < nj; j += DYN_LANES) joint_axis_forces(w, j);
    for (int x = l; x < WTW_N_GROUPS * 3 + 1; x += DYN_LANES) w->gacc[x] = 0.0f;
  });
  // ---- the system's lower triangle: M (CRBA) + armature + dt damping on
  //      the joint diagonal + dt S_c^T K S_r from the contacts ----
  team_phase<DYN_LANES>(lane, [&](int l) {
    for (int x = l; x < nv * (nv + 1) / 2; x += DYN_LANES) {
      const int r = tri[x] >> 8, c = tri[x] & 255;
      float val;
      if (r < 6) {
        val = base_block(w, r, c) + dt * w->K[0][sym(r, c)];
      } else if ((m.anc_mask[r - 5] >> c) & 1) {
        const int b = r - 5;
        val = dot6(w->S[c], w->acc[b]) + dt * dot6(w->S[c], w->KS[b]);
        if (c == r) val += m.armature + dt * m.joint_damping[r - 6];
      } else {
        val = 0.0f;
      }
      AM(r, c) = val;
    }
  });

  // ---- A = L^T L, leaves first, a tree level at a time, with L^T z = rhs
  //      fused in. The dofs of one level share no ancestor but the base's
  //      (checked when the model is built), so each lane owns the rows it
  //      updates; the base block and base rhs rows sum over the level's
  //      dofs in level order. Row k is read as it stands in its level's
  //      phase and scaled to L in the next phase, once nothing reads it ----
  const int nbase = lo == 0 ? 6 : 0;     // base dofs in an ancestor list
  for (int lv = m.n_lvl - 1; lv >= 0; --lv) {
    team_phase<DYN_LANES>(lane, [&](int l) {
      // scale the rows of the level below (phase lv + 1 read them): lanes
      // over (dof, ancestor)
      if (lv + 1 < m.n_lvl) {
        const int o1 = m.lvl_off[lv + 1], n1 = m.lvl_off[lv + 2] - o1;
        const int w1 = level_width(m, o1, n1);
        for (int x = l; x < n1 * w1; x += DYN_LANES) {
          int t, a;
          split(x, w1, &t, &a);
          const int k = m.lvl_body[o1 + t] + 5;
          int na;
          const int* anc = dof_ancestors(m, k, &na);
          if (a < na) AM(k, anc[a]) *= w->dinv[k];
        }
      }
      if (lv == 0) {
        if (l == 0 && lo == 0) base_ltl_solve(w);
        if (l < 6 && lo != 0) w->acc[0][l] = 0.0f;  // a fixed base
        return;
      }
      const int o = m.lvl_off[lv], n = m.lvl_off[lv + 1] - o;
      const int wa = level_width(m, o, n);   // widest ancestor list
      const int e0 = nbase * (nbase + 1) / 2;
      const int emax = wa * (wa + 1) / 2 - e0;
      // leg rows i > base of each dof's ancestors: A(i, j) -= L_ki L_kj
      for (int x = l; x < n * emax; x += DYN_LANES) {
        int t, e;
        split(x, emax, &t, &e);
        const int k = m.lvl_body[o + t] + 5;
        int na;
        const int* anc = dof_ancestors(m, k, &na);
        if (e0 + e >= na * (na + 1) / 2) continue;
        const float dk = rsqrtf(AM(k, k));
        const int i = anc[tri[e0 + e] >> 8], j = anc[tri[e0 + e] & 255];
        AM(i, j) -= (AM(k, i) * dk) * (AM(k, j) * dk);
      }
      // their rhs rows, and each dof's 1 / L_kk and z_k
      for (int x = l; x < n * (wa + 1); x += DYN_LANES) {
        int t, a;
        split(x, wa + 1, &t, &a);
        const int k = m.lvl_body[o + t] + 5;
        int na;
        const int* anc = dof_ancestors(m, k, &na);
        if (a > na) continue;
        const float dk = rsqrtf(AM(k, k));
        const float zk = w->rhs[k] * dk;
        if (a == na) {
          w->dinv[k] = dk;
          w->z[k] = zk;
        } else if (a >= nbase) {
          w->rhs[anc[a]] -= (AM(k, anc[a]) * dk) * zk;
        }
      }
      // the base block and base rhs rows, the level's dofs in order
      for (int x = l; x < (nbase ? 21 + 6 : 0); x += DYN_LANES) {
        const int i = x < 21 ? tri[x] >> 8 : x - 21;
        const int j = x < 21 ? tri[x] & 255 : 0;
        float s = 0.0f;
        for (int t = 0; t < n; ++t) {
          const int k = m.lvl_body[o + t] + 5;
          const float dk = rsqrtf(AM(k, k));
          s += x < 21 ? (AM(k, i) * dk) * (AM(k, j) * dk)
                      : (AM(k, i) * dk) * (w->rhs[k] * dk);
        }
        if (x < 21) AM(i, j) -= s;
        else w->rhs[i] -= s;
      }
    });
  }
  // ---- L un = z, ancestors first, level by level (lanes over a level's
  //      dofs; the base's were solved with its block); the bodies' new
  //      velocities into acc ----
  for (int lv = 1; lv < m.n_lvl; ++lv) {
    const int o = m.lvl_off[lv], n = m.lvl_off[lv + 1] - o;
    team_phase<DYN_LANES>(lane, [&](int l) {
      if (lv == 1 && l == 0) w->tmask[0] = 0;
      for (int x = l; x < n; x += DYN_LANES) {
        const int c = m.lvl_body[o + x], k = c + 5, p = m.parent[c];
        int na;
        const int* anc = dof_ancestors(m, k, &na);
        float s = w->z[k];
        for (int a = 0; a < na; ++a) s -= AM(k, anc[a]) * w->un[anc[a]];
        const float uk = s * w->dinv[k];
        w->un[k] = uk;
        for (int q = 0; q < 6; ++q) w->acc[c][q] = w->acc[p][q] + uk * w->S[k][q];
      }
    });
  }

  // ---- realized contact forces at the new velocities (diagnostics) ----
  const float c_n_imp = m.c_contact * (1.0f - w->env[1]) + dt * m.k_contact;
  for (int c0 = 0, h = 0; c0 < ncand; c0 += DYN_LANES, h ^= 1) {
    team_phase<DYN_LANES>(lane, [&](int l) {
      if (!(c0 + l < ncand && contact_terms(m, w, inv_s, c0 + l, l, false)))
        return;
      team_or(&w->tmask[h], 1 << l);
      const float* Vn = w->acc[w->cbody[l]];
      const float* n = w->cn[l];
      float cv[3];
      cross3(Vn, w->cr[l], cv);
      for (int k = 0; k < 3; ++k) cv[k] += Vn[3 + k];
      const float vn_new = dot3(cv, n);
      const float fn_lin = w->cfn0[l] - c_n_imp * vn_new;
      w->cfp[l] = fmaxf(fn_lin, 0.0f);
      for (int k = 0; k < 3; ++k)
        w->cf[l][k] = fn_lin * n[k] - w->cct[l] * (cv[k] - vn_new * n[k]);
    });
    team_phase<DYN_LANES>(lane, [&](int l) {
      if (l == 0) w->tmask[h ^ 1] = 0;
      for (int x = l; x < WTW_N_GROUPS * 3 + 1; x += DYN_LANES) {
        float s = w->gacc[x];
        for (unsigned t = (unsigned)w->tmask[h]; t; t &= t - 1) {
          const int q = lowest_bit(t);
          if (x == WTW_N_GROUPS * 3) s += w->cfp[q];
          else if (w->cgrp[q] == x / 3) s += w->cf[q][x % 3];
        }
        w->gacc[x] = s;
      }
    });
  }

  // ---- semi-implicit Euler, feet, contact sums into the output rows ----
  team_phase<DYN_LANES>(lane, [&](int l) {
    const float* un = w->un;
    const float* gacc = w->gacc;
    float* out = w->out;
    const int o_jq = 13, o_ff = 13 + 2 * nj, o_fp = o_ff + 12;
    const int o_fv = o_fp + 12, o_gn = o_fv + 12;
    for (int x = l; x < 1 + nj + 12 + 4 + 9 + 1; x += DYN_LANES) {
      if (x == 0) {
        const float* p0 = w->st;
        const float* q0 = w->st + 3;
        float dpos[3], wxd[3];
        for (int k = 0; k < 3; ++k) dpos[k] = dt * un[3 + k];
        cross3(un, dpos, wxd);
        for (int k = 0; k < 3; ++k) out[k] = p0[k] + dpos[k];
        const float theta = sqrtf(un[0] * un[0] + un[1] * un[1]
                                  + un[2] * un[2] + 1e-30f);
        const float half = 0.5f * dt * theta;
        const float kf = theta > 1e-9f ? sinf(half) / fmaxf(theta, 1e-9f)
                                       : 0.5f * dt;
        const float dq[4] = {un[0] * kf, un[1] * kf, un[2] * kf, cosf(half)};
        float qn[4];
        qmul(dq, q0, qn);
        const float inv = rsqrtf(qn[0] * qn[0] + qn[1] * qn[1]
                                 + qn[2] * qn[2] + qn[3] * qn[3]);
        for (int k = 0; k < 4; ++k) out[3 + k] = qn[k] * inv;
        for (int k = 0; k < 3; ++k) out[7 + k] = un[3 + k] + wxd[k];
        for (int k = 0; k < 3; ++k) out[10 + k] = un[k];
      } else if (x < 1 + nj) {
        const int j = x - 1;
        out[o_jq + j] = w->st[7 + j] + dt * un[6 + j];
        out[o_jq + nj + j] = un[6 + j];
      } else if (x < 1 + nj + 12) {
        const int y = x - 1 - nj;
        out[o_ff + y] = gacc[y];
      } else if (x < 1 + nj + 16) {
        const int f = x - 1 - nj - 12, fb = m.feet_body[f];
        float t[3], r[3];
        mat_vec3(w->R[fb], m.feet_pos[f], t);
        for (int k = 0; k < 3; ++k) {
          out[o_fp + 3 * f + k] = w->bpos[fb][k] + t[k];
          r[k] = out[o_fp + 3 * f + k] - w->st[k];
        }
        cross3(w->V[fb], r, t);
        for (int k = 0; k < 3; ++k) out[o_fv + 3 * f + k] = w->V[fb][3 + k] + t[k];
      } else if (x < 1 + nj + 25) {
        const int gk = 4 + x - 1 - nj - 16;
        out[o_gn + gk - 4] = sqrtf(dot3(&gacc[3 * gk], &gacc[3 * gk]) + 1e-30f);
      } else {
        out[o_gn + 9] = gacc[WTW_N_GROUPS * 3];
      }
    }
  });
}

#undef AM

// One block's staging (tid/nthr: this thread among the block's; the host
// passes 0/1; MAPPED: slots e0 .. through slot_env): the envs' input rows,
// the robot model, and the table of lower-triangle entries. Sizes come from
// the model in global memory.
template <bool MAPPED>
WTW_FN void dyn_stage(const WtwModel* __restrict__ m,
                      const float* __restrict__ st,
                      const float* __restrict__ fkb,
                      const float* __restrict__ fkp,
                      const float* __restrict__ hc,
                      const float* __restrict__ duv,
                      const float* __restrict__ ceil_h,
                      const float* __restrict__ env, DynEnv* sm,
                      WtwModel* msm, unsigned short* tri, int B, int e0,
                      int tid, int nthr, const int* __restrict__ slot_env) {
  float* base = (float*)sm;
  const int nb = m->nb, nj = m->nj, nv = m->nv, P = m->P;
#define STAGE(g, rows, field) \
  stage_rows<DYN_ENVS, MAPPED>(g, rows, B, e0, base, DYN_STRIDE, \
                               offsetof(DynEnvCore, field) / 4, tid, nthr, \
                               slot_env)
  STAGE(st, 7 + 2 * nj + nv, st);
  STAGE(fkb, nb * 7 + nj * 6, fkb);
  STAGE(fkp, 3 * P, fkp);
  STAGE(hc, 4 * P, hc);
  STAGE(duv, 2 * P, duv);
  if (ceil_h) STAGE(ceil_h, P, ceil);
  STAGE(env, 9, env);
#undef STAGE
  stage_model(m, msm, tid, nthr);
  for (int e = tid; e < WTW_TRI; e += nthr) {
    int r, c;
    tri_rc(e, &r, &c);
    tri[e] = (unsigned short)(r << 8 | c);
  }
}

WTW_FN int dyn_out_rows(const WtwModel& m) { return 13 + 2 * m.nj + 36 + 10; }

#ifdef __CUDACC__
// MAPPED: a mixed batch, m holds one model per robot and the block's slots
// go through slot_env / slot_robot
template <bool MAPPED>
__global__ void __launch_bounds__(DYN_LANES * DYN_ENVS)
wtw_dynamics_kernel(const WtwModel* __restrict__ m,
                    const int* __restrict__ slot_env,
                    const int* __restrict__ slot_robot,
                    const float* __restrict__ st, const float* __restrict__ fkb,
                    const float* __restrict__ fkp, const float* __restrict__ hc,
                    const float* __restrict__ duv,
                    const float* __restrict__ ceil_h,
                    const float* __restrict__ env, float inv_s,
                    float* __restrict__ out, int B) {
  extern __shared__ float4 wtw_dyn_smem[];
  DynEnv* sm = reinterpret_cast<DynEnv*>(wtw_dyn_smem);
  WtwModel* msm = reinterpret_cast<WtwModel*>(sm + DYN_ENVS);
  unsigned short* tri = reinterpret_cast<unsigned short*>(msm + 1);
  const int e0 = blockIdx.x * DYN_ENVS;
  if constexpr (MAPPED) m += slot_robot[e0];
  dyn_stage<MAPPED>(m, st, fkb, fkp, hc, duv, ceil_h, env, sm, msm, tri, B,
                    e0, threadIdx.x, blockDim.x, slot_env);
  stage_wait();
  __syncthreads();
  // every team runs every phase, also past the ragged edge (its inputs are
  // 0 there and its rows are not stored), but for an empty slot's
  // (slot_live); the block's barriers are outside the body
  if (slot_live<MAPPED>(slot_env, e0 + threadIdx.x / DYN_LANES))
    dynamics_team(*msm, &sm[threadIdx.x / DYN_LANES], tri, inv_s,
                  ceil_h != nullptr, threadIdx.x % DYN_LANES);
  __syncthreads();
  store_rows<DYN_ENVS, MAPPED>(out, dyn_out_rows(*msm), B, e0,
                               (const float*)sm, DYN_STRIDE,
                               offsetof(DynEnvCore, out) / 4, threadIdx.x,
                               blockDim.x, slot_env);
}

// Above 48 KB a block's shared memory must be asked for, once for each
// device the kernel runs on (the attribute holds for the current device).
#define DYN_MAX_DEVICES 64
template <bool MAPPED>
static int dyn_smem_attr() {
  static int rc[DYN_MAX_DEVICES];  // 0: not asked yet, else 1 + cudaError
  int d = 0;
  const cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return (int)e;
  if (d < 0 || d >= DYN_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (rc[d] == 0)
    rc[d] = 1 + (int)cudaFuncSetAttribute(
                    wtw_dynamics_kernel<MAPPED>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
  return rc[d] - 1;
}

// Launch on `stream`; returns a cudaError (0 = launched).
extern "C" int wtw_dynamics_launch(const void* m, const float* st,
                                   const float* fkb, const float* fkp,
                                   const float* hc, const float* duv,
                                   const float* ceil_h, const float* env,
                                   float inv_s, float* out, int B,
                                   void* stream) {
  const int rc = dyn_smem_attr<false>();
  if (rc != 0) return rc;
  const int blocks = (B + DYN_ENVS - 1) / DYN_ENVS;
  wtw_dynamics_kernel<false><<<blocks, DYN_LANES * DYN_ENVS, DYN_SMEM,
                               (cudaStream_t)stream>>>(
      (const WtwModel*)m, nullptr, nullptr, st, fkb, fkp, hc, duv, ceil_h,
      env, inv_s, out, B);
  return (int)cudaGetLastError();
}

// A mixed batch: models of R robots back to back, n_slots slots (a
// multiple of DYN_ENVS) of the slot table. Returns a cudaError.
extern "C" int wtw_dynamics_multi_launch(
    const void* m, const int* slot_env, const int* slot_robot, int n_slots,
    const float* st, const float* fkb, const float* fkp, const float* hc,
    const float* duv, const float* ceil_h, const float* env, float inv_s,
    float* out, int B, void* stream) {
  if (n_slots % DYN_ENVS) return (int)cudaErrorInvalidValue;
  const int rc = dyn_smem_attr<true>();
  if (rc != 0) return rc;
  wtw_dynamics_kernel<true><<<n_slots / DYN_ENVS, DYN_LANES * DYN_ENVS,
                              DYN_SMEM, (cudaStream_t)stream>>>(
      (const WtwModel*)m, slot_env, slot_robot, st, fkb, fkp, hc, duv,
      ceil_h, env, inv_s, out, B);
  return (int)cudaGetLastError();
}

// lanes per env, envs per block, shared bytes per block, resident blocks
// per SM; returns a cudaError (0 = ok)
template <bool MAPPED>
static int dyn_info(int* info) {
  info[0] = DYN_LANES;
  info[1] = DYN_ENVS;
  info[2] = DYN_SMEM;
  const int rc = dyn_smem_attr<MAPPED>();
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[3], wtw_dynamics_kernel<MAPPED>, DYN_LANES * DYN_ENVS, DYN_SMEM);
}
extern "C" int wtw_dynamics_info(int* info) { return dyn_info<false>(info); }
extern "C" int wtw_dynamics_multi_info(int* info) {
  return dyn_info<true>(info);
}
#else
#include <vector>

// Host build of the same body: blocks one after another, each team's lanes
// in turn (wtw_set_lane_order, in fk.cu, picks the order).
template <bool MAPPED>
static int dyn_host(const WtwModel* m, const int* slot_env,
                    const int* slot_robot, int n_slots, const float* st,
                    const float* fkb, const float* fkp, const float* hc,
                    const float* duv, const float* ceil_h, const float* env,
                    float inv_s, float* out, int B) {
  std::vector<DynEnv> sm(DYN_ENVS);
  WtwModel msm{};
  std::vector<unsigned short> tri(WTW_TRI);
  if (n_slots % DYN_ENVS) return 1;
  for (int e0 = 0; e0 < n_slots; e0 += DYN_ENVS) {
    // NaN everywhere first: a read of what no phase wrote shows
    for (DynEnv& w : sm)
      for (int i = 0; i < DYN_STRIDE; ++i) ((float*)&w)[i] = NAN;
    const WtwModel* mb = MAPPED ? m + slot_robot[e0] : m;
    dyn_stage<MAPPED>(mb, st, fkb, fkp, hc, duv, ceil_h, env, sm.data(),
                      &msm, tri.data(), B, e0, 0, 1, slot_env);
    for (int t = 0; t < DYN_ENVS; ++t)
      if (slot_live<MAPPED>(slot_env, e0 + t))
        dynamics_team(msm, &sm[t], tri.data(), inv_s, ceil_h != nullptr, 0);
    store_rows<DYN_ENVS, MAPPED>(out, dyn_out_rows(msm), B, e0,
                                 (const float*)sm.data(), DYN_STRIDE,
                                 offsetof(DynEnvCore, out) / 4, 0, 1,
                                 slot_env);
  }
  return 0;
}

extern "C" int wtw_dynamics_host(const void* m, const float* st,
                                 const float* fkb, const float* fkp,
                                 const float* hc, const float* duv,
                                 const float* ceil_h, const float* env,
                                 float inv_s, float* out, int B) {
  const int n = (B + DYN_ENVS - 1) / DYN_ENVS * DYN_ENVS;
  return dyn_host<false>((const WtwModel*)m, nullptr, nullptr, n, st, fkb,
                         fkp, hc, duv, ceil_h, env, inv_s, out, B);
}

extern "C" int wtw_dynamics_multi_host(
    const void* m, const int* slot_env, const int* slot_robot, int n_slots,
    const float* st, const float* fkb, const float* fkp, const float* hc,
    const float* duv, const float* ceil_h, const float* env, float inv_s,
    float* out, int B) {
  return dyn_host<true>((const WtwModel*)m, slot_env, slot_robot, n_slots,
                        st, fkb, fkp, hc, duv, ceil_h, env, inv_s, out, B);
}

extern "C" int wtw_dynamics_info(int* info) {
  info[0] = DYN_LANES;
  info[1] = DYN_ENVS;
  info[2] = DYN_SMEM;
  info[3] = 0;
  return 0;
}
extern "C" int wtw_dynamics_multi_info(int* info) {
  return wtw_dynamics_info(info);
}
#endif
