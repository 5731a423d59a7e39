// Native incremental replay engine (CPU deployment path).
//
// Fills the role the reference fills with its FBS-specialized C++ solver
// stack for incremental operation (CNonlinearSolver_FastL /
// CNonlinearSolver_Lambda driving CLinearSolver_UberBlock, reference
// include/slam/NonlinearSolver_FastL.h:2104-2427,
// include/slam/NonlinearSolver_Lambda.h:476-625) — but over OUR
// architecture, not the reference's: the factorization is the nested
// MIS-Schur level plan built by the Python symbolic phase
// (linalg/block_cholesky.py), maintained per solve point by delta
// propagation through the levels (the same math as
// linalg/incremental_cholesky.py's fused scan, executed as scalar C++
// loops — the XLA per-op dispatch tax inside the scans is what this
// engine removes on CPU; the GPU keeps the scan engine).
//
// Scope: SE(2) pose graphs and 2D landmark (range-bearing) graphs in f64 —
// the incremental acceptance workloads.  Everything else stays on the JAX
// engine.  Exact-math mirror of the JAX kernels (residuals, jacobians,
// omega scatter, delta refactorization, solve, push semantics) so the
// replay trajectory matches the f64 oracle to rounding.
//
// Build: make -C native  (g++ -O3, no external deps).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

typedef int64_t i64;
typedef uint8_t u8;

namespace {

thread_local const i64 *g_diag_pos0 = nullptr;

struct Level {
  i64 K, K_next, n, n_next, n_elim, Ku, T, Kc;
  const i64 *elim_diag_idx;  // [n_elim]
  const i64 *u_src;          // [Ku]
  const u8 *u_flip;          // [Ku]
  const i64 *u_elim;         // [Ku]
  const i64 *pa, *pb;        // [T]
  const u8 *p_flip;          // [T]
  const i64 *p_dst;          // [T]
  const i64 *carry_src, *carry_dst;  // [Kc]
  const i64 *elim_orig;      // [n_elim]
  const i64 *rest_orig;      // [n_next]
  const i64 *u_rest_next;    // [Ku]

  // derived maps
  std::vector<i64> elim_of_pair;   // [K] -> elim id or -1
  std::vector<i64> u_of_pair;      // [K] -> u id or -1
  std::vector<i64> carry_of_pair;  // [K] -> carry id or -1
  std::vector<i64> u_by_elim_start, u_by_elim;      // grouped u ids
  std::vector<i64> p_by_pa_start, p_by_pa;          // grouped prod ids
  std::vector<i64> p_by_psrc_start, p_by_psrc;      // prods by pb's u_src pair

  // numeric state
  std::vector<double> H;      // [K, BB]
  std::vector<double> Cinv;   // [n_elim, BB]
  std::vector<double> W;      // [Ku, BB]
  std::vector<double> P;      // [T, BB]

  // scratch dirty bookkeeping
  std::vector<i64> stampD, posD;       // [K]
  std::vector<i64> stampE, stampP;   // epoch stamps (W marks reuse stampE)
};

struct VType {
  i64 state_dim, tangent_dim, count, kind;  // kind: 0=pose2d, 1=landmark2d
  const i64 *cslot_of_local;                // [count]
  std::vector<double> states;               // [count, state_dim]
};

struct EType {
  i64 kind;   // 0 = edge_pose2d, 1 = edge_pose_landmark2d (range-bearing)
  i64 arity, E, mdim, n_contrib;
  std::vector<const i64 *> slot_local;   // arity x [E]
  std::vector<const i64 *> slot_cslot;   // arity x [E]
  std::vector<i64> slot_vtype;           // arity
  const double *z;                       // [E, mdim]
  const double *info;                    // [E, mdim*mdim]
  std::vector<const i64 *> pos;          // n_contrib x [E]  (level-0 pos)
  std::vector<const u8 *> swap;          // n_contrib x [E]
  std::vector<i64> contrib_a, contrib_b; // n_contrib
};

struct Engine {
  i64 B, BB, N, L;
  std::vector<Level> levels;
  // bottom
  i64 nb, KB;
  const i64 *bot_row, *bot_col;     // [KB] block coords in bottom numbering
  std::vector<double> bot_dense;    // [nb*B, nb*B]
  std::vector<double> bot_fact;     // Cholesky factor (lower)
  std::vector<double> Hb;           // bottom pattern blocks [KB, BB]
  std::vector<i64> bstampD, bposD;  // [KB]

  const double *p_mask;   // [N, B]
  i64 anchor_cslot;
  std::vector<u8> active;           // [N]
  std::vector<double> eta;          // [N, B]

  std::vector<VType> vtypes;
  std::vector<EType> etypes;

  // replay schedule
  i64 S;
  const i64 *st_etype, *st_li, *st_nactive;
  const u8 *st_closure;
  const u8 *st_newmask;   // [S, max_arity]
  i64 max_arity;

  // params
  i64 every_n, max_iter;
  double thresh;
  i64 onetime_dx;

  // level-0 position -> (pattern is level 0 itself)
  i64 epoch = 1;

  // per-solve dirty lists (reused)
  std::vector<std::vector<i64>> dirtyD;  // per level+bottom
  std::vector<std::vector<double>> deltaD;

  // stats
  i64 n_pushes = 0, n_full = 0, n_solves = 0, total_iters = 0;

  // reusable solve buffers (avoid per-solve allocation at 10k+ scale)
  std::vector<std::vector<double>> sv_etaE, sv_lvl;
};

// ---------- small-block helpers (B x B planar) ----------

static inline void mat_inv(const double *A, double *out, i64 B) {
  // Gauss-Jordan on a copy (B <= 6 in practice)
  double M[36], I[36];
  i64 BB = B * B;
  std::memcpy(M, A, sizeof(double) * BB);
  for (i64 i = 0; i < BB; i++) I[i] = 0;
  for (i64 i = 0; i < B; i++) I[i * B + i] = 1;
  for (i64 c = 0; c < B; c++) {
    i64 piv = c;
    double best = std::fabs(M[c * B + c]);
    for (i64 r = c + 1; r < B; r++) {
      double v = std::fabs(M[r * B + c]);
      if (v > best) { best = v; piv = r; }
    }
    if (piv != c) {
      for (i64 k = 0; k < B; k++) {
        std::swap(M[c * B + k], M[piv * B + k]);
        std::swap(I[c * B + k], I[piv * B + k]);
      }
    }
    double d = M[c * B + c];
    if (d == 0.0) d = 1e-300;
    double inv = 1.0 / d;
    for (i64 k = 0; k < B; k++) { M[c * B + k] *= inv; I[c * B + k] *= inv; }
    for (i64 r = 0; r < B; r++) {
      if (r == c) continue;
      double f = M[r * B + c];
      if (f == 0.0) continue;
      for (i64 k = 0; k < B; k++) {
        M[r * B + k] -= f * M[c * B + k];
        I[r * B + k] -= f * I[c * B + k];
      }
    }
  }
  std::memcpy(out, I, sizeof(double) * BB);
}

static inline void mat_mul(const double *A, const double *Bm, double *out,
                           i64 B) {
  for (i64 i = 0; i < B; i++)
    for (i64 j = 0; j < B; j++) {
      double s = 0;
      for (i64 k = 0; k < B; k++) s += A[i * B + k] * Bm[k * B + j];
      out[i * B + j] = s;
    }
}

static inline void mat_mul_bt(const double *A, const double *Bm, double *out,
                              i64 B) {  // A @ B^T
  for (i64 i = 0; i < B; i++)
    for (i64 j = 0; j < B; j++) {
      double s = 0;
      for (i64 k = 0; k < B; k++) s += A[i * B + k] * Bm[j * B + k];
      out[i * B + j] = s;
    }
}

static inline void mat_t(const double *A, double *out, i64 B) {
  for (i64 i = 0; i < B; i++)
    for (i64 j = 0; j < B; j++) out[j * B + i] = A[i * B + j];
}

static inline double wrap_angle(double a) {
  return std::atan2(std::sin(a), std::cos(a));
}

// ---------- edge kernels (exact mirrors of the JAX residual+jacfwd) -----

// pose2d binary edge: r = z - rel(x0, x1), angle wrapped.
// Returns chi2; fills g0,g1 [B] and H blocks for contribs (0,0),(0,1),(1,1)
static double edge_pose2d(const double *x0, const double *x1,
                          const double *z, const double *Wm, i64 B,
                          double *g0, double *g1, double *H00, double *H01,
                          double *H11) {
  double c0 = std::cos(x0[2]), s0 = std::sin(x0[2]);
  double dx = x1[0] - x0[0], dy = x1[1] - x0[1];
  double h1 = c0 * dx + s0 * dy;
  double h2 = -s0 * dx + c0 * dy;
  double h3 = wrap_angle(x1[2] - x0[2]);
  double r[3] = {z[0] - h1, z[1] - h2, wrap_angle(z[2] - h3)};
  // J = dr/ddelta = -dh/ddelta
  double J0[9] = {c0, s0, -h2, -s0, c0, h1, 0, 0, 1};
  double J1[9] = {-c0, -s0, 0, s0, -c0, 0, 0, 0, -1};
  double Wr[3], chi2 = 0;
  for (i64 i = 0; i < 3; i++) {
    Wr[i] = 0;
    for (i64 j = 0; j < 3; j++) Wr[i] += Wm[i * 3 + j] * r[j];
  }
  for (i64 i = 0; i < 3; i++) chi2 += r[i] * Wr[i];
  // g = -J^T W r ; H_ab = Ja^T W Jb   (m = 3 residual dims)
  double WJ0[9], WJ1[9];
  for (i64 i = 0; i < 3; i++)
    for (i64 j = 0; j < 3; j++) {
      double a = 0, b = 0;
      for (i64 k = 0; k < 3; k++) {
        a += Wm[i * 3 + k] * J0[k * 3 + j];
        b += Wm[i * 3 + k] * J1[k * 3 + j];
      }
      WJ0[i * 3 + j] = a;
      WJ1[i * 3 + j] = b;
    }
  for (i64 j = 0; j < 3; j++) {
    double a = 0, b = 0;
    for (i64 k = 0; k < 3; k++) {
      a += J0[k * 3 + j] * Wr[k];
      b += J1[k * 3 + j] * Wr[k];
    }
    g0[j] = -a;
    g1[j] = -b;
  }
  for (i64 i = 0; i < 3; i++)
    for (i64 j = 0; j < 3; j++) {
      double h00 = 0, h01 = 0, h11 = 0;
      for (i64 k = 0; k < 3; k++) {
        h00 += J0[k * 3 + i] * WJ0[k * 3 + j];
        h01 += J0[k * 3 + i] * WJ1[k * 3 + j];
        h11 += J1[k * 3 + i] * WJ1[k * 3 + j];
      }
      H00[i * B + j] = h00;
      H01[i * B + j] = h01;
      H11[i * B + j] = h11;
    }
  return chi2;
}

// range-bearing pose-landmark edge (landmark tangent 2, padded to B)
static double edge_rb(const double *pose, const double *lm, const double *z,
                      const double *Wm, i64 B, double *g0, double *g1,
                      double *H00, double *H01, double *H11) {
  double de = lm[0] - pose[0], dn = lm[1] - pose[1];
  double q = de * de + dn * dn;
  double rng = std::sqrt(q);
  bool clamped = rng < 1e-5;
  if (clamped) rng = 1e-5;
  double brg = wrap_angle(std::atan2(dn, de) - pose[2]);
  double r[2] = {z[0] - rng, wrap_angle(z[1] - brg)};
  // jacobians of r (2 rows) wrt pose (3) and lm (2)
  double irng = clamped ? 0.0 : 1.0 / rng;
  double iq = (q < 1e-30) ? 0.0 : 1.0 / q;
  // d rng: [-de, -dn]/rng (pose xy), 0 (theta), [de, dn]/rng (lm)
  // d brg: [dn, -de]/q (pose xy), -1 (theta), [-dn, de]/q (lm)
  double Jp[6] = {de * irng, dn * irng, 0,     // r0 = z0 - rng
                  -dn * iq, de * iq, 1};       // r1 = z1 - brg
  double Jl[4] = {-de * irng, -dn * irng,
                  dn * iq, -de * iq};
  double Wr[2], chi2 = 0;
  for (i64 i = 0; i < 2; i++) {
    Wr[i] = 0;
    for (i64 j = 0; j < 2; j++) Wr[i] += Wm[i * 2 + j] * r[j];
  }
  for (i64 i = 0; i < 2; i++) chi2 += r[i] * Wr[i];
  double WJp[6], WJl[4];
  for (i64 i = 0; i < 2; i++) {
    for (i64 j = 0; j < 3; j++)
      WJp[i * 3 + j] = Wm[i * 2 + 0] * Jp[0 * 3 + j] +
                       Wm[i * 2 + 1] * Jp[1 * 3 + j];
    for (i64 j = 0; j < 2; j++)
      WJl[i * 2 + j] = Wm[i * 2 + 0] * Jl[0 * 2 + j] +
                       Wm[i * 2 + 1] * Jl[1 * 2 + j];
  }
  for (i64 j = 0; j < 3; j++)
    g0[j] = -(Jp[0 * 3 + j] * Wr[0] + Jp[1 * 3 + j] * Wr[1]);
  for (i64 j = 0; j < 2; j++)
    g1[j] = -(Jl[0 * 2 + j] * Wr[0] + Jl[1 * 2 + j] * Wr[1]);
  g1[2] = 0;
  std::memset(H00, 0, sizeof(double) * B * B);
  std::memset(H01, 0, sizeof(double) * B * B);
  std::memset(H11, 0, sizeof(double) * B * B);
  for (i64 i = 0; i < 3; i++)
    for (i64 j = 0; j < 3; j++)
      H00[i * B + j] = Jp[0 * 3 + i] * WJp[0 * 3 + j] +
                       Jp[1 * 3 + i] * WJp[1 * 3 + j];
  for (i64 i = 0; i < 3; i++)
    for (i64 j = 0; j < 2; j++)
      H01[i * B + j] = Jp[0 * 3 + i] * WJl[0 * 2 + j] +
                       Jp[1 * 3 + i] * WJl[1 * 2 + j];
  for (i64 i = 0; i < 2; i++)
    for (i64 j = 0; j < 2; j++)
      H11[i * B + j] = Jl[0 * 2 + i] * WJl[0 * 2 + j] +
                       Jl[1 * 2 + i] * WJl[1 * 2 + j];
  return chi2;
}

// ---------- engine internals ----------

static void build_maps(Engine *e) {
  for (auto &lv : e->levels) {
    lv.elim_of_pair.assign(lv.K, -1);
    for (i64 i = 0; i < lv.n_elim; i++) lv.elim_of_pair[lv.elim_diag_idx[i]] = i;
    lv.u_of_pair.assign(lv.K, -1);
    for (i64 i = 0; i < lv.Ku; i++) lv.u_of_pair[lv.u_src[i]] = i;
    lv.carry_of_pair.assign(lv.K, -1);
    for (i64 i = 0; i < lv.Kc; i++) lv.carry_of_pair[lv.carry_src[i]] = i;
    // u grouped by elim
    lv.u_by_elim_start.assign(lv.n_elim + 1, 0);
    for (i64 i = 0; i < lv.Ku; i++) lv.u_by_elim_start[lv.u_elim[i] + 1]++;
    for (i64 i = 0; i < lv.n_elim; i++)
      lv.u_by_elim_start[i + 1] += lv.u_by_elim_start[i];
    lv.u_by_elim.assign(lv.Ku, 0);
    {
      std::vector<i64> fill(lv.u_by_elim_start.begin(),
                            lv.u_by_elim_start.end() - 1);
      for (i64 i = 0; i < lv.Ku; i++) lv.u_by_elim[fill[lv.u_elim[i]]++] = i;
    }
    // prods by pa (index into W/u ids)
    lv.p_by_pa_start.assign(lv.Ku + 1, 0);
    for (i64 i = 0; i < lv.T; i++) lv.p_by_pa_start[lv.pa[i] + 1]++;
    for (i64 i = 0; i < lv.Ku; i++) lv.p_by_pa_start[i + 1] += lv.p_by_pa_start[i];
    lv.p_by_pa.assign(lv.T, 0);
    {
      std::vector<i64> fill(lv.p_by_pa_start.begin(),
                            lv.p_by_pa_start.end() - 1);
      for (i64 i = 0; i < lv.T; i++) lv.p_by_pa[fill[lv.pa[i]]++] = i;
    }
    // prods by pb
    lv.p_by_psrc_start.assign(lv.Ku + 1, 0);
    for (i64 i = 0; i < lv.T; i++) lv.p_by_psrc_start[lv.pb[i] + 1]++;
    for (i64 i = 0; i < lv.Ku; i++)
      lv.p_by_psrc_start[i + 1] += lv.p_by_psrc_start[i];
    lv.p_by_psrc.assign(lv.T, 0);
    {
      std::vector<i64> fill(lv.p_by_psrc_start.begin(),
                            lv.p_by_psrc_start.end() - 1);
      for (i64 i = 0; i < lv.T; i++) lv.p_by_psrc[fill[lv.pb[i]]++] = i;
    }
    lv.H.assign(lv.K * e->BB, 0.0);
    lv.Cinv.assign(lv.n_elim * e->BB, 0.0);
    lv.W.assign(lv.Ku * e->BB, 0.0);
    lv.P.assign(lv.T * e->BB, 0.0);
    lv.stampD.assign(lv.K, 0);
    lv.posD.assign(lv.K, 0);
  }
  e->bot_dense.assign((size_t)(e->nb * e->B) * (e->nb * e->B), 0.0);
  e->bot_fact = e->bot_dense;
  e->Hb.assign(e->KB * e->BB, 0.0);
  e->bstampD.assign(e->KB, 0);
  e->bposD.assign(e->KB, 0);
  e->dirtyD.resize(e->L + 1);
  e->deltaD.resize(e->L + 1);
}

// read U block for coupling u at level lv (flip handling)
static inline void get_U(const Level &lv, i64 u, i64 B, double *out) {
  const double *src = &lv.H[lv.u_src[u] * B * B];
  if (lv.u_flip[u]) mat_t(src, out, B);
  else std::memcpy(out, src, sizeof(double) * B * B);
}

static void bottom_refactor(Engine *e) {
  i64 n = e->nb * e->B;
  e->bot_fact = e->bot_dense;
  double *A = e->bot_fact.data();
  for (i64 c = 0; c < n; c++) {
    double d = A[c * n + c];
    for (i64 k = 0; k < c; k++) d -= A[c * n + k] * A[c * n + k];
    d = std::sqrt(std::max(d, 1e-300));
    A[c * n + c] = d;
    double inv = 1.0 / d;
    for (i64 r = c + 1; r < n; r++) {
      double s = A[r * n + c];
      for (i64 k = 0; k < c; k++) s -= A[r * n + k] * A[c * n + k];
      A[r * n + c] = s * inv;
    }
  }
}

static void bottom_solve(Engine *e, double *x /* [nb*B] */) {
  i64 n = e->nb * e->B;
  const double *Lf = e->bot_fact.data();
  for (i64 r = 0; r < n; r++) {
    double s = x[r];
    for (i64 k = 0; k < r; k++) s -= Lf[r * n + k] * x[k];
    x[r] = s / Lf[r * n + r];
  }
  for (i64 r = n - 1; r >= 0; r--) {
    double s = x[r];
    for (i64 k = r + 1; k < n; k++) s -= Lf[k * n + r] * x[k];
    x[r] = s / Lf[r * n + r];
  }
}

// full refactor: recompute Cinv/W/P and all level H from level 0 downward
static void full_refactor(Engine *e) {
  i64 B = e->B, BB = e->BB;
  std::vector<double> U(BB), tmp(BB);
  for (i64 l = 0; l < e->L; l++) {
    Level &lv = e->levels[l];
    Level *nxt = (l + 1 < e->L) ? &e->levels[l + 1] : nullptr;
    double *Hn = nxt ? nxt->H.data() : e->Hb.data();
    i64 Kn = nxt ? nxt->K : e->KB;
    std::memset(Hn, 0, sizeof(double) * Kn * BB);
    for (i64 i = 0; i < lv.n_elim; i++)
      mat_inv(&lv.H[lv.elim_diag_idx[i] * BB], &lv.Cinv[i * BB], B);
    for (i64 u = 0; u < lv.Ku; u++) {
      get_U(lv, u, B, U.data());
      mat_mul(U.data(), &lv.Cinv[lv.u_elim[u] * BB], &lv.W[u * BB], B);
    }
    for (i64 c = 0; c < lv.Kc; c++) {
      std::memcpy(&Hn[lv.carry_dst[c] * BB], &lv.H[lv.carry_src[c] * BB],
                  sizeof(double) * BB);
    }
    for (i64 p = 0; p < lv.T; p++) {
      get_U(lv, lv.pb[p], B, U.data());
      mat_mul_bt(&lv.W[lv.pa[p] * BB], U.data(), tmp.data(), B);
      if (lv.p_flip[p]) {
        double t2[36];
        mat_t(tmp.data(), t2, B);
        std::memcpy(tmp.data(), t2, sizeof(double) * BB);
      }
      std::memcpy(&lv.P[p * BB], tmp.data(), sizeof(double) * BB);
      double *dst = &Hn[lv.p_dst[p] * BB];
      for (i64 k = 0; k < BB; k++) dst[k] -= tmp[k];
    }
  }
  if (e->L == 0) {
    // bottom pattern IS level 0 input; Hb filled by caller
  }
  // dense bottom from Hb
  i64 n = e->nb * e->B;
  std::memset(e->bot_dense.data(), 0, sizeof(double) * n * n);
  for (i64 k = 0; k < e->KB; k++) {
    i64 br = e->bot_row[k], bc = e->bot_col[k];
    const double *blk = &e->Hb[k * BB];
    for (i64 i = 0; i < B; i++)
      for (i64 j = 0; j < B; j++) {
        e->bot_dense[(br * B + i) * n + bc * B + j] += blk[i * B + j];
        if (br != bc)
          e->bot_dense[(bc * B + j) * n + br * B + i] += blk[i * B + j];
      }
  }
  bottom_refactor(e);
}

// delta-propagated dirty refactor; dirtyD[0]/deltaD[0] hold the level-0
// dirty pairs and their (already applied to H) deltas
static void dirty_refactor(Engine *e) {
  i64 B = e->B, BB = e->BB;
  std::vector<double> U(BB), tmp(BB), t2(BB);
  e->epoch++;
  i64 ep = e->epoch;
  for (i64 l = 0; l < e->L; l++) {
    Level &lv = e->levels[l];
    auto &D = e->dirtyD[l];
    auto &dv = e->deltaD[l];
    auto &Dn = e->dirtyD[l + 1];
    auto &dn = e->deltaD[l + 1];
    Dn.clear();
    dn.clear();
    // stamp the dirty pairs for this epoch
    for (size_t i = 0; i < D.size(); i++) {
      lv.stampD[D[i]] = ep;
      lv.posD[D[i]] = (i64)i;
    }
    Level *nxt = (l + 1 < e->L) ? &e->levels[l + 1] : nullptr;
    double *Hn = nxt ? nxt->H.data() : e->Hb.data();
    auto push_next = [&](i64 pair, const double *delta) {
      // accumulate delta into next-level dirty list + apply to Hn
      std::vector<i64> &stamp = nxt ? nxt->stampD : e->bstampD;
      std::vector<i64> &pos = nxt ? nxt->posD : e->bposD;
      if (stamp[pair] != ep) {
        stamp[pair] = ep;
        pos[pair] = (i64)Dn.size();
        Dn.push_back(pair);
        dn.resize(dn.size() + BB, 0.0);
      }
      double *acc = &dn[pos[pair] * BB];
      double *h = &Hn[pair * BB];
      for (i64 k = 0; k < BB; k++) {
        acc[k] += delta[k];
        h[k] += delta[k];
      }
    };
    // 1) dirty pivots
    std::vector<i64> Edirty;
    for (i64 pair : D) {
      i64 eid = lv.elim_of_pair[pair];
      if (eid >= 0) {
        mat_inv(&lv.H[pair * BB], &lv.Cinv[eid * BB], B);
        Edirty.push_back(eid);
      }
    }
    // 2) dirty W: u with dirty src, or dirty pivot
    //    collect uniquely with a small stamp on u
    if (lv.stampE.size() != (size_t)lv.Ku) lv.stampE.assign(lv.Ku, 0);
    std::vector<i64> Wdirty;
    auto mark_w = [&](i64 u) {
      if (lv.stampE[u] != ep) {
        lv.stampE[u] = ep;
        Wdirty.push_back(u);
      }
    };
    for (i64 pair : D) {
      i64 u = lv.u_of_pair[pair];
      if (u >= 0) mark_w(u);
    }
    for (i64 eid : Edirty)
      for (i64 t = lv.u_by_elim_start[eid]; t < lv.u_by_elim_start[eid + 1];
           t++)
        mark_w(lv.u_by_elim[t]);
    for (i64 u : Wdirty) {
      get_U(lv, u, B, U.data());
      mat_mul(U.data(), &lv.Cinv[lv.u_elim[u] * BB], &lv.W[u * BB], B);
    }
    // 3) dirty prods: pa in Wdirty, or pb's src pair dirty
    if (lv.stampP.size() != (size_t)lv.T) lv.stampP.assign(lv.T, 0);
    std::vector<i64> Pdirty;
    auto mark_p = [&](i64 p) {
      if (lv.stampP[p] != ep) {
        lv.stampP[p] = ep;
        Pdirty.push_back(p);
      }
    };
    for (i64 u : Wdirty)
      for (i64 t = lv.p_by_pa_start[u]; t < lv.p_by_pa_start[u + 1]; t++)
        mark_p(lv.p_by_pa[t]);
    for (i64 pair : D) {
      i64 u = lv.u_of_pair[pair];
      if (u >= 0)
        for (i64 t = lv.p_by_psrc_start[u]; t < lv.p_by_psrc_start[u + 1];
             t++)
          mark_p(lv.p_by_psrc[t]);
    }
    // 4) carries of dirty pairs -> next level deltas
    for (size_t i = 0; i < D.size(); i++) {
      i64 c = lv.carry_of_pair[D[i]];
      if (c >= 0) push_next(lv.carry_dst[c], &dv[i * BB]);
    }
    // 5) recompute dirty prods; delta = -(new - old) into dst
    for (i64 p : Pdirty) {
      get_U(lv, lv.pb[p], B, U.data());
      mat_mul_bt(&lv.W[lv.pa[p] * BB], U.data(), tmp.data(), B);
      if (lv.p_flip[p]) {
        mat_t(tmp.data(), t2.data(), B);
        std::swap(tmp, t2);
      }
      double *old = &lv.P[p * BB];
      double delta[36];
      for (i64 k = 0; k < BB; k++) {
        delta[k] = old[k] - tmp[k];  // Hn -= (new-old)  ==  += (old-new)
        old[k] = tmp[k];
      }
      push_next(lv.p_dst[p], delta);
    }
  }
  // bottom: dirtyD[L] deltas are already applied to Hb by push_next;
  // mirror into the dense matrix and refactor
  {
    auto &D = e->dirtyD[e->L];
    auto &dv = e->deltaD[e->L];
    i64 n = e->nb * e->B;
    for (size_t i = 0; i < D.size(); i++) {
      i64 k = D[i];
      i64 br = e->bot_row[k], bc = e->bot_col[k];
      const double *delta = &dv[i * BB];
      for (i64 a = 0; a < B; a++)
        for (i64 b = 0; b < B; b++) {
          e->bot_dense[(br * B + a) * n + bc * B + b] += delta[a * B + b];
          if (br != bc)
            e->bot_dense[(bc * B + b) * n + br * B + a] += delta[a * B + b];
        }
    }
    bottom_refactor(e);
  }
}

// solve lambda dx = eta through the maintained factor
static void solve(Engine *e, std::vector<double> &dx) {
  i64 B = e->B, BB = e->BB;
  // descend
  if (e->sv_etaE.empty()) {
    e->sv_etaE.resize(e->L);
    e->sv_lvl.resize(e->L + 1);
  }
  auto &etaE = e->sv_etaE;
  std::vector<double> &cur0 = e->sv_lvl[0];
  cur0 = e->eta;
  for (i64 l = 0; l < e->L; l++) {
    Level &lv = e->levels[l];
    std::vector<double> &cur = e->sv_lvl[l];
    etaE[l].assign(lv.n_elim * B, 0.0);
    for (i64 i = 0; i < lv.n_elim; i++)
      std::memcpy(&etaE[l][i * B], &cur[lv.elim_orig[i] * B],
                  sizeof(double) * B);
    std::vector<double> &nxt = e->sv_lvl[l + 1];
    nxt.resize(lv.n_next * B);
    for (i64 i = 0; i < lv.n_next; i++)
      std::memcpy(&nxt[i * B], &cur[lv.rest_orig[i] * B], sizeof(double) * B);
    for (i64 u = 0; u < lv.Ku; u++) {
      const double *Wb = &lv.W[u * BB];
      const double *ee = &etaE[l][lv.u_elim[u] * B];
      double *dst = &nxt[lv.u_rest_next[u] * B];
      for (i64 i = 0; i < B; i++) {
        double s = 0;
        for (i64 j = 0; j < B; j++) s += Wb[i * B + j] * ee[j];
        dst[i] -= s;
      }
    }
  }
  // bottom (operate on the deepest level buffer)
  bottom_solve(e, e->sv_lvl[e->L].data());
  // ascend: x for level l+1 lives in sv_lvl[l+1]; rebuild into sv_lvl[l]
  static thread_local std::vector<double> xe;
  for (i64 l = e->L - 1; l >= 0; l--) {
    Level &lv = e->levels[l];
    std::vector<double> &cur = e->sv_lvl[l + 1];
    std::vector<double> up(lv.n * B, 0.0);
    for (i64 i = 0; i < lv.n_next; i++)
      std::memcpy(&up[lv.rest_orig[i] * B], &cur[i * B], sizeof(double) * B);
    xe.assign(lv.n_elim * B, 0.0);
    for (i64 i = 0; i < lv.n_elim; i++) {
      const double *Ci = &lv.Cinv[i * BB];
      const double *ee = &etaE[l][i * B];
      for (i64 a = 0; a < B; a++) {
        double s = 0;
        for (i64 b = 0; b < B; b++) s += Ci[a * B + b] * ee[b];
        xe[i * B + a] = s;
      }
    }
    for (i64 u = 0; u < lv.Ku; u++) {
      const double *Wb = &lv.W[u * BB];
      const double *xr = &cur[lv.u_rest_next[u] * B];
      double *dst = &xe[lv.u_elim[u] * B];
      for (i64 j = 0; j < B; j++) {
        double s = 0;
        for (i64 i = 0; i < B; i++) s += Wb[i * B + j] * xr[i];
        dst[j] -= s;
      }
    }
    for (i64 i = 0; i < lv.n_elim; i++)
      std::memcpy(&up[lv.elim_orig[i] * B], &xe[i * B], sizeof(double) * B);
    e->sv_lvl[l].swap(up);
  }
  dx = e->sv_lvl[0];
}

// apply one edge's omega contribution at current states into H0/eta,
// recording level-0 dirty deltas; optionally handle activation pivots
static double apply_edge(Engine *e, i64 et_id, i64 li, const u8 *new_mask,
                         bool record_dirty) {
  EType &et = e->etypes[et_id];
  i64 B = e->B, BB = e->BB;
  Level &lv0 = e->levels[0];   // wiring guarantees L >= 1
  auto &D0 = e->dirtyD[0];
  auto &dv0 = e->deltaD[0];
  double g[2][6];
  double Hc[3][36];
  const double *xs[2];
  for (i64 s = 0; s < et.arity; s++) {
    VType &vt = e->vtypes[et.slot_vtype[s]];
    xs[s] = &vt.states[et.slot_local[s][li] * vt.state_dim];
  }
  double chi2;
  if (et.kind == 0)
    chi2 = edge_pose2d(xs[0], xs[1], &et.z[li * et.mdim],
                       &et.info[li * et.mdim * et.mdim], B, g[0], g[1],
                       Hc[0], Hc[1], Hc[2]);
  else
    chi2 = edge_rb(xs[0], xs[1], &et.z[li * et.mdim],
                   &et.info[li * et.mdim * et.mdim], B, g[0], g[1], Hc[0],
                   Hc[1], Hc[2]);
  // activation pivot removal on diagonal contribs
  for (i64 ci = 0; ci < et.n_contrib; ci++) {
    i64 a = et.contrib_a[ci], b = et.contrib_b[ci];
    if (a == b && new_mask && new_mask[a]) {
      i64 cs = et.slot_cslot[a][li];
      for (i64 k = 0; k < B; k++)
        Hc[ci][k * B + k] -= e->p_mask[cs * B + k];
    }
  }
  // scatter into H0 (+ dirty recording)
  i64 ep = e->epoch;
  for (i64 ci = 0; ci < et.n_contrib; ci++) {
    i64 pos = et.pos[ci][li];
    double blk[36];
    if (et.swap[ci][li]) mat_t(Hc[ci], blk, B);
    else std::memcpy(blk, Hc[ci], sizeof(double) * BB);
    double *h = &lv0.H[pos * BB];
    for (i64 k = 0; k < BB; k++) h[k] += blk[k];
    if (record_dirty) {
      if (lv0.stampD[pos] != ep) {
        lv0.stampD[pos] = ep;
        lv0.posD[pos] = (i64)D0.size();
        D0.push_back(pos);
        dv0.resize(dv0.size() + BB, 0.0);
      }
      double *acc = &dv0[lv0.posD[pos] * BB];
      for (i64 k = 0; k < BB; k++) acc[k] += blk[k];
    }
  }
  for (i64 s = 0; s < et.arity; s++) {
    i64 cs = et.slot_cslot[s][li];
    for (i64 k = 0; k < B; k++) e->eta[cs * B + k] += g[s][k];
  }
  return chi2;
}

static void rebuild_lambda(Engine *e, const std::vector<i64> &counts) {
  // H0 = unit pivots (inactive + pads) + anchor + all arrived edges
  i64 B = e->B, BB = e->BB;
  Level &lv0 = e->levels[0];
  std::memset(lv0.H.data(), 0, sizeof(double) * lv0.K * BB);
  std::fill(e->eta.begin(), e->eta.end(), 0.0);
  for (i64 cs = 0; cs < e->N; cs++) {
    double *h = &lv0.H[g_diag_pos0[cs] * BB];
    for (i64 k = 0; k < B; k++) {
      double unit = e->active[cs] ? (1.0 - e->p_mask[cs * B + k]) : 1.0;
      h[k * B + k] += unit;
    }
  }
  if (e->anchor_cslot >= 0) {
    double *h = &lv0.H[g_diag_pos0[e->anchor_cslot] * BB];
    for (i64 k = 0; k < B; k++)
      h[k * B + k] += e->p_mask[e->anchor_cslot * B + k];
  }
  for (size_t t = 0; t < e->etypes.size(); t++)
    for (i64 li = 0; li < counts[t]; li++)
      apply_edge(e, (i64)t, li, nullptr, false);
}

static double chi2_all(Engine *e, const std::vector<i64> &counts) {
  double g0[6], g1[6], Hc[3][36];
  double total = 0;
  i64 B = e->B;
  for (size_t t = 0; t < e->etypes.size(); t++) {
    EType &et = e->etypes[t];
    for (i64 li = 0; li < counts[t]; li++) {
      const double *xs[2];
      for (i64 s = 0; s < et.arity; s++) {
        VType &vt = e->vtypes[et.slot_vtype[s]];
        xs[s] = &vt.states[et.slot_local[s][li] * vt.state_dim];
      }
      if (et.kind == 0)
        total += edge_pose2d(xs[0], xs[1], &et.z[li * et.mdim],
                             &et.info[li * et.mdim * et.mdim], B, g0, g1,
                             Hc[0], Hc[1], Hc[2]);
      else
        total += edge_rb(xs[0], xs[1], &et.z[li * et.mdim],
                         &et.info[li * et.mdim * et.mdim], B, g0, g1,
                         Hc[0], Hc[1], Hc[2]);
    }
  }
  return total;
}

static void push_states(Engine *e, const std::vector<double> &dx) {
  i64 B = e->B;
  for (auto &vt : e->vtypes) {
    for (i64 i = 0; i < vt.count; i++) {
      i64 cs = vt.cslot_of_local[i];
      double *x = &vt.states[i * vt.state_dim];
      if (vt.kind == 0) {
        x[0] += dx[cs * B + 0];
        x[1] += dx[cs * B + 1];
        x[2] = wrap_angle(x[2] + dx[cs * B + 2]);
      } else {
        x[0] += dx[cs * B + 0];
        x[1] += dx[cs * B + 1];
      }
    }
  }
}

static void activate_vertex(Engine *e, i64 et_id, i64 li, i64 slot) {
  EType &et = e->etypes[et_id];
  VType &vt = e->vtypes[et.slot_vtype[slot]];
  i64 loc = et.slot_local[slot][li];
  double *x = &vt.states[loc * vt.state_dim];
  if (slot == 0) {
    for (i64 k = 0; k < vt.state_dim; k++) x[k] = 0.0;
    return;
  }
  VType &v0 = e->vtypes[et.slot_vtype[0]];
  const double *x0 = &v0.states[et.slot_local[0][li] * v0.state_dim];
  const double *z = &et.z[li * et.mdim];
  if (et.kind == 0) {  // pose2d compose
    double c = std::cos(x0[2]), s = std::sin(x0[2]);
    x[0] = x0[0] + c * z[0] - s * z[1];
    x[1] = x0[1] + s * z[0] + c * z[1];
    x[2] = wrap_angle(x0[2] + z[2]);
  } else {             // RB landmark init
    double ang = x0[2] + z[1];
    x[0] = x0[0] + z[0] * std::cos(ang);
    x[1] = x0[1] + z[0] * std::sin(ang);
  }
}

}  // namespace

// ------------------------- C API -------------------------

extern "C" {

void *spp_inc_create(i64 B, i64 N, i64 n_levels, const i64 *lvl_meta,
                     const i64 *elim_diag_idx, const i64 *u_src,
                     const u8 *u_flip, const i64 *u_elim, const i64 *pa,
                     const i64 *pb, const u8 *p_flip, const i64 *p_dst,
                     const i64 *carry_src, const i64 *carry_dst,
                     const i64 *elim_orig, const i64 *rest_orig,
                     const i64 *u_rest_next, i64 nb, i64 KB,
                     const i64 *bot_row, const i64 *bot_col,
                     const i64 *diag_pos0, const double *p_mask,
                     i64 anchor_cslot) {
  Engine *e = new Engine();
  e->B = B;
  e->BB = B * B;
  e->N = N;
  e->L = n_levels;
  e->levels.resize(n_levels);
  i64 o_ed = 0, o_u = 0, o_p = 0, o_c = 0, o_eo = 0, o_ro = 0;
  for (i64 l = 0; l < n_levels; l++) {
    Level &lv = e->levels[l];
    const i64 *m = &lvl_meta[l * 8];
    lv.K = m[0]; lv.K_next = m[1]; lv.n = m[2]; lv.n_next = m[3];
    lv.n_elim = m[4]; lv.Ku = m[5]; lv.T = m[6]; lv.Kc = m[7];
    lv.elim_diag_idx = elim_diag_idx + o_ed;
    lv.elim_orig = elim_orig + o_ed;
    o_ed += lv.n_elim;
    lv.u_src = u_src + o_u;
    lv.u_flip = u_flip + o_u;
    lv.u_elim = u_elim + o_u;
    lv.u_rest_next = u_rest_next + o_u;
    o_u += lv.Ku;
    lv.pa = pa + o_p;
    lv.pb = pb + o_p;
    lv.p_flip = p_flip + o_p;
    lv.p_dst = p_dst + o_p;
    o_p += lv.T;
    lv.carry_src = carry_src + o_c;
    lv.carry_dst = carry_dst + o_c;
    o_c += lv.Kc;
    lv.rest_orig = rest_orig + o_ro;
    o_ro += lv.n_next;
  }
  (void)o_eo;
  e->nb = nb;
  e->KB = KB;
  e->bot_row = bot_row;
  e->bot_col = bot_col;
  e->p_mask = p_mask;
  e->anchor_cslot = anchor_cslot;
  e->active.assign(N, 0);
  e->eta.assign(N * B, 0.0);
  g_diag_pos0 = diag_pos0;
  build_maps(e);
  return e;
}

void spp_inc_add_vtype(void *h, i64 kind, i64 state_dim, i64 tangent_dim,
                       i64 count, const i64 *cslot_of_local,
                       const double *init_states) {
  Engine *e = (Engine *)h;
  VType vt;
  vt.kind = kind;
  vt.state_dim = state_dim;
  vt.tangent_dim = tangent_dim;
  vt.count = count;
  vt.cslot_of_local = cslot_of_local;
  vt.states.assign(init_states, init_states + count * state_dim);
  e->vtypes.push_back(std::move(vt));
}

void spp_inc_add_etype(void *h, i64 kind, i64 arity, i64 E, i64 mdim,
                       i64 n_contrib, const i64 *slot_local,
                       const i64 *slot_cslot, const i64 *slot_vtype,
                       const double *z, const double *info, const i64 *pos,
                       const u8 *swap, const i64 *contrib_ab) {
  Engine *e = (Engine *)h;
  EType et;
  et.kind = kind;
  et.arity = arity;
  et.E = E;
  et.mdim = mdim;
  et.n_contrib = n_contrib;
  for (i64 s = 0; s < arity; s++) {
    et.slot_local.push_back(slot_local + s * E);
    et.slot_cslot.push_back(slot_cslot + s * E);
    et.slot_vtype.push_back(slot_vtype[s]);
  }
  et.z = z;
  et.info = info;
  for (i64 c = 0; c < n_contrib; c++) {
    et.pos.push_back(pos + c * E);
    et.swap.push_back(swap + c * E);
    et.contrib_a.push_back(contrib_ab[c * 2]);
    et.contrib_b.push_back(contrib_ab[c * 2 + 1]);
  }
  e->etypes.push_back(std::move(et));
}

void spp_inc_set_schedule(void *h, i64 S, const i64 *st_etype,
                          const i64 *st_li, const i64 *st_nactive,
                          const u8 *st_closure, const u8 *st_newmask,
                          i64 max_arity, i64 every_n, i64 max_iter,
                          double thresh, i64 onetime_dx) {
  Engine *e = (Engine *)h;
  e->S = S;
  e->st_etype = st_etype;
  e->st_li = st_li;
  e->st_nactive = st_nactive;
  e->st_closure = st_closure;
  e->st_newmask = st_newmask;
  e->max_arity = max_arity;
  e->every_n = every_n;
  e->max_iter = max_iter;
  e->thresh = thresh;
  e->onetime_dx = onetime_dx;
}

// runs the whole replay; returns final chi2; fills counters
double spp_inc_run(void *h, i64 *out_iters, i64 *out_pushes, i64 *out_full,
                   i64 *out_solves) {
  Engine *e = (Engine *)h;
  i64 B = e->B;
  std::vector<i64> counts(e->etypes.size(), 0);
  std::vector<std::pair<i64, i64>> pending;  // (etype, li)
  std::vector<const u8 *> pending_mask;
  bool outstanding = false;
  bool lin_dirty = true;
  bool factor_ready = false;
  i64 last_nap = 0;
  std::vector<double> dx;

  for (i64 si = 0; si < e->S; si++) {
    i64 t = e->st_etype[si], li = e->st_li[si];
    const u8 *nm = &e->st_newmask[si * e->max_arity];
    // activations (at arrival, like the JAX engine)
    for (i64 s = 0; s < e->etypes[t].arity; s++)
      if (nm[s]) {
        activate_vertex(e, t, li, s);
        e->active[e->etypes[t].slot_cslot[s][li]] = 1;
      }
    counts[t]++;
    outstanding = outstanding || e->st_closure[si];
    pending.push_back({t, li});
    pending_mask.push_back(nm);
    if (e->st_nactive[si] - last_nap < e->every_n) continue;
    last_nap = e->st_nactive[si];

    if (!factor_ready) {
      rebuild_lambda(e, counts);
      full_refactor(e);
      factor_ready = true;
      e->n_full++;
      pending.clear();
      pending_mask.clear();
    }
    if (!outstanding) continue;
    outstanding = false;

    if (!pending.empty()) {
      e->epoch++;
      e->dirtyD[0].clear();
      e->deltaD[0].clear();
      for (size_t k = 0; k < pending.size(); k++)
        apply_edge(e, pending[k].first, pending[k].second, pending_mask[k],
                   true);
      pending.clear();
      pending_mask.clear();
      dirty_refactor(e);
    }
    // iterate (reference Optimize semantics)
    for (i64 it = 0; it < e->max_iter; it++) {
      e->total_iters++;
      solve(e, dx);
      double norm2 = 0;
      bool finite = true;
      for (double v : dx) {
        norm2 += v * v;
        if (!std::isfinite(v)) finite = false;
      }
      double norm = std::sqrt(norm2);
      if (!finite || norm > 1e5 || norm <= e->thresh) {
        lin_dirty = true;
        break;
      }
      push_states(e, dx);
      e->n_pushes++;
      lin_dirty = false;
      rebuild_lambda(e, counts);
      full_refactor(e);
      e->n_full++;
    }
    e->n_solves++;
  }

  if (!pending.empty() && factor_ready) {
    e->epoch++;
    e->dirtyD[0].clear();
    e->deltaD[0].clear();
    for (size_t k = 0; k < pending.size(); k++)
      apply_edge(e, pending[k].first, pending[k].second, pending_mask[k],
                 true);
    pending.clear();
    pending_mask.clear();
    dirty_refactor(e);
    lin_dirty = true;
  }
  if (factor_ready && lin_dirty && e->onetime_dx) {
    solve(e, dx);
    bool finite = true;
    for (double v : dx)
      if (!std::isfinite(v)) finite = false;
    if (finite) push_states(e, dx);
  }
  *out_iters = e->total_iters;
  *out_pushes = e->n_pushes;
  *out_full = e->n_full;
  *out_solves = e->n_solves;
  return chi2_all(e, counts);
}

void spp_inc_get_states(void *h, i64 vt_id, double *out) {
  Engine *e = (Engine *)h;
  VType &vt = e->vtypes[vt_id];
  std::memcpy(out, vt.states.data(),
              sizeof(double) * vt.count * vt.state_dim);
}

void spp_inc_destroy(void *h) { delete (Engine *)h; }

}  // extern "C"
