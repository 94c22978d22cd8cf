// Batched IMU preintegration (mean + 15x15 covariance + bias Jacobians +
// whitening factor), sequential per-sample — the host-side runtime component
// feeding BA factor assembly.
//
// Behavioral reference: rdvio_estimation/src/
// preintegrator.cpp:22-100 (increment / integrate / sqrt_inv_cov), with the
// error-state ordering ES_Q=0, ES_P=3, ES_V=6, ES_BG=9, ES_BA=12
// (estimation/state.h:11-18). Semantics mirror rd_vio_tpu/ops/preintegration.py
// integrate_sequential step for step (same small-angle guards as ops/lie.py).
//
// Why native: per-frame problem assembly needs a handful of short (~10-400
// sample) f64 integrations. On-device they serialize tiny f64-emulated ops
// (~60 ms per batch on TPU v5e through XLA); here the whole batch is ~100 us.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int ES_Q = 0, ES_P = 3, ES_V = 6, ES_BG = 9, ES_BA = 12;

// ---- small dense helpers (row-major) ------------------------------------

inline void mat3_mul(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A[i * 3 + k] * B[k * 3 + j];
      C[i * 3 + j] = s;
    }
}

inline void hat3(const double* w, double* W) {
  W[0] = 0;      W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];   W[4] = 0;     W[5] = -w[0];
  W[6] = -w[1];  W[7] = w[0];  W[8] = 0;
}

// Hamilton product, wxyz
inline void quat_mul(const double* a, const double* b, double* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

inline void quat_normalize(double* q) {
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] /= n;
}

inline void quat_rotate(const double* q, const double* v, double* out) {
  // v + 2 w (qv x v) + 2 qv x (qv x v)
  const double* u = q + 1;
  double c1[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]};
  double t[3] = {2 * c1[0], 2 * c1[1], 2 * c1[2]};
  double c2[3] = {u[1] * t[2] - u[2] * t[1], u[2] * t[0] - u[0] * t[2],
                  u[0] * t[1] - u[1] * t[0]};
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + c2[i];
}

inline void quat_to_matrix(const double* q, double* R) {
  double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// matches ops/lie.py expmap (same Taylor guards + final normalize)
inline void expmap(const double* w, double* q) {
  double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double theta = std::sqrt(theta2 > 1e-12 ? theta2 : 1e-12);
  double half = 0.5 * theta;
  double sinc_half, cw;
  if (theta2 < 1e-10) {
    sinc_half = 0.5 - theta2 / 48.0;
    cw = 1.0 - theta2 / 8.0;
  } else {
    sinc_half = std::sin(half) / theta;
    cw = std::cos(half);
  }
  q[0] = cw;
  q[1] = sinc_half * w[0];
  q[2] = sinc_half * w[1];
  q[3] = sinc_half * w[2];
  quat_normalize(q);
}

// matches ops/lie.py right_jacobian
inline void right_jacobian(const double* w, double* J) {
  double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double theta = std::sqrt(theta2 > 1e-12 ? theta2 : 1e-12);
  double a, b;
  if (theta2 < 1e-10) {
    a = 0.5 - theta2 / 24.0;
    b = 1.0 / 6.0 - theta2 / 120.0;
  } else {
    a = (1.0 - std::cos(theta)) / theta2;
    b = (theta - std::sin(theta)) / (theta2 * theta);
  }
  double W[9], W2[9];
  hat3(w, W);
  mat3_mul(W, W, W2);
  for (int i = 0; i < 9; ++i) J[i] = -a * W[i] + b * W2[i];
  J[0] += 1.0; J[4] += 1.0; J[8] += 1.0;
}

// Cholesky (lower) of n x n SPD matrix in place of L; returns false on failure
inline bool cholesky(const double* M, double* L, int n) {
  std::memset(L, 0, sizeof(double) * n * n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
      if (i == j) {
        if (s <= 0) return false;
        L[i * n + i] = std::sqrt(s);
      } else {
        L[i * n + j] = s / L[j * n + j];
      }
    }
  }
  return true;
}

// inverse of lower-triangular L (n x n) into Li
inline void tri_inverse_lower(const double* L, double* Li, int n) {
  std::memset(Li, 0, sizeof(double) * n * n);
  for (int i = 0; i < n; ++i) {
    Li[i * n + i] = 1.0 / L[i * n + i];
    for (int j = 0; j < i; ++j) {
      double s = 0;
      for (int k = j; k < i; ++k) s += L[i * n + k] * Li[k * n + j];
      Li[i * n + j] = -s / L[i * n + i];
    }
  }
}

}  // namespace

extern "C" {

// Greedy Poisson-disk grid filter (reference util/poisson_disk_filter.h:
// 22-56 semantics, identical to ops/poisson_disk.poisson_disk_filter and
// its NumPy twin): points in priority order claim grid cells; a point
// within min_distance of an accepted point is rejected. preset_count
// leading points are inserted unconditionally.
// points (N, 2) f64; valid (N) u8; accepted (N) u8 out.
void rdvio_poisson_filter(
    long long N, const double* points, const unsigned char* valid,
    double min_distance, double width, double height,
    long long preset_count, unsigned char* accepted) {
  const double r = min_distance;
  const double cell = r / std::sqrt(2.0);
  const double r2 = r * r;
  int gx = (int)std::ceil(width / cell) + 4;
  int gy = (int)std::ceil(height / cell) + 4;
  std::vector<double> px(gx * gy, 1e30), py(gx * gy, 1e30);
  std::vector<unsigned char> occ(gx * gy, 0);
  for (long long i = 0; i < N; ++i) {
    accepted[i] = 0;
    if (!valid[i]) continue;
    double x = points[i * 2], y = points[i * 2 + 1];
    int cj = (int)(x / cell) + 2;
    int ci = (int)(y / cell) + 2;
    cj = cj < 2 ? 2 : (cj > gx - 3 ? gx - 3 : cj);
    ci = ci < 2 ? 2 : (ci > gy - 3 ? gy - 3 : ci);
    bool conflict = false;
    if (i >= preset_count) {
      for (int di = -2; di <= 2 && !conflict; ++di)
        for (int dj = -2; dj <= 2 && !conflict; ++dj) {
          int idx = (ci + di) * gx + (cj + dj);
          if (!occ[idx]) continue;
          double dx = px[idx] - x, dy = py[idx] - y;
          if (dx * dx + dy * dy < r2) conflict = true;
        }
    }
    if (!conflict) {
      int idx = ci * gx + cj;
      px[idx] = x; py[idx] = y; occ[idx] = 1;
      accepted[i] = 1;
    }
  }
}


// Mean-only integrate + gravity-aware predict (reference
// preintegrator.cpp:22-76 mean rows + :102-112 predict), one interval.
// dts (N); ws, accs (N, 3); bg, ba, p0, v0 (3); q0 (4) -> q, p, v out.
// Replaces the per-sample Python loop in ops/preintegration_np (the
// per-frame state prediction runs ~3x per frame on the host hot path).
void rdvio_predict_mean(
    long long N, const double* dts, const double* ws, const double* accs,
    const double* bg, const double* ba, const double* q0, const double* p0,
    const double* v0, double* q_out, double* p_out, double* v_out) {
  double t = 0.0;
  double dq[4] = {1, 0, 0, 0};
  double dp[3] = {0, 0, 0};
  double dv[3] = {0, 0, 0};
  for (long long i = 0; i < N; ++i) {
    double dt = dts[i];
    if (dt == 0.0) continue;
    double a[3] = {accs[i * 3] - ba[0], accs[i * 3 + 1] - ba[1],
                   accs[i * 3 + 2] - ba[2]};
    double qa[3];
    quat_rotate(dq, a, qa);
    for (int k = 0; k < 3; ++k) {
      dp[k] += dt * dv[k] + 0.5 * dt * dt * qa[k];
      dv[k] += dt * qa[k];
    }
    double wdt[3] = {(ws[i * 3] - bg[0]) * dt, (ws[i * 3 + 1] - bg[1]) * dt,
                     (ws[i * 3 + 2] - bg[2]) * dt};
    double eq[4], qn[4];
    expmap(wdt, eq);
    quat_mul(dq, eq, qn);
    quat_normalize(qn);
    for (int k = 0; k < 4; ++k) dq[k] = qn[k];
    t += dt;
  }
  const double g[3] = {0.0, 0.0, -9.80665};
  double rdv[3], rdp[3];
  quat_rotate(q0, dv, rdv);
  quat_rotate(q0, dp, rdp);
  for (int k = 0; k < 3; ++k) {
    v_out[k] = v0[k] + g[k] * t + rdv[k];
    p_out[k] = p0[k] + 0.5 * g[k] * t * t + v0[k] * t + rdp[k];
  }
  quat_mul(q0, dq, q_out);
  quat_normalize(q_out);
}


// All matrices row-major f64. Shapes:
//   dts (F, N); ws, accs (F, N, 3); bg, ba (F, 3); cov_* (3, 3)
//   t_out (F); q_out (F, 4); p_out, v_out (F, 3); cov_out (F, 15, 15)
//   dq_dbg..dv_dba (F, 3, 3); sic_out (F, 15, 15)
// Padded samples (dt == 0) are exact no-ops. Factors with total t == 0 get
// identity whitening (the assembler masks them out anyway).
void rdvio_preintegrate_batch(
    long long F, long long N,
    const double* dts, const double* ws, const double* accs,
    const double* bg_arr, const double* ba_arr,
    const double* cov_w, const double* cov_a,
    const double* cov_bg, const double* cov_ba,
    double* t_out, double* q_out, double* p_out, double* v_out,
    double* cov_out, double* dq_dbg_out, double* dp_dbg_out,
    double* dp_dba_out, double* dv_dbg_out, double* dv_dba_out,
    double* sic_out) {
  for (long long f = 0; f < F; ++f) {
    const double* bg = bg_arr + f * 3;
    const double* ba = ba_arr + f * 3;
    double t = 0.0;
    double q[4] = {1, 0, 0, 0};
    double p[3] = {0, 0, 0};
    double v[3] = {0, 0, 0};
    double cov9[81];
    std::memset(cov9, 0, sizeof(cov9));
    double cov_bg_acc[9] = {0}, cov_ba_acc[9] = {0};
    double dq_dbg[9] = {0}, dp_dbg[9] = {0}, dp_dba[9] = {0};
    double dv_dbg[9] = {0}, dv_dba[9] = {0};

    for (long long s = 0; s < N; ++s) {
      double dt = dts[f * N + s];
      if (dt == 0.0) continue;
      const double* w_raw = ws + (f * N + s) * 3;
      const double* a_raw = accs + (f * N + s) * 3;
      double w[3] = {w_raw[0] - bg[0], w_raw[1] - bg[1], w_raw[2] - bg[2]};
      double a[3] = {a_raw[0] - ba[0], a_raw[1] - ba[1], a_raw[2] - ba[2]};
      double wdt[3] = {w[0] * dt, w[1] * dt, w[2] * dt};

      double dq_inc[4];
      expmap(wdt, dq_inc);
      double R_inc[9], R_inc_T[9], Rk[9], hat_a[9], Rk_hat_a[9], Jr[9];
      quat_to_matrix(dq_inc, R_inc);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) R_inc_T[i * 3 + j] = R_inc[j * 3 + i];
      quat_to_matrix(q, Rk);
      hat3(a, hat_a);
      mat3_mul(Rk, hat_a, Rk_hat_a);
      right_jacobian(wdt, Jr);

      // --- covariance propagation: cov9 = A cov9 A^T + B Wn B^T ---
      double A[81];
      std::memset(A, 0, sizeof(A));
      for (int i = 0; i < 9; ++i) A[i * 9 + i] = 1.0;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          A[(ES_Q + i) * 9 + (ES_Q + j)] = R_inc_T[i * 3 + j];
          A[(ES_V + i) * 9 + (ES_Q + j)] = -dt * Rk_hat_a[i * 3 + j];
          A[(ES_P + i) * 9 + (ES_Q + j)] = -0.5 * dt * dt * Rk_hat_a[i * 3 + j];
        }
      for (int i = 0; i < 3; ++i) A[(ES_P + i) * 9 + (ES_V + i)] += dt;

      double B[9 * 6];
      std::memset(B, 0, sizeof(B));
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          B[(ES_Q + i) * 6 + j] = dt * Jr[i * 3 + j];
          B[(ES_V + i) * 6 + (3 + j)] = dt * Rk[i * 3 + j];
          B[(ES_P + i) * 6 + (3 + j)] = 0.5 * dt * dt * Rk[i * 3 + j];
        }
      double inv_dt = 1.0 / (dt > 1e-7 ? dt : 1e-7);
      double Wn[36];
      std::memset(Wn, 0, sizeof(Wn));
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          Wn[i * 6 + j] = cov_w[i * 3 + j] * inv_dt;
          Wn[(3 + i) * 6 + (3 + j)] = cov_a[i * 3 + j] * inv_dt;
        }
      double AC[81], ACAT[81];
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) {
          double s2 = 0;
          for (int k = 0; k < 9; ++k) s2 += A[i * 9 + k] * cov9[k * 9 + j];
          AC[i * 9 + j] = s2;
        }
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) {
          double s2 = 0;
          for (int k = 0; k < 9; ++k) s2 += AC[i * 9 + k] * A[j * 9 + k];
          ACAT[i * 9 + j] = s2;
        }
      double BW[9 * 6];
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 6; ++j) {
          double s2 = 0;
          for (int k = 0; k < 6; ++k) s2 += B[i * 6 + k] * Wn[k * 6 + j];
          BW[i * 6 + j] = s2;
        }
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) {
          double s2 = 0;
          for (int k = 0; k < 6; ++k) s2 += BW[i * 6 + k] * B[j * 6 + k];
          cov9[i * 9 + j] = ACAT[i * 9 + j] + s2;
        }
      for (int i = 0; i < 9; ++i) {
        cov_bg_acc[i] += cov_bg[i] * dt;
        cov_ba_acc[i] += cov_ba[i] * dt;
      }

      // --- bias jacobians (old dq_dbg feeds dp/dv updates) ---
      double RhD[9];
      mat3_mul(Rk_hat_a, dq_dbg, RhD);
      for (int i = 0; i < 9; ++i) {
        dp_dbg[i] += dt * dv_dbg[i] - 0.5 * dt * dt * RhD[i];
        dp_dba[i] += dt * dv_dba[i] - 0.5 * dt * dt * Rk[i];
        dv_dbg[i] += -dt * RhD[i];
        dv_dba[i] += -dt * Rk[i];
      }
      double RTD[9];
      mat3_mul(R_inc_T, dq_dbg, RTD);
      for (int i = 0; i < 9; ++i) dq_dbg[i] = RTD[i] - dt * Jr[i];

      // --- mean propagation ---
      double qa[3];
      quat_rotate(q, a, qa);
      for (int i = 0; i < 3; ++i) {
        p[i] += dt * v[i] + 0.5 * dt * dt * qa[i];
        v[i] += dt * qa[i];
      }
      double qn[4];
      quat_mul(q, dq_inc, qn);
      std::memcpy(q, qn, sizeof(qn));
      quat_normalize(q);
      t += dt;
    }

    // --- pack outputs ---
    t_out[f] = t;
    std::memcpy(q_out + f * 4, q, sizeof(q));
    std::memcpy(p_out + f * 3, p, sizeof(p));
    std::memcpy(v_out + f * 3, v, sizeof(v));
    double* cov = cov_out + f * 225;
    std::memset(cov, 0, sizeof(double) * 225);
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) cov[i * 15 + j] = cov9[i * 9 + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        cov[(ES_BG + i) * 15 + (ES_BG + j)] = cov_bg_acc[i * 3 + j];
        cov[(ES_BA + i) * 15 + (ES_BA + j)] = cov_ba_acc[i * 3 + j];
      }
    std::memcpy(dq_dbg_out + f * 9, dq_dbg, sizeof(dq_dbg));
    std::memcpy(dp_dbg_out + f * 9, dp_dbg, sizeof(dp_dbg));
    std::memcpy(dp_dba_out + f * 9, dp_dba, sizeof(dp_dba));
    std::memcpy(dv_dbg_out + f * 9, dv_dbg, sizeof(dv_dbg));
    std::memcpy(dv_dba_out + f * 9, dv_dba, sizeof(dv_dba));

    // --- whitening factor U = chol_upper(inv(cov + 1e-14 I)) so that
    // U^T U = cov^-1 (reference preintegrator.cpp:97-100) ---
    double* sic = sic_out + f * 225;
    std::memset(sic, 0, sizeof(double) * 225);
    if (t <= 0.0) {
      for (int i = 0; i < 15; ++i) sic[i * 15 + i] = 1.0;
      continue;
    }
    double M[225];
    std::memcpy(M, cov, sizeof(M));
    for (int i = 0; i < 15; ++i) M[i * 15 + i] += 1e-14;
    double L[225], Li[225], Minv[225], L2[225];
    bool ok = cholesky(M, L, 15);
    if (ok) {
      tri_inverse_lower(L, Li, 15);
      // Minv = Li^T Li
      for (int i = 0; i < 15; ++i)
        for (int j = 0; j < 15; ++j) {
          double s2 = 0;
          for (int k = (i > j ? i : j); k < 15; ++k)
            s2 += Li[k * 15 + i] * Li[k * 15 + j];
          Minv[i * 15 + j] = s2;
        }
      ok = cholesky(Minv, L2, 15);
    }
    if (ok) {
      for (int i = 0; i < 15; ++i)
        for (int j = 0; j < 15; ++j) sic[i * 15 + j] = L2[j * 15 + i];
    } else {
      for (int i = 0; i < 15; ++i) sic[i * 15 + i] = 1.0;
    }
  }
}

}  // extern "C"
