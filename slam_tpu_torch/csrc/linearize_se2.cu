// Fused SE(2) edge linearisation, one thread per edge.
//
// Replaces slam_tpu/ops/pallas_linearize.py: fused_linearize_se2 (_kernel,
// with _asin/_asin_core).  Per edge: trig of both poses, the closed-form
// residual e(3), gauge-masked analytic Ja/Jb (3x3), DCS psi with its chain
// rule on loop edges (robust mode is a template parameter), the Huber IRLS
// weight w and rho (both times active), and the weighted blocks Haa, Hbb,
// Hoff (3x3) and ga, gb (3).
//
// Bound: memory.  Each edge reads 13 values and writes 56, with ~200 flops
// and 9 transcendentals in between, so the card's bandwidth limits it long
// before its arithmetic does.  The TPU packed edges onto lanes with every
// quantity on its own sublane row ((16,Ep) -> (64,Ep)); here a thread reads
// its edge's (E,3)/(E,) inputs directly, keeps the whole chain in
// registers, and writes each output once -- no padding, no intermediate
// (E,3,3) tensors in device memory.  The device asin replaces the TPU
// polynomial, which existed only because Mosaic had no asin.

#include "common.cuh"

namespace slam {

template <typename T, bool kDcs>
__global__ void linearize_se2_kernel(
    const T* __restrict__ pa, const T* __restrict__ pb,
    const T* __restrict__ meas, const T* __restrict__ free_a,
    const T* __restrict__ free_b, const T* __restrict__ loop_f,
    const T* __restrict__ active, T phi, T delta, T* __restrict__ e_out,
    T* __restrict__ ja_out, T* __restrict__ jb_out, T* __restrict__ haa_out,
    T* __restrict__ hbb_out, T* __restrict__ hoff_out,
    T* __restrict__ ga_out, T* __restrict__ gb_out, T* __restrict__ w_out,
    T* __restrict__ rho_out, int64_t num_edges) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= num_edges) return;

  const T pa_x = pa[3 * i], pa_y = pa[3 * i + 1], pa_t = pa[3 * i + 2];
  const T pb_x = pb[3 * i], pb_y = pb[3 * i + 1], pb_t = pb[3 * i + 2];
  const T m_x = meas[3 * i], m_y = meas[3 * i + 1], m_t = meas[3 * i + 2];
  const T fa = free_a[i], fb = free_b[i];
  const T one = T(1), zero = T(0);

  const T ca = d_cos(pa_t), sa = d_sin(pa_t);
  const T cm = d_cos(m_t), sm = d_sin(m_t);
  const T dx = pb_x - pa_x, dy = pb_y - pa_y;
  const T vx = ca * dx + sa * dy - m_x;
  const T vy = -sa * dx + ca * dy - m_y;
  const T e0 = cm * vx + sm * vy;
  const T e1 = -sm * vx + cm * vy;
  const T dt = pb_t - pa_t - m_t;
  const T sdt = fmin(fmax(d_sin(dt), -one), one);
  const T e2 = d_asin(sdt);

  const T cma = d_cos(m_t + pa_t), sma = d_sin(m_t + pa_t);
  const T gx = -sa * dx + ca * dy, gy = -ca * dx - sa * dy;
  const T ht_x = cm * gx + sm * gy, ht_y = -sm * gx + cm * gy;
  const T c = d_cos(dt);
  const T sgn = T((c > zero) - (c < zero));  // jnp.sign: 0 at 0

  T ja[9] = {-cma * fa, -sma * fa, ht_x * fa, sma * fa, -cma * fa,
             ht_y * fa, zero,      zero,      -sgn * fa};
  T jb[9] = {cma * fb, sma * fb, zero, -sma * fb, cma * fb,
             zero,     zero,     zero, sgn * fb};
  T e[3] = {e0, e1, e2};

  if (kDcs) {
    const T lf = loop_f[i];
    const T r2 = e0 * e0 + e1 * e1;
    const T psi_raw = d_sqrt(T(2) * phi / (phi + r2));
    const bool act = psi_raw < one;
    T psi = act ? psi_raw : one;
    T dpsi = act ? -psi / (T(2) * (phi + r2)) : zero;
    psi = lf * psi + (one - lf);  // applied on loop edges only
    dpsi = lf * dpsi;
    T dra[3], drb[3];
    for (int j = 0; j < 3; ++j) {
      dra[j] = T(2) * (e0 * ja[j] + e1 * ja[3 + j]);
      drb[j] = T(2) * (e0 * jb[j] + e1 * jb[3 + j]);
    }
    for (int r = 0; r < 3; ++r) {
      for (int j = 0; j < 3; ++j) {
        ja[3 * r + j] = psi * ja[3 * r + j] + e[r] * dpsi * dra[j];
        jb[3 * r + j] = psi * jb[3 * r + j] + e[r] * dpsi * drb[j];
      }
    }
    e[0] = psi * e0;
    e[1] = psi * e1;
    e[2] = psi * e2;
  }

  const T act_i = active[i];
  const T s2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
  const T d2 = delta * delta;
  const T safe = d_sqrt(fmax(s2, d2));
  const bool quad = s2 <= d2;
  const T w = (quad ? one : delta / safe) * act_i;
  const T rho = (quad ? s2 : T(2) * delta * safe - d2) * act_i;

  for (int k = 0; k < 3; ++k) e_out[3 * i + k] = e[k];
  for (int k = 0; k < 9; ++k) {
    ja_out[9 * i + k] = ja[k];
    jb_out[9 * i + k] = jb[k];
  }
  for (int r = 0; r < 3; ++r) {
    for (int c2 = 0; c2 < 3; ++c2) {
      haa_out[9 * i + 3 * r + c2] =
          w * (ja[r] * ja[c2] + ja[3 + r] * ja[3 + c2] +
               ja[6 + r] * ja[6 + c2]);
      hbb_out[9 * i + 3 * r + c2] =
          w * (jb[r] * jb[c2] + jb[3 + r] * jb[3 + c2] +
               jb[6 + r] * jb[6 + c2]);
      hoff_out[9 * i + 3 * r + c2] =
          w * (ja[r] * jb[c2] + ja[3 + r] * jb[3 + c2] +
               ja[6 + r] * jb[6 + c2]);
    }
    ga_out[3 * i + r] = w * (ja[r] * e[0] + ja[3 + r] * e[1] + ja[6 + r] * e[2]);
    gb_out[3 * i + r] = w * (jb[r] * e[0] + jb[3 + r] * e[1] + jb[6 + r] * e[2]);
  }
  w_out[i] = w;
  rho_out[i] = rho;
}

template <typename T>
int linearize_se2(const void* pa, const void* pb, const void* meas,
                  const void* free_a, const void* free_b, const void* loop_f,
                  const void* active, double phi, double delta, int dcs,
                  void* e, void* ja, void* jb, void* haa, void* hbb,
                  void* hoff, void* ga, void* gb, void* w, void* rho,
                  int64_t num_edges, void* stream) {
  if (num_edges > 0) {
    dim3 grid(grid_for(num_edges)), block(kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SLAM_LINEARIZE_ARGS                                                  \
  static_cast<const T*>(pa), static_cast<const T*>(pb),                      \
      static_cast<const T*>(meas), static_cast<const T*>(free_a),            \
      static_cast<const T*>(free_b), static_cast<const T*>(loop_f),          \
      static_cast<const T*>(active), static_cast<T>(phi),                    \
      static_cast<T>(delta), static_cast<T*>(e), static_cast<T*>(ja),        \
      static_cast<T*>(jb), static_cast<T*>(haa), static_cast<T*>(hbb),       \
      static_cast<T*>(hoff), static_cast<T*>(ga), static_cast<T*>(gb),       \
      static_cast<T*>(w), static_cast<T*>(rho), num_edges
    if (dcs) {
      linearize_se2_kernel<T, true><<<grid, block, 0, s>>>(SLAM_LINEARIZE_ARGS);
    } else {
      linearize_se2_kernel<T, false><<<grid, block, 0, s>>>(SLAM_LINEARIZE_ARGS);
    }
#undef SLAM_LINEARIZE_ARGS
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

#define SLAM_LINEARIZE_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* pa, const void* pb, const void* meas,      \
                      const void* free_a, const void* free_b,                \
                      const void* loop_f, const void* active, double phi,    \
                      double delta, int dcs, void* e, void* ja, void* jb,    \
                      void* haa, void* hbb, void* hoff, void* ga, void* gb,  \
                      void* w, void* rho, int64_t num_edges, void* stream) { \
    return slam::linearize_se2<T>(pa, pb, meas, free_a, free_b, loop_f,      \
                                  active, phi, delta, dcs, e, ja, jb, haa,   \
                                  hbb, hoff, ga, gb, w, rho, num_edges,      \
                                  stream);                                   \
  }

SLAM_LINEARIZE_ENTRY(slam_linearize_se2_f32, float)
SLAM_LINEARIZE_ENTRY(slam_linearize_se2_f64, double)
