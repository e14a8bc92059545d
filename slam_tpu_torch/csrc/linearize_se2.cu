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
// quantity on its own sublane row ((16,Ep) -> (64,Ep)); here a thread keeps
// its edge's whole chain in registers, and the device asin replaces the TPU
// polynomial, which existed only because Mosaic had no asin.  Its design:
//   - the indexed form reads the endpoints itself: poses (N,3) and the free
//     mask (N,) at a = ab[e], b = ab[E + e], so the solver's linearisation
//     makes no gather launch; the other form takes the gathered (E,3)/(E,)
//     inputs of the JAX kernel's signature (a template parameter);
//   - the ten outputs are one field-major buffer of 56 E values (e, Ja, Jb,
//     Haa, Hbb, Hoff, ga, gb, w, rho, each contiguous): a block of one warp
//     stages its 32 edges' outputs in shared memory, field by field, then
//     stores each field as one contiguous run, so every store is coalesced;
//   - one warp per block spreads E = 1.5k (48 blocks) to 13k edges (413)
//     over the card's SMs, and needs no barrier but __syncwarp.
// The arithmetic per edge is the same expressions as before, so each output
// keeps its bits.

#include "common.cuh"

namespace slam {

constexpr int kLinThreads = 32;  // edges per block: one warp
constexpr int kLinFields = 10;
constexpr int kLinValues = 56;   // values per edge over all fields
// Offset (in values per edge) and width of each output field.
__constant__ int kLinOff[kLinFields] = {0, 3, 12, 21, 30, 39, 48, 51, 54, 55};
__constant__ int kLinWidth[kLinFields] = {3, 9, 9, 9, 9, 9, 3, 3, 1, 1};
enum { kE = 0, kJa = 3, kJb = 12, kHaa = 21, kHbb = 30, kHoff = 39,
       kGa = 48, kGb = 51, kW = 54, kRho = 55 };

template <typename T, bool kDcs, bool kIndexed>
__global__ void __launch_bounds__(kLinThreads) linearize_se2_kernel(
    const T* __restrict__ pa, const T* __restrict__ pb,
    const T* __restrict__ fa_in, const T* __restrict__ fb_in,
    const int* __restrict__ ab, const T* __restrict__ meas,
    const T* __restrict__ loop_f, const T* __restrict__ active, T phi,
    T delta, T* __restrict__ out, int64_t num_edges) {
  __shared__ __align__(16) unsigned char raw[kLinValues * kLinThreads *
                                             sizeof(T)];
  T* sm = reinterpret_cast<T*>(raw);
  const int lane = threadIdx.x;
  const int64_t e0_block = static_cast<int64_t>(blockIdx.x) * kLinThreads;
  const int64_t i = e0_block + lane;
  // Element k of field `off` (of `width` values) of this edge, staged.
#define SLAM_STAGE(off, width, k, v) \
  sm[(off) * kLinThreads + lane * (width) + (k)] = (v)

  if (i < num_edges) {
    int64_t ia = i, ib = i;
    if (kIndexed) {
      ia = ab[i];
      ib = ab[num_edges + i];
    }
    const T pa_x = pa[3 * ia], pa_y = pa[3 * ia + 1], pa_t = pa[3 * ia + 2];
    const T pb_x = pb[3 * ib], pb_y = pb[3 * ib + 1], pb_t = pb[3 * ib + 2];
    const T m_x = meas[3 * i], m_y = meas[3 * i + 1], m_t = meas[3 * i + 2];
    const T fa = fa_in[ia], fb = fb_in[ib];
    const T one = T(1), zero = T(0);

    const T ca = d_cos(pa_t), sa = d_sin(pa_t);
    const T cm = d_cos(m_t), sm_ = d_sin(m_t);
    const T dx = pb_x - pa_x, dy = pb_y - pa_y;
    const T vx = ca * dx + sa * dy - m_x;
    const T vy = -sa * dx + ca * dy - m_y;
    const T e0 = cm * vx + sm_ * vy;
    const T e1 = -sm_ * vx + cm * vy;
    const T dt = pb_t - pa_t - m_t;
    const T sdt = fmin(fmax(d_sin(dt), -one), one);
    const T e2 = d_asin(sdt);

    const T cma = d_cos(m_t + pa_t), sma = d_sin(m_t + pa_t);
    const T gx = -sa * dx + ca * dy, gy = -ca * dx - sa * dy;
    const T ht_x = cm * gx + sm_ * gy, ht_y = -sm_ * gx + cm * gy;
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

    for (int k = 0; k < 3; ++k) SLAM_STAGE(kE, 3, k, e[k]);
    for (int k = 0; k < 9; ++k) {
      SLAM_STAGE(kJa, 9, k, ja[k]);
      SLAM_STAGE(kJb, 9, k, jb[k]);
    }
    for (int r = 0; r < 3; ++r) {
      for (int c2 = 0; c2 < 3; ++c2) {
        SLAM_STAGE(kHaa, 9, 3 * r + c2,
                   w * (ja[r] * ja[c2] + ja[3 + r] * ja[3 + c2] +
                        ja[6 + r] * ja[6 + c2]));
        SLAM_STAGE(kHbb, 9, 3 * r + c2,
                   w * (jb[r] * jb[c2] + jb[3 + r] * jb[3 + c2] +
                        jb[6 + r] * jb[6 + c2]));
        SLAM_STAGE(kHoff, 9, 3 * r + c2,
                   w * (ja[r] * jb[c2] + ja[3 + r] * jb[3 + c2] +
                        ja[6 + r] * jb[6 + c2]));
      }
      SLAM_STAGE(kGa, 3, r,
                 w * (ja[r] * e[0] + ja[3 + r] * e[1] + ja[6 + r] * e[2]));
      SLAM_STAGE(kGb, 3, r,
                 w * (jb[r] * e[0] + jb[3 + r] * e[1] + jb[6 + r] * e[2]));
    }
    SLAM_STAGE(kW, 1, 0, w);
    SLAM_STAGE(kRho, 1, 0, rho);
  }
#undef SLAM_STAGE
  __syncwarp();

  // Each field of the block's edges is one contiguous run of the output.
  const int64_t rest = num_edges - e0_block;
  const int nb = rest < kLinThreads ? static_cast<int>(rest) : kLinThreads;
#pragma unroll
  for (int f = 0; f < kLinFields; ++f) {
    const int off = kLinOff[f], width = kLinWidth[f];
    T* dst = out + off * num_edges + e0_block * width;
    const T* src = sm + off * kLinThreads;
    for (int k = lane; k < nb * width; k += kLinThreads) dst[k] = src[k];
  }
}

template <typename T, bool kIndexed>
int linearize_se2(const void* pa, const void* pb, const void* fa,
                  const void* fb, const void* ab, const void* meas,
                  const void* loop_f, const void* active, double phi,
                  double delta, int dcs, void* out, int64_t num_edges,
                  void* stream) {
  if (num_edges > 0) {
    const unsigned int grid = static_cast<unsigned int>(
        (num_edges + kLinThreads - 1) / kLinThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SLAM_LINEARIZE_ARGS                                                  \
  static_cast<const T*>(pa), static_cast<const T*>(pb),                      \
      static_cast<const T*>(fa), static_cast<const T*>(fb),                  \
      static_cast<const int*>(ab), static_cast<const T*>(meas),              \
      static_cast<const T*>(loop_f), static_cast<const T*>(active),          \
      static_cast<T>(phi), static_cast<T>(delta), static_cast<T*>(out),      \
      num_edges
    if (dcs) {
      linearize_se2_kernel<T, true, kIndexed>
          <<<grid, kLinThreads, 0, s>>>(SLAM_LINEARIZE_ARGS);
    } else {
      linearize_se2_kernel<T, false, kIndexed>
          <<<grid, kLinThreads, 0, s>>>(SLAM_LINEARIZE_ARGS);
    }
#undef SLAM_LINEARIZE_ARGS
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slam

// The JAX kernel's inputs: gathered endpoints pa, pb (E,3), fa, fb (E,).
#define SLAM_LINEARIZE_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* pa, const void* pb, const void* meas,      \
                      const void* fa, const void* fb, const void* loop_f,    \
                      const void* active, double phi, double delta, int dcs, \
                      void* out, int64_t num_edges, void* stream) {          \
    return slam::linearize_se2<T, false>(pa, pb, fa, fb, nullptr, meas,      \
                                         loop_f, active, phi, delta, dcs,    \
                                         out, num_edges, stream);            \
  }
// Indexed: poses (N,3), free (N,) and the endpoints ab (2E,) int32.
#define SLAM_LINEARIZE_INDEXED_ENTRY(NAME, T)                                \
  extern "C" int NAME(const void* poses, const void* free_node,              \
                      const void* ab, const void* meas, const void* loop_f,  \
                      const void* active, double phi, double delta, int dcs, \
                      void* out, int64_t num_edges, void* stream) {          \
    return slam::linearize_se2<T, true>(poses, poses, free_node, free_node,  \
                                        ab, meas, loop_f, active, phi,       \
                                        delta, dcs, out, num_edges, stream); \
  }

SLAM_LINEARIZE_ENTRY(slam_linearize_se2_f32, float)
SLAM_LINEARIZE_ENTRY(slam_linearize_se2_f64, double)
SLAM_LINEARIZE_INDEXED_ENTRY(slam_linearize_se2_indexed_f32, float)
SLAM_LINEARIZE_INDEXED_ENTRY(slam_linearize_se2_indexed_f64, double)
