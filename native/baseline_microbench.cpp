// Calibrated CPU anchor for BASELINE.md / bench.py vs_baseline.
//
// The reference (luodongting/HSO) cannot be built in this image (no
// Eigen/boost, no network), so this microbench transcribes the WORKLOAD of
// its two per-frame hot loops into freestanding C++ and measures them on
// this machine's CPU at the reference's own operating point:
//
//  A. CoarseTracker residual pass (/root/reference/src/CoarseTracker.cpp:
//     242-414): per visible feature, per DSO-pattern pixel — bilinear
//     sample of the current pyramid level, Huber-weighted residual,
//     bilinear image gradient (8 extra taps), a 7-vector Jacobian
//     [J_exposure; J_se3], buffered; then the normal-equation accumulation
//     (applyRes analogue): rank-1 update of the 7x7 system per term.
//     Per frame: n_levels coarse levels x n_iter LM iterations each.
//
//  B. Matcher::doLineStereo epipolar sweep (/root/reference/src/matcher.cpp
//     :931-969): per depth-filter seed — walk the epipolar segment in
//     0.7 px steps; per step an 8x8 patch is affine-warp-sampled
//     (warp::createPatch, 4-tap bilinear per pixel) and scored with ZMNCC
//     against the reference patch; then a 10-iteration 1-DoF KLT refine
//     (KLTLimited1D) over the 8x8 patch.
//
// Everything else the reference does per frame (reprojection, pose
// optimizer, detection, BA amortised over keyframes) is EXCLUDED, which
// biases the anchor IN THE REFERENCE'S FAVOUR (fewer modelled costs =>
// higher anchor fps => lower reported speedup for this framework).
//
// Operating point (cited):
//   n_features = 200        maxFts, /root/reference/src/config.cpp
//   pattern    = 8 px       DSO staticPattern/staticPatternNum,
//                           CoarseTracker.h:58-124 (PATCH_AREA=8)
//   levels     = 4          klt_max_level=4 .. klt_min_level+1=1
//                           (frame_handler_mono.cpp:190, config.cpp:40-41)
//   iters      = variable   n_iter=50 max with early stop
//                           (frame_handler_mono.cpp:190, CoarseTracker.cpp:
//                           110,186); both a "typical converged" (10) and
//                           the max (50) point are run
//   n_seeds    = 300        alive seeds swept/frame (200 detections/KF x
//                           3-KF lifetime, partial visibility)
//   epl steps  = 30         ~21 px segment at 0.7 px/step (epi_length/0.7,
//                           matcher.cpp:907-969; cap 100 px -> 143 steps)
//   klt iters  = 10         options_.align_max_iter
//
// Prints one JSON line: {"tracker_ms":..,"stereo_ms":..,"fps_typical":..,
// "fps_max":..}.  scripts/baseline_cpu_microbench.py wraps this into
// BASELINE_CPU.json with the derivation documented.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <vector>

namespace {

constexpr int W = 640, H = 480;
constexpr int PATCH_AREA = 8;          // DSO pattern points
constexpr int HALF = 4;                // 8x8 stereo patch
constexpr int PSZ = 2 * HALF;

// DSO residual pattern (shape only; the values are the spread of
// staticPattern[2], CoarseTracker.h — any 8-point spread has identical cost)
const int kPattern[PATCH_AREA][2] = {
    {0, 0}, {-2, 0}, {2, 0}, {0, -2}, {0, 2}, {-1, -1}, {1, 1}, {-1, 1}};

uint64_t rng_state = 88172645463325252ull;
inline uint64_t xorshift() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return rng_state;
}
inline float frand() { return (xorshift() >> 40) * (1.0f / (1 << 24)); }

struct Image {
  std::vector<uint8_t> d;
  int w, h;
  Image(int w_, int h_) : d(size_t(w_) * h_), w(w_), h(h_) {
    for (auto& p : d) p = uint8_t(xorshift() & 0xff);
    // one smoothing pass so gradients look image-like
    for (int y = 1; y < h - 1; ++y)
      for (int x = 1; x < w - 1; ++x)
        d[size_t(y) * w + x] = uint8_t(
            (d[size_t(y) * w + x] + d[size_t(y) * w + x - 1] +
             d[size_t(y - 1) * w + x] + d[size_t(y + 1) * w + x]) >> 2);
  }
};

// ---------------------------------------------------------------- workload A
// One coarse-tracker LM iteration at one level: residual pass + 7x7
// normal-equation accumulation for n_fts features.  Matches the reference's
// arithmetic model: DOUBLE-precision Jacobians (Vector7d / Matrix<double,
// 2,6>, CoarseTracker.cpp:320-404) buffered through std::vector push_back
// per term, then reduced (applyRes).
struct TrackerBufs {
  std::vector<double> J;       // 7 per term
  std::vector<float> w, e;
};

double tracker_iteration(const Image& img, int n_fts, double* H77, double* g7,
                         TrackerBufs& bufs) {
  const int stride = img.w;
  const float huber = 5.0f;
  double E = 0.0;
  bufs.J.clear(); bufs.w.clear(); bufs.e.clear();

  for (int f = 0; f < n_fts; ++f) {
    // projected position + per-feature geometry (stand-in for the SE3
    // transform + projection the reference does per feature)
    float u = 8.0f + frand() * (img.w - 16);
    float v = 8.0f + frand() * (img.h - 16);
    double iz = 0.2 + frand();                 // 1/depth
    int ui = int(u), vi = int(v);
    float su = u - ui, sv = v - vi;
    float wtl = (1 - su) * (1 - sv), wtr = su * (1 - sv);
    float wbl = (1 - su) * sv, wbr = su * sv;
    // frame jacobian rows (Frame::jacobian_xyz2uv, double like the ref)
    double jx[6] = {iz, 0, -u * iz, -double(u) * v, 1 + double(u) * u, -v};
    double jy[6] = {0, iz, -v * iz, -(1 + double(v) * v), double(u) * v, u};

    for (int n = 0; n < PATCH_AREA; ++n) {
      const uint8_t* p = img.d.data() +
                         size_t(vi + kPattern[n][1]) * stride + ui + kPattern[n][0];
      float cur = wtl * p[0] + wtr * p[1] + wbl * p[stride] + wbr * p[stride + 1];
      float ref = 128.0f + 40.0f * frand();
      float r = cur - ref;
      float ar = std::fabs(r);
      float hw = ar < huber ? 1.0f : huber / ar;
      E += hw * r * r * (2 - hw);
      float dx = 0.5f * ((wtl * p[1] + wtr * p[2] + wbl * p[stride + 1] + wbr * p[stride + 2]) -
                         (wtl * p[-1] + wtr * p[0] + wbl * p[stride - 1] + wbr * p[stride]));
      float dy = 0.5f * ((wtl * p[stride] + wtr * p[stride + 1] + wbl * p[2 * stride] + wbr * p[2 * stride + 1]) -
                         (wtl * p[-stride] + wtr * p[1 - stride] + wbl * p[0] + wbr * p[1]));
      double J[7];
      J[0] = -double(ref);                         // exposure jacobian
      for (int k = 0; k < 6; ++k) J[k + 1] = dx * jx[k] + dy * jy[k];
      bufs.J.insert(bufs.J.end(), J, J + 7);       // m_buf_jacobian.push_back
      bufs.w.push_back(hw);
      bufs.e.push_back(r);
    }
  }
  // applyRes: weighted rank-1 reduction of the buffered terms
  for (int i = 0; i < 49; ++i) H77[i] = 0.0;
  for (int i = 0; i < 7; ++i) g7[i] = 0.0;
  const size_t nt = bufs.w.size();
  for (size_t t = 0; t < nt; ++t) {
    const double* J = bufs.J.data() + 7 * t;
    double hw = bufs.w[t], r = bufs.e[t];
    for (int a = 0; a < 7; ++a) {
      g7[a] += hw * r * J[a];
      for (int b = 0; b <= a; ++b) H77[a * 7 + b] += hw * J[a] * J[b];
    }
  }
  return E;
}

// ---------------------------------------------------------------- workload B
// One seed's epipolar sweep: n_steps x (8x8 affine-warped patch + ZMNCC)
// + 10-iteration 1D KLT refine.
float seed_line_stereo(const Image& img, const float* ref_patch,
                       float ref_mean, float ref_var, int n_steps) {
  const int stride = img.w;
  float cpx = 20.0f + frand() * (img.w - 60);
  float cpy = 20.0f + frand() * (img.h - 60);
  float incx = 0.63f, incy = 0.30f;              // 0.7 px epl step
  // affine warp (A_cur_ref) applied per patch pixel like warp::createPatch
  float a00 = 1.02f, a01 = 0.05f, a10 = -0.03f, a11 = 0.98f;
  float best = 0.1f, second = 0.1f;
  float patch[PSZ * PSZ];

  for (int s = 0; s < n_steps; ++s, cpx += incx, cpy += incy) {
    float sum = 0, sq = 0, dot = 0;
    for (int py = 0; py < PSZ; ++py)
      for (int px = 0; px < PSZ; ++px) {
        float du = float(px - HALF), dv = float(py - HALF);
        float u = cpx + a00 * du + a01 * dv;
        float v = cpy + a10 * du + a11 * dv;
        int ui = int(u), vi = int(v);
        float su = u - ui, sv = v - vi;
        const uint8_t* p = img.d.data() + size_t(vi) * stride + ui;
        float c = (1 - su) * (1 - sv) * p[0] + su * (1 - sv) * p[1] +
                  (1 - su) * sv * p[stride] + su * sv * p[stride + 1];
        patch[py * PSZ + px] = c;
        sum += c;
        sq += c * c;
        dot += c * ref_patch[py * PSZ + px];
      }
    // ZMNCC (hso::patch_score::ZMNCC_F<4>)
    float n = PSZ * PSZ;
    float mean = sum / n;
    float var = sq / n - mean * mean;
    float cov = dot / n - mean * ref_mean;
    float zmncc = cov / std::sqrt(var * ref_var + 1e-10f);
    if (zmncc > best) { second = best; best = zmncc; }
    else if (zmncc > second) { second = zmncc; }
  }

  // KLTLimited1D refine: 10 iterations over the 8x8 patch (4-tap sample +
  // 1-DoF normal equation)
  float t = 0.0f, dirx = 0.9f, diry = 0.436f;
  for (int it = 0; it < 10; ++it) {
    float H = 1e-6f, g = 0;
    for (int py = 0; py < PSZ; ++py)
      for (int px = 0; px < PSZ; ++px) {
        float u = cpx + t * dirx + px - HALF;
        float v = cpy + t * diry + py - HALF;
        int ui = int(u), vi = int(v);
        float su = u - ui, sv = v - vi;
        const uint8_t* p = img.d.data() + size_t(vi) * stride + ui;
        float c = (1 - su) * (1 - sv) * p[0] + su * (1 - sv) * p[1] +
                  (1 - su) * sv * p[stride] + su * sv * p[stride + 1];
        float gx = 0.5f * (p[1] - p[-1]);
        float gd = gx * dirx;
        float r = c - ref_patch[py * PSZ + px];
        H += gd * gd;
        g -= gd * r;
      }
    t += g / H;
    if (std::fabs(g / H) < 0.03f) break;
  }
  return best + t;
}

// ---------------------------------------------------------------- workload C
// Tracking-thread per-frame costs beyond the coarse aligner:
//  * image pyramid + Sobel construction (frame creation)
//  * Reprojector/Matcher::findMatchDirect for ~maxFts candidates: one 8x8
//    affine warp + ZMNCC gate + 10-iteration 2-DoF inverse-compositional
//    alignment (matcher.cpp:270-375, KLTLimited2D)
double pyramid_pass(const Image& img, std::vector<uint8_t>& scratch) {
  // 5 levels of 2x2 box downsample + 3 levels of Sobel (vikit analogue)
  double sum = 0;
  int w = img.w, h = img.h;
  const uint8_t* src = img.d.data();
  size_t off = 0;
  for (int l = 0; l < 4; ++l) {
    int w2 = w / 2, h2 = h / 2;
    uint8_t* dst = scratch.data() + off;
    for (int y = 0; y < h2; ++y)
      for (int x = 0; x < w2; ++x)
        dst[size_t(y) * w2 + x] = uint8_t(
            (src[size_t(2 * y) * w + 2 * x] + src[size_t(2 * y) * w + 2 * x + 1] +
             src[size_t(2 * y + 1) * w + 2 * x] + src[size_t(2 * y + 1) * w + 2 * x + 1]) >> 2);
    src = dst;
    off += size_t(w2) * h2;
    w = w2; h = h2;
  }
  // Sobel on the 3 finest levels
  w = img.w; h = img.h;
  src = img.d.data();
  off = 0;
  for (int l = 0; l < 3; ++l) {
    for (int y = 1; y < h - 1; ++y)
      for (int x = 1; x < w - 1; ++x) {
        const uint8_t* p = src + size_t(y) * w + x;
        int gx = (p[1] - p[-1]) * 2 + p[-w + 1] - p[-w - 1] + p[w + 1] - p[w - 1];
        int gy = (p[w] - p[-w]) * 2 + p[w - 1] - p[-w - 1] + p[w + 1] - p[-w + 1];
        sum += std::abs(gx) + std::abs(gy);
      }
    if (l == 0) { src = scratch.data(); }
    else { src += size_t(w / 1) * h; }
    w /= 2; h /= 2;
  }
  return sum;
}

float reproject_match(const Image& img, const float* ref_patch) {
  const int stride = img.w;
  float cpx = 20.0f + frand() * (img.w - 60);
  float cpy = 20.0f + frand() * (img.h - 60);
  float a00 = 1.02f, a01 = 0.05f, a10 = -0.03f, a11 = 0.98f;
  float patch[PSZ * PSZ];
  // warp once (createPatch) + ZMNCC gate
  float sum = 0, sq = 0;
  for (int py = 0; py < PSZ; ++py)
    for (int px = 0; px < PSZ; ++px) {
      float du = float(px - HALF), dv = float(py - HALF);
      float u = cpx + a00 * du + a01 * dv;
      float v = cpy + a10 * du + a11 * dv;
      int ui = int(u), vi = int(v);
      float su = u - ui, sv = v - vi;
      const uint8_t* p = img.d.data() + size_t(vi) * stride + ui;
      float c = (1 - su) * (1 - sv) * p[0] + su * (1 - sv) * p[1] +
                (1 - su) * sv * p[stride] + su * sv * p[stride + 1];
      patch[py * PSZ + px] = c;
      sum += c; sq += c * c;
    }
  // 10-iteration 2-DoF KLT (KLTLimited2D): 2x2 normal equations per iter
  float tx = 0, ty = 0;
  for (int it = 0; it < 10; ++it) {
    float H00 = 1e-6f, H01 = 0, H11 = 1e-6f, g0 = 0, g1 = 0;
    for (int py = 0; py < PSZ; ++py)
      for (int px = 0; px < PSZ; ++px) {
        float u = cpx + tx + px - HALF;
        float v = cpy + ty + py - HALF;
        int ui = int(u), vi = int(v);
        float su = u - ui, sv = v - vi;
        const uint8_t* p = img.d.data() + size_t(vi) * stride + ui;
        float c = (1 - su) * (1 - sv) * p[0] + su * (1 - sv) * p[1] +
                  (1 - su) * sv * p[stride] + su * sv * p[stride + 1];
        float gx = 0.5f * (p[1] - p[-1]);
        float gy = 0.5f * (p[stride] - p[-stride]);
        float r = c - ref_patch[py * PSZ + px];
        H00 += gx * gx; H01 += gx * gy; H11 += gy * gy;
        g0 -= gx * r; g1 -= gy * r;
      }
    float det = H00 * H11 - H01 * H01 + 1e-9f;
    float dx = (H11 * g0 - H01 * g1) / det;
    float dy = (H00 * g1 - H01 * g0) / det;
    tx += dx; ty += dy;
    if (dx * dx + dy * dy < 0.0009f) break;
  }
  return tx + ty + sum + sq;
}

// ---------------------------------------------------------------- workload D
// Per-frame undistortion remap (the reference pre-undistorts whole images
// when the calib has distortion — cv::remap bilinear with precomputed maps,
// /root/reference/test/test_dataset.cpp:276; EuRoC is Pinhole+radtan so
// every EuRoC frame pays this).  Fixed-point bilinear like cv::remap's
// INTER_LINEAR path; map construction (startup, once) excluded.
double undistort_remap(const Image& img, const std::vector<int32_t>& map_base,
                       const std::vector<int16_t>& map_frac,
                       std::vector<uint8_t>& out) {
  const int n = img.w * img.h;
  const uint8_t* src = img.d.data();
  double sum = 0;
  for (int i = 0; i < n; ++i) {
    int32_t base = map_base[i];
    int su = map_frac[2 * i], sv = map_frac[2 * i + 1];   // 0..32 fixed point
    const uint8_t* p = src + base;
    int c = ((32 - su) * (32 - sv) * p[0] + su * (32 - sv) * p[1] +
             (32 - su) * sv * p[W] + su * sv * p[W + 1]) >> 10;
    out[i] = uint8_t(c);
    sum += c;
  }
  return sum;
}

// ---------------------------------------------------------------- workload E
// Motion-only pose refinement (pose_optimizer::optimizeLevenbergMarquardt3rd,
// /root/reference/src/pose_optimizer.cpp:399-771; called per frame from
// frame_handler_mono.cpp:241-243): 12 LM iterations over ~n_fts unit-plane
// reprojection residuals, 2x6 Jacobians, Huber weights, 6x6 normal
// equations + solve.  Trial repetitions (<=5/iter) are EXCLUDED —
// reference-favoring.
double pose_optimizer_pass(int n_obs, int n_iter, float* pts3, float* obs2) {
  double sink = 0;
  float T[12] = {1, 0, 0, 0.01f, 0, 1, 0, -0.02f, 0, 0, 1, 0.03f};
  for (int it = 0; it < n_iter; ++it) {
    double Hm[36] = {0}, g[6] = {0};
    for (int i = 0; i < n_obs; ++i) {
      const float* P = pts3 + 3 * i;
      float x = T[0] * P[0] + T[1] * P[1] + T[2] * P[2] + T[3];
      float y = T[4] * P[0] + T[5] * P[1] + T[6] * P[2] + T[7];
      float z = T[8] * P[0] + T[9] * P[1] + T[10] * P[2] + T[11];
      float zi = 1.0f / z, zi2 = zi * zi;
      float eu = obs2[2 * i] - x * zi, ev = obs2[2 * i + 1] - y * zi;
      float r = std::sqrt(eu * eu + ev * ev);
      float wgt = r < 0.004f ? 1.0f : 0.004f / r;          // Huber
      float J0[6] = {-zi, 0, x * zi2, x * y * zi2, -(1 + x * x * zi2), y * zi};
      float J1[6] = {0, -zi, y * zi2, 1 + y * y * zi2, -x * y * zi2, -x * zi};
      for (int a = 0; a < 6; ++a) {
        g[a] -= wgt * (J0[a] * eu + J1[a] * ev);
        for (int b = a; b < 6; ++b)
          Hm[a * 6 + b] += wgt * (J0[a] * J0[b] + J1[a] * J1[b]);
      }
    }
    // 6x6 Cholesky solve
    double L[36] = {0};
    for (int j = 0; j < 6; ++j) {
      double s = Hm[j * 6 + j] + 1e-6;
      for (int k = 0; k < j; ++k) s -= L[j * 6 + k] * L[j * 6 + k];
      L[j * 6 + j] = std::sqrt(std::max(s, 1e-12));
      for (int i2 = j + 1; i2 < 6; ++i2) {
        double t = Hm[j * 6 + i2];
        for (int k = 0; k < j; ++k) t -= L[i2 * 6 + k] * L[j * 6 + k];
        L[i2 * 6 + j] = t / L[j * 6 + j];
      }
    }
    sink += L[35] + g[5];
  }
  return sink;
}

// ---------------------------------------------------------------- workload F
// Sliding-window local BA (ba::LocalBundleAdjustment, called ON the
// tracking thread at every keyframe, /root/reference/src/frame_handler_mono
// .cpp:314-327 -> bundle_adjustment.cpp:556-897; the printed fps includes
// it).  Modelled per LM iteration: per-obs linearization (host-anchored
// inverse-distance points: residual, d/d(idist), d/d(host), d/d(target)
// with accumulation into the camera blocks), scalar Schur elimination of
// every landmark, and the reduced 6K camera solve.  g2o's graph building,
// allocation churn and virtual dispatch are EXCLUDED — reference-favoring.
double local_ba_pass(int n_obs, int n_pts, int n_kf, int n_iter,
                     std::vector<float>& obs_data, std::vector<float>& Wrows,
                     std::vector<double>& Hcc) {
  double sink = 0;
  const int obs_per_pt = n_obs / n_pts;
  for (int it = 0; it < n_iter; ++it) {
    std::fill(Hcc.begin(), Hcc.end(), 0.0);
    for (int o = 0; o < n_obs; ++o) {
      float* d = obs_data.data() + 8 * o;
      float x = d[0], y = d[1], z = d[2] + 1.0f;
      float zi = 1.0f / z, zi2 = zi * zi;
      float eu = d[3] - x * zi, ev = d[4] - y * zi;
      float r = std::sqrt(eu * eu + ev * ev);
      float wgt = r < 0.004f ? 1.0f : 0.004f / r;
      float Jr0 = d[5] * zi, Jr1 = d[6] * zi;              // d/d idist
      float J0[6] = {-zi, 0, x * zi2, x * y * zi2, -(1 + x * x * zi2), y * zi};
      float J1[6] = {0, -zi, y * zi2, 1 + y * y * zi2, -x * y * zi2, -x * zi};
      int kf = (o % n_kf);
      double* Hb = Hcc.data() + 36 * kf;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b)
          Hb[a * 6 + b] += wgt * (J0[a] * J0[b] + J1[a] * J1[b]);
      // host-block adjoint contribution (EdgeProjectID2UV multi-edge)
      int kh = ((o + 1) % n_kf);
      double* Hh = Hcc.data() + 36 * kh;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b)
          Hh[a * 6 + b] += wgt * (J0[a] * J1[b] + J1[a] * J0[b]) * 0.5;
      d[7] = wgt * (Jr0 * Jr0 + Jr1 * Jr1);                // H_pp scalar
      // point-pose coupling row W_o = Jr^T * [J0; J1] (1x6 per obs)
      float* Wr = Wrows.data() + 6 * o;
      for (int a = 0; a < 6; ++a)
        Wr[a] = wgt * (Jr0 * J0[a] + Jr1 * J1[a]);
      sink += wgt * (Jr0 * eu + Jr1 * ev);
    }
    // scalar Schur elimination: per point, W^T Hpp^-1 W over its obs pairs
    // accumulated into the camera-camera system (6x6 outer product per pair)
    for (int p = 0; p < n_pts; ++p) {
      double hpp = 1e-6;
      for (int o = 0; o < obs_per_pt; ++o)
        hpp += obs_data[8 * (p * obs_per_pt + o) + 7];
      double inv = 1.0 / hpp;
      for (int oa = 0; oa < obs_per_pt; ++oa) {
        const float* Wa = Wrows.data() + 6 * (p * obs_per_pt + oa);
        for (int ob = 0; ob < obs_per_pt; ++ob) {
          const float* Wb = Wrows.data() + 6 * (p * obs_per_pt + ob);
          double* Hb = Hcc.data() + 36 * ((p * obs_per_pt + oa) % n_kf);
          for (int a = 0; a < 6; ++a)
            for (int b = 0; b < 6; ++b)
              Hb[a * 6 + b] -= inv * Wa[a] * Wb[b];
        }
      }
    }
    // reduced camera solve: dense 6K x 6K Cholesky
    int n6 = 6 * n_kf;
    std::vector<double> A(size_t(n6) * n6, 0.0);
    for (int k = 0; k < n_kf; ++k)
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b)
          A[size_t(6 * k + a) * n6 + 6 * k + b] =
              Hcc[36 * k + std::min(a, b) * 6 + std::max(a, b)] + (a == b ? 1.0 : 0.0);
    for (int j = 0; j < n6; ++j) {
      double s = A[size_t(j) * n6 + j];
      for (int k = 0; k < j; ++k) s -= A[size_t(j) * n6 + k] * A[size_t(j) * n6 + k];
      A[size_t(j) * n6 + j] = std::sqrt(std::max(s, 1e-12));
      for (int i2 = j + 1; i2 < n6; ++i2) {
        double t = A[size_t(i2) * n6 + j];
        for (int k = 0; k < j; ++k) t -= A[size_t(i2) * n6 + k] * A[size_t(j) * n6 + k];
        A[size_t(i2) * n6 + j] = t / A[size_t(j) * n6 + j];
      }
    }
    sink += A[size_t(n6) * n6 - 1];
  }
  return sink;
}

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}

}  // namespace

int main(int argc, char** argv) {
  const int n_fts = 200, n_levels = 4, n_seeds = 300, epl_steps = 30;
  const int iters_typical = 10, iters_max = 50;

  Image img(W, H);
  double H77[49], g7[7];
  TrackerBufs bufs;
  float ref_patch[PSZ * PSZ];
  float rsum = 0, rsq = 0;
  for (int i = 0; i < PSZ * PSZ; ++i) {
    ref_patch[i] = 100.0f + 60.0f * frand();
    rsum += ref_patch[i];
    rsq += ref_patch[i] * ref_patch[i];
  }
  float rmean = rsum / (PSZ * PSZ);
  float rvar = rsq / (PSZ * PSZ) - rmean * rmean;

  std::vector<uint8_t> scratch(size_t(W) * H);

  // ---- workload D/E/F inputs ----
  // undistort maps: small radial warp (EuRoC-like radtan magnitude)
  std::vector<int32_t> map_base(size_t(W) * H);
  std::vector<int16_t> map_frac(size_t(W) * H * 2);
  std::vector<uint8_t> remap_out(size_t(W) * H);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      float dx = (x - W / 2) / float(W), dy = (y - H / 2) / float(H);
      float r2 = dx * dx + dy * dy;
      float u = std::min(std::max(x + dx * r2 * 40.0f, 0.0f), float(W - 2));
      float v = std::min(std::max(y + dy * r2 * 40.0f, 0.0f), float(H - 2));
      int ui = int(u), vi = int(v);
      map_base[size_t(y) * W + x] = vi * W + ui;
      map_frac[2 * (size_t(y) * W + x)] = int16_t((u - ui) * 32.0f);
      map_frac[2 * (size_t(y) * W + x) + 1] = int16_t((v - vi) * 32.0f);
    }
  const int n_pose_iter = 12;                // pose_optimizer.cpp:407
  std::vector<float> pose_pts(size_t(n_fts) * 3), pose_obs(size_t(n_fts) * 2);
  for (int i = 0; i < n_fts; ++i) {
    pose_pts[3 * i] = frand() * 2 - 1;
    pose_pts[3 * i + 1] = frand() * 1.4f - 0.7f;
    pose_pts[3 * i + 2] = 2.0f + 3.0f * frand();
    pose_obs[2 * i] = pose_pts[3 * i] / pose_pts[3 * i + 2] + 0.002f * frand();
    pose_obs[2 * i + 1] = pose_pts[3 * i + 1] / pose_pts[3 * i + 2] + 0.002f * frand();
  }
  // BA window: core_n_kfs=7 free + ~3 fixed hosts (config.cpp:34), ~1000
  // windowed points at ~3 obs each, 10 LM iterations (config loba_num_iter),
  // a keyframe every kf_interval frames (the bench's own cadence)
  const int ba_kf = 10, ba_pts = 1000, ba_obs = 3000, ba_iter = 10,
            kf_interval = 6;
  std::vector<float> ba_data(size_t(ba_obs) * 8);
  std::vector<float> ba_w(size_t(ba_obs) * 6);
  for (size_t i = 0; i < ba_data.size(); ++i) ba_data[i] = frand();
  std::vector<double> ba_hcc(size_t(ba_kf) * 36);

  volatile double sink = 0;
  // warm
  for (int i = 0; i < 5; ++i) sink += tracker_iteration(img, n_fts, H77, g7, bufs);
  for (int i = 0; i < 5; ++i)
    sink += seed_line_stereo(img, ref_patch, rmean, rvar, epl_steps);
  for (int i = 0; i < 3; ++i) sink += pyramid_pass(img, scratch);
  for (int i = 0; i < 50; ++i) sink += reproject_match(img, ref_patch);
  for (int i = 0; i < 3; ++i) {
    sink += undistort_remap(img, map_base, map_frac, remap_out);
    sink += pose_optimizer_pass(n_fts, n_pose_iter, pose_pts.data(),
                                pose_obs.data());
    sink += local_ba_pass(ba_obs, ba_pts, ba_kf, ba_iter, ba_data, ba_w,
                          ba_hcc);
  }

  const int reps = 40;
  // coarse aligner: one frame = n_levels * iters iterations
  double t0 = now_s();
  for (int r = 0; r < reps; ++r)
    for (int l = 0; l < n_levels; ++l)
      for (int it = 0; it < iters_typical; ++it)
        sink += tracker_iteration(img, n_fts, H77, g7, bufs);
  double align_typ_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps / 4; ++r)
    for (int l = 0; l < n_levels; ++l)
      for (int it = 0; it < iters_max; ++it)
        sink += tracker_iteration(img, n_fts, H77, g7, bufs);
  double align_max_ms = (now_s() - t0) * 1000.0 / (reps / 4);

  t0 = now_s();
  for (int r = 0; r < reps; ++r) sink += pyramid_pass(img, scratch);
  double pyramid_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps; ++r)
    for (int c = 0; c < n_fts * 3 / 2; ++c) sink += reproject_match(img, ref_patch);
  double reproject_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps; ++r)
    for (int s = 0; s < n_seeds; ++s)
      sink += seed_line_stereo(img, ref_patch, rmean, rvar, epl_steps);
  double stereo_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps; ++r)
    sink += undistort_remap(img, map_base, map_frac, remap_out);
  double remap_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps; ++r)
    sink += pose_optimizer_pass(n_fts, n_pose_iter, pose_pts.data(),
                                pose_obs.data());
  double poseopt_ms = (now_s() - t0) * 1000.0 / reps;

  t0 = now_s();
  for (int r = 0; r < reps / 4; ++r)
    sink += local_ba_pass(ba_obs, ba_pts, ba_kf, ba_iter, ba_data, ba_w,
                          ba_hcc);
  double ba_ms = (now_s() - t0) * 1000.0 / (reps / 4);
  double ba_amort_ms = ba_ms / kf_interval;

  if (sink == 12345.678) printf("#");  // keep the optimizer honest

  // The reference prints tracking-thread fps (frame_handler_base.cpp:
  // 121-127) — which includes the per-frame undistort remap, the pose
  // optimizer, and (at keyframes) LocalBundleAdjustment, all on the
  // tracking thread; the depth-filter sweep runs in the mapping thread.
  // Anchor = tracking thread (pyramid + coarse align + reprojection
  // matching + remap + pose LM + BA/kf_interval) — everything else
  // (feature management over pointer graphs, covisibility upkeep, locks,
  // allocation churn, g2o graph building) stays EXCLUDED, keeping the
  // anchor reference-favoring.
  double extra_ms = remap_ms + poseopt_ms + ba_amort_ms;
  double track_typ_ms = pyramid_ms + align_typ_ms + reproject_ms + extra_ms;
  double track_max_ms = pyramid_ms + align_max_ms + reproject_ms + extra_ms;
  printf("{\"pyramid_ms\": %.3f, \"align_typical_ms\": %.3f, "
         "\"align_max_ms\": %.3f, \"reproject_ms\": %.3f, "
         "\"stereo_ms\": %.3f, \"remap_ms\": %.3f, \"poseopt_ms\": %.3f, "
         "\"local_ba_ms\": %.3f, \"ba_amortized_ms\": %.3f, "
         "\"kf_interval\": %d, "
         "\"fps_tracking_typical\": %.2f, \"fps_tracking_max_iters\": %.2f, "
         "\"fps_serial_with_mapping\": %.2f, "
         "\"n_fts\": %d, \"n_levels\": %d, \"iters_typical\": %d, "
         "\"iters_max\": %d, \"n_seeds\": %d, \"epl_steps\": %d}\n",
         pyramid_ms, align_typ_ms, align_max_ms, reproject_ms, stereo_ms,
         remap_ms, poseopt_ms, ba_ms, ba_amort_ms, kf_interval,
         1000.0 / track_typ_ms, 1000.0 / track_max_ms,
         1000.0 / (track_typ_ms + stereo_ms),
         n_fts, n_levels, iters_typical, iters_max, n_seeds, epl_steps);
  return 0;
}
