// Native host kernels of scarlet_tpu_torch.
//
// The port's own copy of the JAX package's native/kernels.cc: the C++
// equivalents of the reference's pybind11/Eigen extensions
// (scarlet/operators_pybind11.cc, scarlet/detect_pybind11.cc), exposed
// through a plain C ABI for ctypes binding.  They serve the host-side
// (init-time) paths: the monotonic seeds' sequential sweep and the
// monotonic mask's flood fills, whose data-dependent control flow runs
// best on the host.  Each function has a plain numpy twin in
// scarlet_tpu_torch/native/__init__.py that the tests hold it to.
//
// All flood fills are iterative with explicit stacks: the reference's
// recursive versions can exhaust the C stack on large footprints.
//
// Build: python -m scarlet_tpu_torch.native.build
// (g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off: every product and
// sum rounds on its own, as the numpy twins and the Jacobi projection
// round them, so the sweep equals them bit for bit on every CPU.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Weighted radial monotonicity: sequential sweep over pixels sorted by
// distance from the peak.  Semantics of operators_pybind11.cc:14-36.
// ---------------------------------------------------------------------------
void prox_weighted_monotonic(float* flat_img, const float* weights,
                             const int64_t* offsets, const int64_t* didx,
                             int64_t n_didx, int64_t n_pixels,
                             float min_gradient) {
  const float scale = 1.0f - min_gradient;
  for (int64_t d = 0; d < n_didx; ++d) {
    const int64_t i = didx[d];
    float ref_flux = 0.0f;
    for (int e = 0; e < 8; ++e) {
      const float w = weights[e * n_pixels + i];
      if (w > 0.0f) {
        ref_flux += flat_img[offsets[e] + i] * w;
      }
    }
    flat_img[i] = std::min(flat_img[i], ref_flux * scale);
  }
}

// ---------------------------------------------------------------------------
// Real-space filter: shifted block adds.
// Semantics of operators_pybind11.cc:39-56 (apply_filter).
// ---------------------------------------------------------------------------
void apply_filter(const float* image, const float* values, int64_t n_values,
                  const int64_t* y_start, const int64_t* y_end,
                  const int64_t* x_start, const int64_t* x_end, int64_t height,
                  int64_t width, float* result) {
  std::memset(result, 0, sizeof(float) * height * width);
  for (int64_t n = 0; n < n_values; ++n) {
    const float v = values[n];
    if (v == 0.0f) continue;
    const int64_t rows = height - y_start[n] - y_end[n];
    const int64_t cols = width - x_start[n] - x_end[n];
    for (int64_t r = 0; r < rows; ++r) {
      float* dst = result + (y_start[n] + r) * width + x_start[n];
      const float* src = image + (y_end[n] + r) * width + x_end[n];
      for (int64_t c = 0; c < cols; ++c) dst[c] += v * src[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Monotonic-path flood fill from the center (iterative).
// Semantics of operators_pybind11.cc:61-124 (get_valid_monotonic_pixels).
// ---------------------------------------------------------------------------
static void flood_monotonic(const float* image, int64_t H, int64_t W,
                            int64_t i0, int64_t j0, uint8_t* unchecked,
                            uint8_t* orphans, double variance, int32_t* bounds,
                            double thresh) {
  std::vector<int64_t> stack;
  stack.push_back(i0 * W + j0);
  const int64_t di[4] = {-1, 1, 0, 0};
  const int64_t dj[4] = {0, 0, -1, 1};
  while (!stack.empty()) {
    const int64_t p = stack.back();
    stack.pop_back();
    const int64_t ci = p / W, cj = p % W;
    for (int k = 0; k < 4; ++k) {
      const int64_t ni = ci + di[k], nj = cj + dj[k];
      if (ni < 0 || ni >= H || nj < 0 || nj >= W) continue;
      const int64_t q = ni * W + nj;
      if (!unchecked[q]) continue;
      if (image[q] < image[p] + variance && image[q] > thresh) {
        unchecked[q] = 0;
        orphans[q] = 0;
        bounds[0] = std::min(bounds[0], (int32_t)ni);
        bounds[1] = std::max(bounds[1], (int32_t)ni);
        bounds[2] = std::min(bounds[2], (int32_t)nj);
        bounds[3] = std::max(bounds[3], (int32_t)nj);
        stack.push_back(q);
      } else {
        orphans[q] = 1;
      }
    }
  }
}

void get_valid_monotonic_pixels(const float* image, int64_t H, int64_t W,
                                int64_t i0, int64_t j0, uint8_t* unchecked,
                                uint8_t* orphans, double variance,
                                int32_t* bounds, double thresh) {
  flood_monotonic(image, H, W, i0, j0, unchecked, orphans, variance, bounds,
                  thresh);
}

// ---------------------------------------------------------------------------
// Fill non-monotonic orphans by neighbor-gradient interpolation, continuing
// the flood fill from updated pixels.
// Semantics of operators_pybind11.cc:127-232.
// ---------------------------------------------------------------------------
void linear_interpolate_invalid_pixels(const int64_t* rows,
                                       const int64_t* cols, int64_t n_idx,
                                       uint8_t* unchecked, float* model,
                                       uint8_t* orphans, int64_t H, int64_t W,
                                       double variance, int recursive,
                                       int32_t* bounds) {
  const int64_t di[4] = {1, -1, 0, 0};
  const int64_t dj[4] = {0, 0, 1, -1};
  for (int64_t n = 0; n < n_idx; ++n) {
    const int64_t i = rows[n], j = cols[n];
    if (!unchecked[i * W + j]) continue;
    unchecked[i * W + j] = 0;

    double total = 0.0;
    int valid = 0;
    bool had_unchecked = false;
    for (int k = 0; k < 4; ++k) {
      const int64_t i2 = i + 2 * di[k], j2 = j + 2 * dj[k];
      const int64_t i1 = i + di[k], j1 = j + dj[k];
      if (i2 < 0 || i2 >= H || j2 < 0 || j2 >= W) continue;
      const float m2 = model[i2 * W + j2], m1 = model[i1 * W + j1];
      if (m2 > m1) {
        if (unchecked[i2 * W + j2] || unchecked[i1 * W + j1]) {
          had_unchecked = true;
        } else {
          total += m1 - (m2 - m1);
          valid += 1;
        }
      }
    }
    if (total > 0.0) {
      model[i * W + j] = (float)(total / valid);
      orphans[i * W + j] = 0;
      bounds[0] = std::min(bounds[0], (int32_t)i);
      bounds[1] = std::max(bounds[1], (int32_t)i);
      bounds[2] = std::min(bounds[2], (int32_t)j);
      bounds[3] = std::max(bounds[3], (int32_t)j);
      if (recursive) {
        flood_monotonic(model, H, W, i, j, unchecked, orphans, variance,
                        bounds, 0.0);
      } else {
        for (int k = 0; k < 4; ++k) {
          const int64_t ni = i + di[k], nj = j + dj[k];
          if (ni >= 0 && ni < H && nj >= 0 && nj < W &&
              unchecked[ni * W + nj]) {
            orphans[ni * W + nj] = 1;
          }
        }
      }
    } else if (!had_unchecked) {
      orphans[i * W + j] = 1;
      model[i * W + j] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Connected-component segmentation (4-connectivity, iterative) producing a
// label image.  Semantics of detect_pybind11.cc:17-59 + 241-280; peak
// finding happens vectorized in numpy on top of the labels.
// ---------------------------------------------------------------------------
int64_t label_components(const float* image, int64_t H, int64_t W,
                         double thresh, int32_t* labels) {
  std::memset(labels, 0, sizeof(int32_t) * H * W);
  int32_t current = 0;
  std::vector<int64_t> stack;
  const int64_t di[4] = {-1, 1, 0, 0};
  const int64_t dj[4] = {0, 0, -1, 1};
  for (int64_t p = 0; p < H * W; ++p) {
    if (labels[p] != 0 || !(image[p] > thresh)) continue;
    ++current;
    labels[p] = current;
    stack.push_back(p);
    while (!stack.empty()) {
      const int64_t q = stack.back();
      stack.pop_back();
      const int64_t ci = q / W, cj = q % W;
      for (int k = 0; k < 4; ++k) {
        const int64_t ni = ci + di[k], nj = cj + dj[k];
        if (ni < 0 || ni >= H || nj < 0 || nj >= W) continue;
        const int64_t r = ni * W + nj;
        if (labels[r] == 0 && image[r] > thresh) {
          labels[r] = current;
          stack.push_back(r);
        }
      }
    }
  }
  return current;
}

}  // extern "C"
