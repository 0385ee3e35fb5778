// Periodic cell-list neighbor search on the host: the candidate half of
// cgnn_tpu_torch/data/neighbors.py's native backend.
//
// A periodic CELL LIST in fractional space, O(n * density * r^3) instead
// of the O(n^2 * images) of the vectorized numpy search: each axis is
// split into M_k bins (M_k ~ min(1 / frac_range_k, cbrt(4n)) so bins stay
// populated), and per center atom only the bins within the fractional
// search range are scanned. A scanned bin index may run past [0, M_k):
// the floor-division quotient IS the periodic image of the atoms in that
// bin, so a small cell (bin span > one period) turns into an image loop.
//
// What it returns is integer CANDIDATES, not distances: every (center i,
// neighbor j, image (a, b, c)) whose distance is within `radius` (the
// caller passes its cut plus a margin), with |a| <= na, |b| <= nb,
// |c| <= nc and the home-image self pair left out, sorted by (i, j, a,
// b, c) ascending. That is the order in which the numpy search emits its
// pairs (centre, then neighbour, then image in np.mgrid order); the
// caller recomputes each candidate's distance with the numpy search's own
// arithmetic and applies its cut, so both backends give the same bits in
// the same order.
//
// The caller passes the wrapped fractional coordinates (in [0, 1)) and
// their Cartesian positions, computed once in Python, so the binning and
// the images refer to the same wrapped positions as the numpy search.
//
// C ABI only (loaded with ctypes). Returns the candidate count, -needed
// when `cap` is too small (the caller retries with that capacity), or -1
// on bad input (a singular cell, a non-positive radius).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// inverse of a row-major 3x3 matrix; false if singular
bool invert3(const double* m, double* inv) {
  const double a = m[0], b = m[1], c = m[2];
  const double d = m[3], e = m[4], f = m[5];
  const double g = m[6], h = m[7], i = m[8];
  const double det =
      a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-300) return false;
  const double s = 1.0 / det;
  inv[0] = (e * i - f * h) * s;
  inv[1] = (c * h - b * i) * s;
  inv[2] = (b * f - c * e) * s;
  inv[3] = (f * g - d * i) * s;
  inv[4] = (a * i - c * g) * s;
  inv[5] = (c * d - a * f) * s;
  inv[6] = (d * h - e * g) * s;
  inv[7] = (b * g - a * h) * s;
  inv[8] = (a * e - b * d) * s;
  return true;
}

struct Cand {
  int32_t j, a, b, c;
  bool operator<(const Cand& o) const {
    if (j != o.j) return j < o.j;
    if (a != o.a) return a < o.a;
    if (b != o.b) return b < o.b;
    return c < o.c;
  }
};

// Euclidean floor division: quotient -> image offset, remainder -> bin
inline int floordiv(int x, int m, int* rem) {
  int q = x / m, r = x % m;
  if (r < 0) {
    r += m;
    --q;
  }
  *rem = r;
  return q;
}

}  // namespace

extern "C" {

// lattice: [9] row-major (rows are lattice vectors, row-vector convention)
// frac:    [n*3] wrapped fractional coordinates, each in [0, 1]
// cart:    [n*3] their Cartesian positions (frac @ lattice)
// images:  [3] na, nb, nc: the largest |image| per axis kept
// outputs: centers/neighbors [cap], offsets [cap*3]
long long cgnn_torch_neighbor_candidates(
    const double* lattice, const double* frac, const double* cart,
    long long n, double radius, const int32_t* images, long long cap,
    int32_t* centers, int32_t* neighbors, int32_t* offsets) {
  if (n <= 0 || !(radius > 0.0)) return -1;
  double inv[9];
  if (!invert3(lattice, inv)) return -1;

  // fractional search range per axis: any |v| <= radius has
  // |frac_k| = |v . inv[:, k]| <= radius * ||inv[:, k]||
  double frange[3];
  for (int k = 0; k < 3; ++k) {
    const double norm = std::sqrt(inv[k] * inv[k] + inv[k + 3] * inv[k + 3] +
                                  inv[k + 6] * inv[k + 6]);
    frange[k] = radius * norm;
  }

  // bins per axis: at most one bin per frange (so the stencil stays +-R
  // with R small), capped near cbrt(4n) so bins stay populated
  const int mcap = std::max(
      1, static_cast<int>(std::cbrt(4.0 * static_cast<double>(n))) + 1);
  int M[3], R[3];
  for (int k = 0; k < 3; ++k) {
    const int m =
        frange[k] > 0 ? static_cast<int>(std::floor(1.0 / frange[k])) : mcap;
    M[k] = std::max(1, std::min(m, mcap));
    // stencil half-width: bin distance <= M * frange + 1 (floor rounding)
    R[k] = static_cast<int>(std::floor(frange[k] * M[k])) + 1;
  }
  const long long nbins = static_cast<long long>(M[0]) * M[1] * M[2];

  // linked-list cell bins; a coordinate of exactly 1.0 goes to the last bin
  std::vector<int32_t> head(static_cast<size_t>(nbins), -1);
  std::vector<int32_t> nxt(static_cast<size_t>(n), -1);
  std::vector<int32_t> bin_of(static_cast<size_t>(n) * 3);
  for (long long i = 0; i < n; ++i) {
    int b[3];
    for (int k = 0; k < 3; ++k) {
      b[k] = static_cast<int>(frac[i * 3 + k] * M[k]);
      if (b[k] >= M[k]) b[k] = M[k] - 1;
      if (b[k] < 0) b[k] = 0;
      bin_of[i * 3 + k] = b[k];
    }
    const long long flat =
        (static_cast<long long>(b[0]) * M[1] + b[1]) * M[2] + b[2];
    nxt[i] = head[flat];
    head[flat] = static_cast<int32_t>(i);
  }

  const double r2 = radius * radius;
  long long count = 0;
  std::vector<Cand> found;
  for (long long i = 0; i < n; ++i) {
    found.clear();
    const double xi = cart[i * 3], yi = cart[i * 3 + 1], zi = cart[i * 3 + 2];
    const int bi0 = bin_of[i * 3], bi1 = bin_of[i * 3 + 1],
              bi2 = bin_of[i * 3 + 2];
    for (int da = -R[0]; da <= R[0]; ++da) {
      int ba;
      const int ma = floordiv(bi0 + da, M[0], &ba);
      if (ma < -images[0] || ma > images[0]) continue;
      for (int db = -R[1]; db <= R[1]; ++db) {
        int bb;
        const int mb = floordiv(bi1 + db, M[1], &bb);
        if (mb < -images[1] || mb > images[1]) continue;
        for (int dc = -R[2]; dc <= R[2]; ++dc) {
          int bc;
          const int mc = floordiv(bi2 + dc, M[2], &bc);
          if (mc < -images[2] || mc > images[2]) continue;
          const double sx = ma * lattice[0] + mb * lattice[3] + mc * lattice[6];
          const double sy = ma * lattice[1] + mb * lattice[4] + mc * lattice[7];
          const double sz = ma * lattice[2] + mb * lattice[5] + mc * lattice[8];
          const bool home = ma == 0 && mb == 0 && mc == 0;
          const long long flat =
              (static_cast<long long>(ba) * M[1] + bb) * M[2] + bc;
          for (int32_t j = head[flat]; j >= 0; j = nxt[j]) {
            if (home && j == i) continue;
            const double dx = cart[j * 3] + sx - xi;
            const double dy = cart[j * 3 + 1] + sy - yi;
            const double dz = cart[j * 3 + 2] + sz - zi;
            if (dx * dx + dy * dy + dz * dz <= r2) {
              found.push_back({j, ma, mb, mc});
            }
          }
        }
      }
    }
    // the numpy search's order: neighbour, then image (a, b, c)
    std::sort(found.begin(), found.end());
    for (const Cand& f : found) {
      if (count < cap) {
        centers[count] = static_cast<int32_t>(i);
        neighbors[count] = f.j;
        offsets[count * 3] = f.a;
        offsets[count * 3 + 1] = f.b;
        offsets[count * 3 + 2] = f.c;
      }
      ++count;
    }
  }
  if (count > cap) return -count;
  return count;
}

}  // extern "C"
