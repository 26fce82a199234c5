// Host-side data tier of nf_tpu_torch: toy-density batch samplers, epoch
// shuffling and row gathers behind a plain extern "C" ABI, loaded through
// ctypes (nf_tpu_torch/data/native.py).  The port's own copy of nf_tpu's
// native/sampler.cpp: the same formulas, the same RNG and the same ABI
// (version 1), so for a seed it draws the batches nf_tpu's library draws.
// The numpy samplers in nf_tpu_torch/data/toy.py are the other tier.
//
// RNG: splitmix64 -> xoshiro256++, one stream per call seeded explicitly —
// deterministic given (seed), independent of call order.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Rng {
  uint64_t s[4];

  static uint64_t splitmix64(uint64_t& x) {
    x += 0x9E3779B97f4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }

  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) s[i] = splitmix64(x);
  }

  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }

  uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }

  // standard normal (Box-Muller, cached second value)
  bool has_cache = false;
  double cache = 0.0;
  double normal() {
    if (has_cache) {
      has_cache = false;
      return cache;
    }
    double u1 = uniform(), u2 = uniform();
    while (u1 <= 1e-300) u1 = uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    double a = 6.283185307179586 * u2;
    cache = r * std::sin(a);
    has_cache = true;
    return r * std::cos(a);
  }

  uint64_t below(uint64_t n) { return next() % n; }
};

constexpr double kTau = 6.283185307179586;

}  // namespace

extern "C" {

// Two concentric circles, noise 0.08, scaled 0.6 -> out[n*2]
void sample_circles(float* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  int64_t n_out = n / 2;
  for (int64_t i = 0; i < n; i++) {
    double t = rng.uniform() * kTau;
    double r = (i < n_out) ? 1.0 : 0.5;
    double x = r * std::cos(t) + rng.normal() * 0.08;
    double y = r * std::sin(t) + rng.normal() * 0.08;
    out[2 * i] = static_cast<float>(x * 0.6);
    out[2 * i + 1] = static_cast<float>(y * 0.6);
  }
}

// Two half-moons, noise 0.08, then (v - 0.5) / 2 -> out[n*2]
void sample_moons(float* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  int64_t n_a = n / 2;
  for (int64_t i = 0; i < n; i++) {
    double t = rng.uniform() * 3.141592653589793;
    double x, y;
    if (i < n_a) {
      x = std::cos(t);
      y = std::sin(t);
    } else {
      x = 1.0 - std::cos(t);
      y = -std::sin(t) + 0.5;
    }
    x += rng.normal() * 0.08;
    y += rng.normal() * 0.08;
    out[2 * i] = static_cast<float>((x - 0.5) / 2.0);
    out[2 * i + 1] = static_cast<float>((y - 0.5) / 2.0);
  }
}

// Ring of 8 gaussians, radius 0.7, sigma 0.1 -> out[n*2]
void sample_normals(float* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = rng.below(8);
    double cx = 0.7 * std::cos(kTau * k / 8.0);
    double cy = 0.7 * std::sin(kTau * k / 8.0);
    out[2 * i] = static_cast<float>(cx + rng.normal() * 0.1);
    out[2 * i + 1] = static_cast<float>(cy + rng.normal() * 0.1);
  }
}

// Swiss roll (sklearn formula), noise 0.08, reference scalings -> out[n*3]
void sample_swiss(float* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; i++) {
    double t = 1.5 * 3.141592653589793 * (1.0 + 2.0 * rng.uniform());
    double x = t * std::cos(t) + rng.normal() * 0.08;
    double y = 21.0 * rng.uniform() + rng.normal() * 0.08;
    double z = t * std::sin(t) + rng.normal() * 0.08;
    out[3 * i] = static_cast<float>(x * 0.07);
    out[3 * i + 1] = static_cast<float>(y * 0.07 - 1.0);
    out[3 * i + 2] = static_cast<float>(z * 0.07);
  }
}

// S-curve (sklearn formula), noise 0.08, reference scalings -> out[n*3]
void sample_s_curve(float* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; i++) {
    double t = 3.0 * 3.141592653589793 * (rng.uniform() - 0.5);
    double x = std::sin(t) + rng.normal() * 0.08;
    double y = 2.0 * rng.uniform() + rng.normal() * 0.08;
    double z = (t >= 0 ? 1.0 : -1.0) * (std::cos(t) - 1.0) + rng.normal() * 0.08;
    out[3 * i] = static_cast<float>(x * 0.7);
    out[3 * i + 1] = static_cast<float>((y - 1.0) * 0.7);
    out[3 * i + 2] = static_cast<float>(z * 0.35);
  }
}

// Fisher-Yates permutation of [0, n) -> out[n]
void shuffled_indices(int64_t* out, int64_t n, uint64_t seed) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; i++) out[i] = i;
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = static_cast<int64_t>(rng.below(static_cast<uint64_t>(i + 1)));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// Gather rows: dst[i, :] = src[idx[i], :], row_len floats per row
void gather_rows(float* dst, const float* src, const int64_t* idx,
                 int64_t n_rows, int64_t row_len) {
  for (int64_t i = 0; i < n_rows; i++) {
    std::memcpy(dst + i * row_len, src + idx[i] * row_len,
                sizeof(float) * static_cast<size_t>(row_len));
  }
}

int nf_tpu_native_abi_version() { return 1; }

}  // extern "C"
