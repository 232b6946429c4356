// Checkpoint ingestion fast path: bf16 widening and layout transposes.
//
// Role: the native side of stabletriton_jax/io — the reference delegated all
// native-code work to external deps (torch, safetensors-rust; SURVEY.md §2.6),
// this framework ships its own. A 2.57B-param SDXL checkpoint crosses this
// code once at load: widen bf16 -> f32 and convert torch layouts
// ((out,in) -> (in,out) 2D transpose, OIHW -> HWIO 4D permute) into the
// channels-last layout the models consume.
//
// C ABI only (consumed via ctypes). Threaded over the largest axis.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned n_workers(size_t work_items, size_t min_per_worker) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  size_t by_work = work_items / min_per_worker;
  if (by_work < 1) by_work = 1;
  return static_cast<unsigned>(by_work < hw ? by_work : hw);
}

template <typename F>
void parallel_for(size_t n, size_t min_chunk, F f) {
  unsigned workers = n_workers(n, min_chunk);
  if (workers <= 1) {
    f(0, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (n + workers - 1) / workers;
  for (unsigned w = 0; w < workers; ++w) {
    size_t lo = w * chunk;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { f(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// bf16 (as uint16 payload) -> f32: place the 16 stored bits in the high half.
void st_bf16_to_f32(const uint16_t* in, float* out, int64_t n) {
  parallel_for(static_cast<size_t>(n), 1 << 20, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      uint32_t bits = static_cast<uint32_t>(in[i]) << 16;
      std::memcpy(&out[i], &bits, 4);
    }
  });
}

// f16 -> f32 widening (IEEE half), scalar portable implementation.
void st_f16_to_f32(const uint16_t* in, float* out, int64_t n) {
  parallel_for(static_cast<size_t>(n), 1 << 20, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      uint16_t h = in[i];
      uint32_t sign = (h & 0x8000u) << 16;
      uint32_t exp = (h >> 10) & 0x1f;
      uint32_t mant = h & 0x3ffu;
      uint32_t bits;
      if (exp == 0) {
        if (mant == 0) {
          bits = sign;  // +-0
        } else {  // subnormal: normalize
          int e = -1;
          do {
            mant <<= 1;
            ++e;
          } while (!(mant & 0x400u));
          bits = sign | ((127 - 15 - e) << 23) | ((mant & 0x3ffu) << 13);
        }
      } else if (exp == 0x1f) {
        bits = sign | 0x7f800000u | (mant << 13);  // inf/nan
      } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
      }
      std::memcpy(&out[i], &bits, 4);
    }
  });
}

// (rows, cols) -> (cols, rows), cache-blocked.
void st_transpose_2d(const float* in, float* out, int64_t rows, int64_t cols) {
  const int64_t B = 64;
  parallel_for(static_cast<size_t>((rows + B - 1) / B), 1, [&](size_t lo, size_t hi) {
    for (size_t rb = lo; rb < hi; ++rb) {
      int64_t r0 = static_cast<int64_t>(rb) * B;
      int64_t r1 = r0 + B < rows ? r0 + B : rows;
      for (int64_t c0 = 0; c0 < cols; c0 += B) {
        int64_t c1 = c0 + B < cols ? c0 + B : cols;
        for (int64_t r = r0; r < r1; ++r)
          for (int64_t c = c0; c < c1; ++c) out[c * rows + r] = in[r * cols + c];
      }
    }
  });
}

// torch conv OIHW -> HWIO.
void st_oihw_to_hwio(const float* in, float* out, int64_t O, int64_t I, int64_t H,
                     int64_t W) {
  parallel_for(static_cast<size_t>(O), 8, [&](size_t lo, size_t hi) {
    for (size_t o = lo; o < hi; ++o)
      for (int64_t i = 0; i < I; ++i)
        for (int64_t h = 0; h < H; ++h)
          for (int64_t w = 0; w < W; ++w)
            out[((h * W + w) * I + i) * O + static_cast<int64_t>(o)] =
                in[((static_cast<int64_t>(o) * I + i) * H + h) * W + w];
  });
}

}  // extern "C"
