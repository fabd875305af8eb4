// The C library's float32 atan2 over an array, for the visual-field
// projection's plain CPU path (trex_tpu_torch/ops/raycast.py).
//
// The JAX package's jitted projection calls the process's scalar atan2f
// for every (eye, point) pair; ATen's CPU atan2 is a vectorised
// approximation that departs from it in the last bit on many inputs,
// which moves points across angular bins. Calling atan2f here
// gives the JAX package's angles on the same host. No vector variant
// is used: without -ffast-math the compiler keeps the scalar call.
#include <cmath>
#include <cstdint>

extern "C" {

void trex_atan2f(const float* y, const float* x, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = ::atan2f(y[i], x[i]);
}

}  // extern "C"
