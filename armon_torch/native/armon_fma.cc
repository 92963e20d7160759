// Exactly rounded fused multiply-add over arrays, for CPU tensors: the
// plain versions and the op path contract a product into a sum where the
// JAX package's XLA program does (`armon_torch/ops/fma.py`). `std::fma`
// rounds once, in hardware or in the C library's exact emulation.
//
// Plain C ABI, loaded via ctypes; built with the host `c++` on first use
// into build/armon_torch/ (`armon_torch/ops/_build.py` `load_fma`).

#include <cmath>

extern "C" {

void armon_fma_f64(const double* a, const double* b, const double* c,
                   double* out, long n) {
    for (long i = 0; i < n; ++i) out[i] = std::fma(a[i], b[i], c[i]);
}

void armon_fma_f32(const float* a, const float* b, const float* c,
                   float* out, long n) {
    for (long i = 0; i < n; ++i) out[i] = std::fma(a[i], b[i], c[i]);
}

}  // extern "C"
