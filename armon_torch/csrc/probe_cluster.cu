// The cluster probe's kernels (probes/cluster.py): K5 `multicycle` as one
// thread-block cluster, f32 (exact and fast-math divides) and f64 (exact).
// Kernel body and design notes: cluster.cuh.
#include "cluster.cuh"

extern "C" int armon_cluster_f32(const armon::McArgs* m, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return m->fast ? armon::dispatch_cluster<float, true>(m, s, nullptr)
                 : armon::dispatch_cluster<float, false>(m, s, nullptr);
}

extern "C" int armon_cluster_f64(const armon::McArgs* m, void* stream) {
  if (m->fast) return -1;  // no approximate-reciprocal mode in f64
  return armon::dispatch_cluster<double, false>(m, reinterpret_cast<cudaStream_t>(stream),
                                                nullptr);
}

// out: clusters of this plan the card holds at once, threads a CTA,
// registers a thread, local memory bytes a thread (spills).
extern "C" int armon_cluster_occupancy_f32(const armon::McArgs* m, int* out) {
  return m->fast ? armon::dispatch_cluster<float, true>(m, nullptr, out)
                 : armon::dispatch_cluster<float, false>(m, nullptr, out);
}

extern "C" int armon_cluster_occupancy_f64(const armon::McArgs* m, int* out) {
  if (m->fast) return -1;
  return armon::dispatch_cluster<double, false>(m, nullptr, out);
}
