// Measurement variants of K4 `cycle` for the cycle probe
// (armon_torch/probes/cycle_variants.py): the instances of `cycle_kernel`
// (cycle.cuh) with a `CycleVariant` other than the production CV_BASE,
// and CV_BASE itself at K4's tile (L = 64) and at K5's (L = 32).
//
// Replaces `run_variant` (scripts/perf_probe.py:126, `variant_kernel` :50,
// `pl.pallas_call` :158). The TPU probe ran a copy of the round-2 fused
// cycle; these are K4 itself, the same template with one compile-time
// switch, so what they attribute is K4's time. The script's `chunk=K`
// sensitivity becomes the L = 32 instance (24 x 24 output tiles on 32 x 32
// windows; the two sweeps cover (L^2 + R L) / (2 R^2) = 1.56x the tile's
// cells against L = 64's 1.22x), and `first_order` is
// CV_BASE with Godunov + euler as runtime arguments.
//
// Bound on this card: as K4, bytes: 36 B/cell in f32 (32 without p).
// f32 only (the script's type), perfect gas, exact and fast-math divides.

#include "cycle.cuh"

namespace armon {

template <bool FAST, int V, int L = CYCLE_L>
int launch_variant(const CycleArgs* a, cudaStream_t s) {
  const int err = check_tile_geometry(a, L, a->emit != 0 && cv_dt(V));
  if (err) return err;
  return launch_cycle<float, FAST, false, L, V>(*a, s);
}

template <bool FAST>
int dispatch_variant(int variant, int tile, const CycleArgs* a, cudaStream_t s) {
  if (tile == MULTI_L) return variant == CV_BASE ? launch_variant<FAST, CV_BASE, MULTI_L>(a, s) : -1;
  if (tile != CYCLE_L) return -1;
  switch (variant) {
    case CV_BASE: return launch_variant<FAST, CV_BASE>(a, s);
    case CV_NO_P: return launch_variant<FAST, CV_NO_P>(a, s);
    case CV_NO_DT: return launch_variant<FAST, CV_NO_DT>(a, s);
    case CV_NO_P_DT: return launch_variant<FAST, CV_NO_P_DT>(a, s);
    case CV_NO_ROLL: return launch_variant<FAST, CV_NO_ROLL>(a, s);
    case CV_STREAM: return launch_variant<FAST, CV_STREAM>(a, s);
    default: return -1;
  }
}

}  // namespace armon

extern "C" int armon_cycle_variant_f32(int variant, int tile, const armon::CycleArgs* a,
                                       void* stream) {
  if (a->biz) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch_variant<true>(variant, tile, a, s)
                 : armon::dispatch_variant<false>(variant, tile, a, s);
}
