// Measurement variants of K4 `cycle` for the cycle probe
// (armon_torch/probes/cycle_variants.py): the instances of `cycle_kernel`
// (cycle.cuh) with a `CycleVariant` other than the production CV_BASE,
// CV_BASE itself; `base_w128`, CV_BASE on 96 x 128 windows at one block
// of 16 warps per SM (less halo recompute, half the resident warps); and
// `base_l32`, the per-position tile body (`cycle_tile` on 32 x 32 windows,
// K5's before its redesign) as a
// one-cycle kernel: K4's redesigned body has no 32-wide form.
//
// Replaces `run_variant` (scripts/perf_probe.py:126, `variant_kernel` :50,
// `pl.pallas_call` :158). The TPU probe ran a copy of the round-2 fused
// cycle; these are K4 itself, the same template with one compile-time
// switch, so what they attribute is K4's time. The script's `chunk=K`
// sensitivity becomes `base_l32` (24 x 24 output tiles on 32 x 32
// windows; the two sweeps cover (L^2 + R L) / (2 R^2) = 1.56x the tile's
// cells against K4's 1.195x and base_w128's 1.115x), and `first_order` is
// CV_BASE with Godunov +
// euler as runtime arguments.
//
// Bound on this card: as K4, bytes: 36 B/cell in f32 (32 without p).
// f32 only (the script's type), perfect gas, exact and fast-math divides.

#include "cycle.cuh"

namespace armon {

template <bool FAST, int V, typename G = K4<float>>
int launch_variant(const CycleArgs* a, cudaStream_t s) {
  const int err = check_tile_geometry(a, G::RX, G::RY, a->emit != 0 && cv_dt(V));
  if (err) return err;
  return launch_cycle<float, FAST, false, V, G>(*a, s);
}

template <bool FAST>
int dispatch_variant(int variant, int tile, const CycleArgs* a, cudaStream_t s) {
  if (tile == BASE_L) {
    constexpr int R = BASE_L - 2 * HALO;
    if (variant != CV_BASE) return -1;
    const int err = check_tile_geometry(a, R, R, a->emit != 0);
    return err ? err : launch_tile<float, FAST, false, BASE_L>(*a, s);
  }
  if (tile == 128)
    return variant == CV_BASE ? launch_variant<FAST, CV_BASE, K4Shape<float, 3, 4, 16, 1>>(a, s)
                              : -1;
  if (tile != 0) return -1;
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

// `tile`: 0 for K4's geometry, 128 for its 96 x 128 windows (base_w128),
// 32 for the per-position tile body (base_l32).
extern "C" int armon_cycle_variant_f32(int variant, int tile, const armon::CycleArgs* a,
                                       void* stream) {
  if (a->biz) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch_variant<true>(variant, tile, a, s)
                 : armon::dispatch_variant<false>(variant, tile, a, s);
}
