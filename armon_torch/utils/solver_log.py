"""Per-cycle solver log and statistics (`armon_tpu/utils/solver_log.py`).

The analog of the reference's block-log subsystem (`log_blocks=true`,
`src/solver_state.jl:230-263`, summarized by `src/logging.jl:75-300`):
per-cycle wall times, t and dt, the sections of a cycle timed apart
(`core/solver.measure_sections`) and, on a traced run, the trace's
per-kernel device times (`utils/profiling.kernel_times`).
"""

import math
from dataclasses import dataclass, field
from typing import List

# The kernel and copy names that are communication between the shards of a
# mesh in a trace on the card (the MPI-wait-fraction analog): the halo
# slab copies of `parallel/halo.py`. Matched case-insensitively.
# - "CatArrayBatchedCopy": `_pack`'s `torch.stack(lines, out=slab)` on one
#   card, PyTorch's `cat` kernel (CatArrayBatchedCopy, _contig and
#   _aligned variants) packing a neighbour's four line blocks into a slab.
#   Every other `torch.stack` on the card runs it too, such as the op
#   path's per-cycle read of three scalars in the per-cycle driver.
# - "Memcpy PtoP": `_pack`'s `copy_` of the line blocks from a shard on
#   another card (a peer-to-peer copy, "Memcpy PtoP (Device -> Device)").
_COLLECTIVE_MARKERS = ("catarraybatchedcopy", "memcpy ptop")


def _is_collective(kernel_name: str) -> bool:
    n = kernel_name.lower()
    return any(m in n for m in _COLLECTIVE_MARKERS)


@dataclass
class CycleLogEvent:
    cycle: int
    t: float
    dt: float
    wall_seconds: float


@dataclass
class SolverLog:
    cell_count: int
    events: List[CycleLogEvent] = field(default_factory=list)
    # {section: seconds} from core.solver.measure_sections: the cycle's
    # pieces timed apart on copies of the final state, indicative shares,
    # not additive to the in-loop cycle time.
    sections: dict = field(default_factory=dict)
    # {kernel: {"seconds", "calls"}} from the run's own trace
    # (`utils/profiling.kernel_times`, set when `profiling=['trace']`).
    trace_sections: dict = field(default_factory=dict)

    def push(self, cycle, t, dt, wall_seconds):
        self.events.append(CycleLogEvent(cycle, t, dt, wall_seconds))

    def analyse(self) -> dict:
        """Summary stats (mean/σ cycle time, throughput, dt range, section
        shares), the `BlockGridLogStats` analog (`src/logging.jl:75-300`)."""
        if not self.events:
            return {"cycles": 0}
        walls = [e.wall_seconds for e in self.events]
        n = len(walls)
        mean = sum(walls) / n
        var = sum((w - mean) ** 2 for w in walls) / n
        out = {
            "cycles": n,
            "mean_cycle_seconds": mean,
            "std_cycle_seconds": math.sqrt(var),
            "min_cycle_seconds": min(walls),
            "max_cycle_seconds": max(walls),
            "mega_cells_per_sec": self.cell_count / mean / 1e6,
            "dt_first": self.events[0].dt,
            "dt_last": self.events[-1].dt,
            "final_time": self.events[-1].t,
        }
        if n >= 4:
            # Per-half mean/σ and the relative drift of the cycle time.
            h = n // 2
            first, second = walls[:h], walls[n - h:]
            m1, m2 = sum(first) / h, sum(second) / h
            out["cycle_time_trend"] = {
                "first_half_mean": m1,
                "second_half_mean": m2,
                "first_half_std": math.sqrt(
                    sum((w - m1) ** 2 for w in first) / h),
                "second_half_std": math.sqrt(
                    sum((w - m2) ** 2 for w in second) / h),
                "drift": (m2 - m1) / mean if mean else 0.0,
            }
        if self.sections:
            tot = sum(self.sections.values())
            out["sections"] = dict(self.sections)
            out["section_shares"] = ({k: v / tot
                                      for k, v in self.sections.items()}
                                     if tot else {})
            out["sections_source"] = "probe"
        if self.trace_sections:
            # The trace's in-loop times replace the probes as `sections`;
            # the probes stay under probe_sections.
            if self.sections:
                out["probe_sections"] = out.pop("sections")
                out["probe_section_shares"] = out.pop("section_shares")
            secs = {k: v["seconds"] for k, v in self.trace_sections.items()}
            tot = sum(secs.values())
            out["sections"] = secs
            out["section_shares"] = ({k: v / tot for k, v in secs.items()}
                                     if tot else {})
            out["trace_kernels"] = dict(self.trace_sections)
            out["sections_source"] = "trace"
            # Communication's share of the traced time: the slab copies'
            # own device time.
            coll = sum(s for k, s in secs.items() if _is_collective(k))
            out["collective_seconds"] = coll
            out["collective_wait_share"] = coll / tot if tot else 0.0
        return out

    def __repr__(self):
        a = self.analyse()
        if a["cycles"] == 0:
            return "SolverLog(empty)"
        return (f"SolverLog({a['cycles']} cycles, "
                f"{a['mean_cycle_seconds']*1e3:.3f}±"
                f"{a['std_cycle_seconds']*1e3:.3f} ms/cycle, "
                f"{a['mega_cells_per_sec']:.1f} Mcells/s)")
