"""Profiling: named sections, the section timer and the run's trace
(`armon_tpu/utils/profiling.py`).

- `Timer`: nested section times, reported in `SolverStats.timer` as
  ``{name: {"seconds", "calls"}}`` (the JAX package's report);
- `section(...)`: a `torch.profiler.record_function` scope, so the
  section is named in a trace, that also times the section on the host
  clock; with ``time_async=False`` it synchronizes the device of
  `sync_args` before it stops the clock;
- `trace(log_dir)`: a `torch.profiler.profile` of the run (CPU activity,
  and CUDA activity on the card, after a few warm-up launches whose
  records the trace may lose) written under `log_dir` as a Chrome
  trace;
- `kernel_times(prof)`: the per-kernel table of such a profile, the
  counterpart of the JAX package's `utils/xplane.parse_kernel_times`.
"""

import contextlib
import os
import time
from collections import OrderedDict

import torch


class Timer:
    """Nested section-time accumulator (TimerOutputs analog)."""

    def __init__(self):
        self.times = OrderedDict()   # name -> [total_seconds, calls]
        self._stack = []

    def push(self, name):
        self._stack.append((name, time.perf_counter()))

    def pop(self):
        name, t0 = self._stack.pop()
        path = "/".join(n for n, _ in self._stack) or ""
        key = f"{path}/{name}" if path else name
        entry = self.times.setdefault(key, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += 1

    def report(self) -> dict:
        return {k: {"seconds": v[0], "calls": v[1]}
                for k, v in self.times.items()}


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def _hard_sync(tree):
    """Wait for the device that holds the first tensor of `tree` (a
    tensor, or lists and NamedTuples of them)."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


@contextlib.contextmanager
def section(name, timer: Timer = None, sync_args=None, time_async=True):
    """Named scope + optional host timing. With `time_async=False`, waits
    for the device of `sync_args` (tensors, or a zero-argument callable
    returning them) before closing the timer, the reference's per-section
    device barrier (`src/profiling.jl:86-88`)."""
    if timer is not None:
        timer.push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if timer is not None:
            if not time_async and sync_args is not None:
                _hard_sync(sync_args() if callable(sync_args) else sync_args)
            timer.pop()


# Small launches made on the card under a new trace before the traced
# work. On an H100 (torch 2.11, CUDA 12.8) a trace held no device record
# of its first three launches, whatever the card's idle time before them
# (0-100 ms): the per-cycle driver's K3 and first cycle, when its loop
# was built before the trace. Four or more small launches first took
# that loss (`tools/trace_whole.py --driver`).
WARM_LAUNCHES = 16


@contextlib.contextmanager
def trace(log_dir, device="cpu", warm=WARM_LAUNCHES):
    """Profile of the enclosed work, CPU activity and, when `device` is a
    CUDA device, the card's kernels and copies, after `warm` small
    launches on the card under the profile (in a `trace_warm_up`
    section; their kernels stay in the trace); yields the
    `torch.profiler.profile`, and on exit writes it as a Chrome trace
    (``trace_<pid>_<ns>.json``) under `log_dir`."""
    from torch.profiler import profile, ProfilerActivity
    activities = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda and warm:
            with torch.profiler.record_function("trace_warm_up"):
                x = torch.zeros(1, device=device)
                for _ in range(warm):
                    x.add_(1)
                torch.cuda.synchronize(device)
        yield prof
    prof.export_chrome_trace(os.path.join(
        str(log_dir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


def kernel_times(prof) -> "OrderedDict":
    """{name: {"seconds", "calls"}} of a finished `trace`, seconds first:
    each CUDA kernel's and copy's device self time under the name CUPTI
    reports, where the profile saw the card; otherwise each CPU op's self
    time (the named sections left out)."""
    events = [e for e in prof.key_averages()
              if not getattr(e, "is_user_annotation", False)]
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if cuda:
        rows = [(e.key, e.self_device_time_total
                 if hasattr(e, "self_device_time_total")
                 else e.self_cuda_time_total, e.count) for e in cuda]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count) for e in events]
    rows.sort(key=lambda r: -r[1])
    return OrderedDict((k, {"seconds": us / 1e6, "calls": n})
                       for k, us, n in rows)
