"""What every timed row shares, in `chip_smoke.py` and the probes alike:
the device check, the card line, CUDA-event timing, and the bound of a
measured function on this card."""

import json
import shutil
import subprocess

import torch

# H100 SXM data-sheet peaks (dense, no sparsity) and the rates derived
# from them: 3.35 TB/s of HBM; 67 TFLOP/s f32 and 34 TFLOP/s f64 outside
# the tensor cores count a fused multiply-add as two operations, so one
# instruction per lane and clock is 33.5e12 f32 and 17e12 f64 lane-ops/s;
# the special-function unit (MUFU: rcp, rsqrt, ...) issues 16 of the
# SM's 128 lanes per clock, 1/8 of the f32 rate; shared-memory loads and
# stores and warp shuffles (`lsu`) 32, 1/4 (CUDA C++ Programming Guide,
# throughput of native instructions, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = {"float32": 33.5e12, "float64": 17e12, "mufu": 33.5e12 / 8,
                  "lsu": 33.5e12 / 4}
NOT_MEASURED = "not measured"
# A chain of dependent f32 adds: 4 cycles each (the latency of FADD on
# compute capability 9.0) at the H100 SXM's 1980 MHz top SM clock.
ADD_CHAIN_S = 4 / 1.98e9


def device_of(device):
    """`device` as a torch.device; raises for a CUDA device without a
    card (a probe never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card; pass device='cpu' "
                           "(--device cpu) for the plain versions")
    return dev


def card_line():
    """The card's name and power limit as nvidia-smi gives them, or the
    device name where nvidia-smi is missing."""
    if shutil.which("nvidia-smi"):
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def time_ms(fn, device="cuda", k=20, passes=3, reset=None):
    """Best over `passes` of the CUDA-event time per call of `k` calls
    ``fn(i)``, after one warm-up call; None on the CPU. A spin kernel
    queued ahead of each pass lets the host enqueue the pass before it
    runs, so host launch time does not leak into a call's. With `reset`,
    ``reset()`` runs before every call, outside the timed interval (each
    call then has its own pair of events): every call sees the same
    inputs, where a call updates its inputs in place. A reset and two
    events cost the host more than a short call takes on the card, so the
    spin then lasts about half a millisecond per call."""
    if torch.device(device).type != "cuda":
        return None
    if reset is not None:
        reset()
    fn(0)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(k if reset is not None else 1)]
        torch.cuda._sleep(min(int(k * (1e5 if reset is None else 1e6)), int(2e9)))
        if reset is None:
            events[0][0].record()
            for i in range(k):
                fn(i)
            events[0][1].record()
        else:
            for i, (start, end) in enumerate(events):
                reset()
                start.record()
                fn(i)
                end.record()
        torch.cuda.synchronize()
        best = min(best, sum(s.elapsed_time(e) for s, e in events) / k)
    return best


def bound(nbytes, lane_ops=None):
    """(least ms, "bytes" or "operations"): the larger of `nbytes` over
    the HBM rate and the lane operations, a dict {rate key: count}, over
    their rates."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = sum(n / LANE_OPS_PER_S[key] for key, n in (lane_ops or {}).items()) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def chain_ms(n_adds):
    """The least ms of `n_adds` dependent f32 adds (`ADD_CHAIN_S` each)."""
    return n_adds * ADD_CHAIN_S * 1e3


def shown(ms):
    return NOT_MEASURED if ms is None else ms


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
                 library_ms=None):
    """One entry of `chip_smoke.py`'s kernels line; `library_ms` is the
    time of one PyTorch call that computes the same function, where there
    is one."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}
