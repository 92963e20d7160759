"""Runs over several OS processes over `torch.distributed`: the
counterpart of `_init_distributed` (`armon_tpu/params.py:47-70`) and of
`multihost_utils.sync_global_devices` (`armon_tpu/io/restart.py:154-163`).

Each process drives a contiguous block of the mesh's shards
(`parallel/mesh.py`). The transport follows from the options
(`backend_for`), never from catching a failure:

- NCCL between cards;
- gloo on the CPU, and on cards with ``gpu_aware=False`` (the reference's
  knob for an MPI that cannot read device buffers): a CUDA tensor goes
  through a contiguous host copy, so each exchange and each gather waits
  for the device's queued work.

Every function here is called by every process of the run in the same
order: the send and receive sets of an exchange come from the same `Mesh`
walk on every process, and a process with nothing to send posts nothing.
Under NCCL, `exchange` on tensors the transport reads in place and
`all_gather_into` allocate nothing, so the time loop's CUDA graphs
capture them (`core/graphs.py`).
"""

import json
import os
import socket
import subprocess
import time
import zlib

import torch
import torch.distributed as td

from ..utils.errors import solver_error

# The coordinator this module initialised the default process group with;
# None when the group was set up by the caller, or not at all.
_coordinator = None

# CUDA tensors copied through host memory under gloo, by direction: each
# copy to the host waits for the work queued before it on the stream.
STAGED = {"to_host": 0, "to_device": 0}


def backend_for(device_type, gpu_aware):
    """NCCL for CUDA shards that the transport may read in place, gloo
    otherwise."""
    return "nccl" if device_type == "cuda" and gpu_aware else "gloo"


def _from_env(value, name, option):
    if value is not None:
        return int(value)
    if name not in os.environ:
        solver_error("config", f"'{option}' is not given and the environment "
                               f"has no {name}")
    return int(os.environ[name])


def init_distributed(coordinator_address, num_processes, process_id,
                     backend):
    """Join the run's processes: `torch.distributed.init_process_group`
    over TCP at `coordinator_address` ("host:port"). `num_processes` and
    `process_id` default to the launcher's WORLD_SIZE and RANK. Idempotent:
    a default group that already exists is used as it is, and a call with
    another coordinator than the one this module initialised raises."""
    global _coordinator
    if td.is_initialized():
        if coordinator_address is not None and \
                _coordinator not in (None, coordinator_address):
            solver_error("config",
                         f"torch.distributed is already initialized with "
                         f"coordinator {_coordinator!r}; cannot "
                         f"re-initialize with {coordinator_address!r}")
        return
    world = _from_env(num_processes, "WORLD_SIZE", "num_processes")
    rank = _from_env(process_id, "RANK", "process_id")
    if not 0 <= rank < world:
        solver_error("config", f"process_id {rank} is outside the "
                               f"{world} processes")
    td.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                          rank=rank, world_size=world)
    _coordinator = coordinator_address


def shutdown():
    """Leave the run: empty the solver's program cache (`core/solver.
    clear_cache`: its loops over NCCL hold graphs with the group's
    collectives in them, which must go first), then destroy the default
    process group, so that another coordinator may be joined and the
    process exits cleanly."""
    global _coordinator
    from ..core.solver import clear_cache
    clear_cache()
    if td.is_initialized():
        td.destroy_process_group()
    _coordinator = None


def process_count() -> int:
    return td.get_world_size() if td.is_initialized() else 1


def process_index() -> int:
    return td.get_rank() if td.is_initialized() else 0


def backend() -> str:
    """The default process group's backend ("nccl" or "gloo")."""
    return td.get_backend()


def _gloo() -> bool:
    return backend() == "gloo"


def _wire(t, device):
    """`t` as the transport reads it: a host copy under gloo, a copy on
    this process's card `device` under NCCL; contiguous either way."""
    if _gloo():
        STAGED["to_host"] += t.is_cuda
        return t.cpu().contiguous()
    return t.to(device).contiguous()


def all_gather_rows(t, device=None):
    """Every process's `t` (the same shape and dtype on each), stacked in
    rank order: a (process_count(), *t.shape) tensor on t's device.
    `device` is this process's card under NCCL (t's device by default)."""
    n = process_count()
    if n == 1:
        return t[None]
    mine = _wire(t, device or t.device)
    rows = [torch.empty_like(mine) for _ in range(n)]
    td.all_gather(rows, mine)
    STAGED["to_device"] += t.is_cuda and _gloo()
    return torch.stack(rows).to(t.device)


# torch 2.13 names `all_gather_into_tensor` `all_gather_single`.
_gather_flat = getattr(td, "all_gather_single", None) or \
    td.all_gather_into_tensor


def all_gather_into(out, t):
    """`all_gather_rows` into `out`, a (process_count(), *t.shape) tensor
    the caller made once, with `t` a tensor it made once: the form the
    time loop's persistent buffers take (`core/step.KernelCycles`). Where
    both are contiguous and the transport reads them in place (on this
    process's card under NCCL, on the CPU under gloo), nothing is
    allocated, so a CUDA graph can capture the call; a CUDA tensor under
    gloo goes through host copies, as `all_gather_rows`' do."""
    if process_count() == 1:
        out[0].copy_(t)
        return out
    if _gloo() and t.is_cuda:
        out.copy_(all_gather_rows(t))
        return out
    _gather_flat(out.flatten(0, 1), t)
    return out


def gather_shards(mesh, values):
    """Per-shard tensors of one shape, given for this process's shards
    (`mesh.local`), for every shard of `mesh` in its order. The shards of
    a process are contiguous in mesh order, so rank order is mesh
    order."""
    if mesh.nprocs == 1:
        return list(values)
    return list(all_gather_rows(torch.stack(list(values)),
                                mesh.local[0].device).flatten(0, 1))


def _direct(t, device):
    """Whether the transport reads and writes `t` in place: contiguous, on
    the CPU under gloo, on this process's card `device` under NCCL."""
    return t.is_contiguous() and (not t.is_cuda if _gloo()
                                  else t.device == device)


def exchange(sends, recvs, device):
    """One `batch_isend_irecv` with every op posted before any wait.
    `sends` and `recvs` are (tensor, peer rank, tag) triples; `device` is
    the card this process's NCCL communicator uses (unused under gloo).
    A tensor the transport cannot read in place (`_direct`) goes through a
    staging copy; where every tensor is direct, as the time loop's
    persistent send stacks and slab buffers are under NCCL, nothing is
    allocated, so a CUDA graph can capture the call.

    On return every receive tensor holds its data for the work queued
    after the call on the current stream: `Work.wait` makes the current
    stream wait for NCCL's, and a staged receive is copied in after it.
    Inside a capture the same wait is an edge of the graph (NCCL's stream
    joins the capture stream where the exchange starts and the capture
    stream joins it back at `Work.wait`), so in every replay the kernels
    captured after the call read what this replay received."""
    if not sends and not recvs:
        return
    ops = [td.P2POp(td.isend, _wire(t, device), peer, tag=tag)
           for t, peer, tag in sends]
    staged = []
    for t, peer, tag in recvs:
        buf = t if _direct(t, device) else torch.empty(
            t.shape, dtype=t.dtype, device="cpu" if _gloo() else device)
        staged.append((t, buf))
        ops.append(td.P2POp(td.irecv, buf, peer, tag=tag))
    for work in td.batch_isend_irecv(ops):
        work.wait()
    for t, buf in staged:
        if buf is not t:
            STAGED["to_device"] += t.is_cuda and _gloo()
            t.copy_(buf)


def barrier(name, device=None):
    """Wait until every process reaches the barrier called `name`: an
    all-gather of the name's CRC-32, which raises where processes reached
    different barriers. `device` is this process's card under NCCL."""
    if process_count() == 1:
        return
    code = zlib.crc32(name.encode())
    dev = "cpu" if _gloo() else (device or torch.device(
        "cuda", torch.cuda.current_device()))
    got = all_gather_rows(torch.tensor([code], dtype=torch.int64, device=dev))
    if bool((got != code).any()):
        solver_error("config", f"processes reached different barriers at "
                               f"{name!r}: {got.flatten().tolist()}")


# ------------------------------------------------------- launching workers

def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _last_result(out):
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
    return json.loads(lines[-1][len(RESULT):]) if lines else None


def _wait_all(procs, deadline):
    """Wait for every process; at the first that fails, or at the
    deadline, kill them all, so that none waits on a dead peer's
    collective. Returns whether every one exited with 0."""
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            return True
        if any(c not in (None, 0) for c in codes) or time.time() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            return False
        time.sleep(0.05)


RESULT = "armon-result: "


def result_line(obj):
    """The line a worker prints its result on, for `run_workers`."""
    return RESULT + json.dumps(obj)


def run_workers(argv_of, nprocs, timeout, log_dir, env=None, cwd=None):
    """Run `nprocs` worker processes, `argv_of(rank, port)` each, with
    `port` a free localhost port for their coordinator, and return their
    results in rank order: each worker's last `result_line` (the JSON
    object), or None where it printed none. Their output (stdout and
    stderr) goes through files in `log_dir`.
    A port taken between the asking and the binding ("address already in
    use") is tried once more on another. Raises RuntimeError with the
    outputs where a worker fails or `timeout` seconds pass."""
    deadline = time.time() + timeout
    for attempt in (0, 1):
        port = free_port()
        procs, logs = [], []
        for rank in range(nprocs):
            logs.append(os.path.join(log_dir, f"worker_{rank}_{attempt}.log"))
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [str(a) for a in argv_of(rank, port)], stdout=f,
                    stderr=subprocess.STDOUT, env=env, cwd=cwd))
        ok = _wait_all(procs, deadline)
        outs = []
        for log in logs:
            with open(log) as f:
                outs.append(f.read())
        if ok:
            return [_last_result(o) for o in outs]
        if attempt == 0 and any("address already in use" in o.lower()
                                for o in outs):
            continue
        raise RuntimeError("\n".join(
            f"--- worker {r} of {nprocs} (exit {p.returncode})\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
