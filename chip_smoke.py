#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`armon_torch`) on one NVIDIA card.

    python3 chip_smoke.py                 # phases 0-4 and 6-19, as the check runs it
    python3 chip_smoke.py --phases 0,1    # a subset (build + kernel checks)
    python3 chip_smoke.py --phases 0,5    # the route crossovers only
    python3 chip_smoke.py --phases 0,7    # the domain-decomposed runs only
    python3 chip_smoke.py --phases 0,8    # the probes only
    python3 chip_smoke.py --phases 0,9    # the torch op path only
    python3 chip_smoke.py --phases 0,10   # drivers, I/O and restart only
    python3 chip_smoke.py --phases 0,11   # observability and the public API only
                                          # (add 3, 7 and 9 for the times and
                                          # peaks it is held to)
    python3 chip_smoke.py --phases 0,12   # runs over several processes only
                                          # (add 3 and 7 for the one-process
                                          # rates it is set beside)
    python3 chip_smoke.py --phases 0,13   # window graphs against the eager loop
    python3 chip_smoke.py --phases 0,14   # the whole-run graph (add 3 for the
                                          # main path's condition-setting tails)
    python3 chip_smoke.py --phases 0,15   # graphs over NCCL processes (two or
                                          # four cards; add 12 for its timed
                                          # run beside (b)'s)
    python3 chip_smoke.py --phases 0,16   # loops kept across calls ((d) needs
                                          # two cards)
    python3 chip_smoke.py --phases 0,17   # the conservation kernel K6 (add 3
                                          # for its main-path launches)
    python3 chip_smoke.py --phases 0,18   # the option-space fuzz on the card
    python3 chip_smoke.py --phases 0,19   # the examples, the entry points and
                                          # the kernel-math fuzz

Phases, each printing one JSON line:
  0. the card (nvidia-smi name and power limit), torch's version and its
     CUDA version, the NVIDIA driver's version and the CUDA version it
     supports, whether torch's `CUDAGraph` offers `keep_graph` and
     `raw_cuda_graph` (the whole-run graph's body), a two-iteration WHILE
     graph on its own, its body's one launch (`countdown_kernel`, in a
     torch capture copied in as a child graph) setting the condition,
     against its plain version, whether
     K5's cooperative launch captures into a CUDA graph (one launch
     replayed against its eager launch, bit for bit), the kernels' build time,
     ptxas's registers and spills per kernel instance, the resident
     blocks per SM of each K4 instance, and the cluster probe's plan
     (CTAs, rows and columns a CTA holds, shared memory a CTA uses, the
     clusters the card holds at once, registers and local memory) at Sod
     100^2 and at the largest grids the routing sends to K5, and at the
     same grids K5's own geometry (its window edge, tiles, the card's
     blocks per SM from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
     registers and spill bytes, f32 exact and fast math), failing where
     the card cannot hold every tile at once;
  1. the per-sweep kernels against their plain PyTorch versions on the
     card, one X and one Y sweep (each emitting) at 1024^2 after a few
     cycles, on Sod_circ and Bizarrium, in f64, f32 exact and f32 fast
     math, plus the CFL minimum via K3; and on a 64 x 70000 strip (more
     than 65535 padded rows), bit for bit in f32 exact; K3's tail (the
     fold and dt step in the cycle's last launch) in K1's and K2's launch
     on each of those states against the launch then K3 and K3's plain
     version, bit for bit, three launches back to back (the ticket
     resets; the last past the run's end), and with a NaN in u;
  2. the Julia goldens (Sod, Sod_y, Sod_circ, Sedov, Bizarrium at 100^2)
     through the per-sweep kernels at the JAX package's gates
     (`GOLDEN_GATES`: zero differences for the Sod family and Sedov f64)
     in f64 and f32 exact; the f32 fast-math counts are reported, and
     Sedov's counts on a line of their own for each route (phases 2, 4,
     7, 9);
  3. the main path: Sod 8192^2 f32 fast math (GAD/minmod/euler_2nd, nghost
     4, Sequential), one warm-up run then 100 timed cycles through
     `armon()`, with launch counts (K4/K5 must stay at 0; two launches a
     cycle, K3 once a run, K2 carrying K3's tail; one whole-run graph,
     K2's tail setting its condition once a cycle, 3 host reads), kernel
     times from CUDA
     events, host reads, conservation drift and peak memory; then every
     kernel against its plain version at the main path's shapes, K3's
     tail in K1, K2 and K4 at 8200^2 (thousands of blocks) as in phase 1,
     K3 and K2 with and without its tail timed from the same scalars, and
     K4 on the same final state (8200^2 padded), timed and held against
     its plain version;
  4. the small-grid routes: K4 against its plain version at 1024^2 (both
     sweep orders) and K5 at 100^2 (one 8-cycle launch from a mid-run
     state, across maxcycle, dt_on_even_cycles, cst_dt) and at the largest
     grids the routing admits (f32 120 x 496, 240^2 and the 3192 x 4
     strip, f64 120^2 and 120 x 240), bit for bit in exact mode;
     per-sweep, pair and multicycle runs bit for bit against each other;
     the goldens through the pair and multicycle routes; timed
     runs through `armon()` of Sedov 2000^2 (pair, then per-sweep) and Sod
     100^2 (multicycle, then pair), one launch a cycle on the pair route
     and two per-sweep, K3 once a run; K3's tail in K4's launch on
     Sedov's final state and on grids of one block (K4 at 40^2, K2 at 96
     x 20); K4 and K5 on those runs' final states,
     bit for bit against their plain versions in f32 exact and f64, within
     the fast-math gate in f32 fast math, and timed; K4 against K1 then K2
     on Sedov's final state (bit for bit in f32 exact, the fast-math
     difference reported);
  5. (only when asked for) route crossovers, data for retuning
     `pair_threshold` and `temporal_blocking` on this card: per-sweep
     against pair at 256^2-8192^2, K1/K2/K4 times at 8192^2, pair against
     multicycle on small grids;
  6. the per-kernel summary line (the eight solver kernels, K3's tail,
     the probe kernels, the WHILE condition (`while_cond`) and K6
     `ff_sum`; printed last);
  7. domain-decomposed runs (P != (1, 1)), every shard on cuda:0: the slab
     variants of K1/K2 (X/Y slabs, a 3x3 mesh of 1024^2 shards) and of K4
     (Y slabs with the X mirror after the splice, corner cells, a 1x3
     mesh, both sweep orders) against their plain versions on every shard
     of a mid-run state; K3's tail folding every shard's partials in the
     last shard's launch (K1 and K2 over 2x2, K4 over 1x2, f64 and f32
     exact) as in phase 1; meshes against the one-device run bit for bit
     (Sod_circ 1000^2 over 2x2, 1x2, 2x1, 4x1 and 3x2, N=(1000, 999) over
     3x2, Sedov 2000^2 over 1x2 on the pair route) in f64 and f32 exact;
     the goldens through a 2x2 mesh; timed runs through `armon()` of Sod
     16384^2 over 2x2 (8192^2 shards, the main path's shape) and Sedov
     2000^2 over 1x2 (pair route), with per-shard kernel times, the slab
     copies' time, launches per cycle (K3 once a run, its tail once a
     cycle), conservation drift and peak memory;
     the slab variants on those runs' final states (the first and the last
     shard), bit for bit against their plain versions in f32 exact and
     f64, within the fast-math gate as timed; and, where the machine has
     four cards, the 2x2 check on cuda:0-3;
  8. the probes (`armon_torch/probes/`, the card counterparts of the TPU
     probes under `scripts/`): each probe's entry point at its default
     sizes (flip at 512x1024 and 8200^2, ff at 1024^2, the I/O ladder at
     8192^2, the rate classes at 8192^2, K4's variants at Sod 4096^2 and
     8192^2, the cluster probe's K5 and the solver's K5 at 108^2, 168^2
     and 248^2 padded f32 and 128^2 f64), printing its own lines with the
     card, its launches counted;
     then each probe kernel against its plain version at the shapes it
     was timed at, and a small one (bit for bit where the arithmetic is
     exact, within a stated gate elsewhere; the flip kernels also at odd
     widths, 513x1030, 7x9 and 33x1027, and on offset views);
  9. the torch op path (``kernel_tier="torch"``: plain PyTorch ops, none
     of the hand-written kernels): (a) the five goldens at 100^2 at the
     gates of phase 2, f64 and f32; (b) the main path's
     configuration (Sod 8192^2 f32, GAD/minmod/euler_2nd, nghost 4,
     Sequential), one warm-up run then 20 timed cycles through `armon()`,
     with cells/s, peak memory, host reads, the CUDA kernels and their
     device time a cycle (`torch.profiler`), the device's busy share, no
     launch of a hand-written kernel, and the largest difference per
     field from the per-sweep kernels in exact mode over the same cycles
     (within 4 ulp); (c) f64 Sod_circ 1024^2, 3 cycles, against the
     kernels in exact mode within rtol 1e-12, atol 1e-14. Its lines come
     before phase 6's;
 10. drivers, I/O and restart, through `armon()`, every check bit for
     bit unless said: (a) the main path's configuration (Sod 8192^2 f32
     fast math) 16 cycles on the lean loop, 8 through the per-cycle
     driver with a `checkpoint_step` snapshot (its bytes, save and load
     seconds, the free disk space before it), the snapshot resumed to 16
     through the lean loop, and 16 cycles through the per-cycle driver
     (its cells/s and host reads a cycle against the lean loop's); (b)
     Sedov 2000^2 resumed at 500 of 1000 from the per-cycle driver's
     snapshot (K4); Sod 100^2 resumed at 16 (K5) and 17 (K4, one cycle at
     a time) of 40 in f32 exact and f64, and in fast math with the
     difference printed; a snapshot the port wrote on the CPU (f64
     Sod_circ 200^2, 10 of 20 cycles) resumed on the card; (c) Sod, Sod_y
     and Sod_circ 100^2 written with `write_output` in f64 and f32 exact:
     0 golden differences read back, and each file equal to the CPU's byte
     for byte; Sod 1024^2 f32 `write_output` and `write_slices`, timed,
     read back equal to the state; (d) compare mode: step files written on
     the CPU (f64 Sod 100^2, 2 cycles), a clean run on the card, a
     `cfl=0.5` run stopping at cycle 0; (e) Sod_circ 1000^2 over 2x2 on
     cuda:0 with `use_MPI`: per-shard files against the one-device file's
     windows, a per-shard snapshot resumed on 2x2, 1x1 and 3x2 against the
     one-device run (f64, f32 exact). Each path runs with the launch
     counts set to 0 just before it and must launch its kernels; phase
     10's launches are added to the `kernels` line. Files go under a
     temporary directory, removed at the end;
 11. observability and the public API, the solver's probe warnings
     turned into errors: (a) the main path's configuration (Sod 8192^2
     f32 fast math) 20 cycles on the lean loop: untraced with the
     whole-run graph, untraced with window graphs, traced
     (`profiling=["trace"]`, which replays window graphs: the trace is
     not held to the whole-run graph), traced, then the two untraced
     runs again in reverse; the Chrome trace's launches
     of K1 (`x_sweep_kernel`), K2 with K3's tail (`y_sweep_finish_kernel`)
     and K3 equal to the wrappers' counts, none of K4 or K5, each
     launch's device time in the trace within 10% of phase 3's CUDA-event
     time (K3's, once a run and a few us, printed beside a CUDA-event
     time of the same call), cells/s with and without the trace (its cost
     against the untraced window graphs, the same form), the device's
     busy share; (b) the same through the per-cycle driver with
     `log_blocks` and the trace: 20 events whose t and dt equal the
     device scalars of a run without `log_blocks` bit for bit, sections
     from the trace, the probes' four sections, the timer's three
     sections once each; (c) Sod 16384^2 over 2x2 on cuda:0 (phase 7's
     mesh), 10 cycles with `log_blocks` and the trace: the slab copies'
     device time (`collective_seconds`) beside phase 7's slab-copy ms a
     cycle; (e) `host_to_device(device_to_host(...))` on the shards of
     Sod_circ 1000^2 runs on 1x1, 2x2 and 3x2 one-card meshes, bit for
     bit; (f) `python -m armon_torch test=Sod N=1024,1024 maxcycle=10
     silent=4` in a subprocess; (d) `memory_required()` against the
     peaks measured on the card (one shard's initialisation and the lean
     run here, phase 3's, phase 7's 2x2 and phase 9's runs), each peak at
     or under its total within `MEM_MARGIN`. Its files go under a
     temporary directory;
 12. runs over several processes (`torch.distributed`), each job's
     workers this script run with `--mp-worker` (a failing worker kills
     its peers and fails the phase): (a) two processes on cuda:0 over
     gloo (`gpu_aware=False`, host copies): Sod_circ 1000^2 over 2x1 and
     2x2 and N=(1000, 999) over 3x2, 20 cycles, and Sedov 2000^2 over 1x2
     on the pair route (K4 slab), 50 cycles, in f64 and f32 exact, every
     shard's real cells bit for bit against a one-process run on the
     card (SHA-256 of each shard's window); Sod, Sod_y and Sod_circ 100^2
     over 2x2 in f64 and f32 exact, 0 per-shard golden differences; a
     per-shard snapshot at cycle 10 resumed to 20 bit for bit;
     `gather_state` refusing; Sod 16384^2 over 2x2 (two 8192^2 shards a
     process) f32 fast math, 100 timed cycles: cells/s, launches a cycle
     (K1 slab, K2 slab, K3 once a cycle a process), host copies a cycle,
     the exchange's and the partials' gather's ms a cycle timed apart,
     beside phase 7's one-process cycle; (b) where the machine has two
     cards, the same checks over NCCL, a card a process (2x1, Sedov 1x2),
     and with four, 2x2 over four processes (checks, goldens, snapshot,
     the timed run); otherwise a line says it did not run. The NCCL runs
     take the loop's default form (window graphs, `core/graphs.py`
     `whole_reason`), but the timed run takes the eager loop
     (`graphs=False`), the yardstick, and names its form. Each run's
     launches are counted in its worker (each of its kernels must
     launch); their sums go to the `kernels` line's `launches_phase12`;
 13. window graphs (`armon_torch/core/graphs.py`: the cycles between two
     host reads captured once as a CUDA graph and replayed), which the
     per-cycle driver takes and the lean loop with `whole=False`: (a)
     window graphs against the eager loop (`graphs=False`), bit for bit
     in f64 and f32 exact, with the same launch counts and host reads,
     on Sod_circ 1000^2 per-sweep, Sedov 2000^2 pair, Sod 100^2
     multicycle (K5 captured), Strang on the pair route resumed at an odd
     cycle, SequentialSym with `check_every=3`, Sod_circ 1000^2 over 2x2
     on one card and the per-cycle driver (`silent=1`, a one-cycle graph
     replayed a cycle), with the capture ms; (b) in one process,
     eager, graphs, graphs, eager, the us a cycle through `armon()` of the
     per-cycle driver at the main path's size, with the capture ms, the
     graphs captured and replayed, host reads and launches a cycle (equal
     in both); the second run with graphs replays the graph the first
     captured (`replayed_only`: the program cache keeps the loop);
 14. the whole-run graph (`CycleGraphs.run`, `armon_torch/csrc/graph.cu`:
     a conditional WHILE node whose body is 1-2 steps' launches, the last
     of which sets the condition: K1, K2 or K4's tail, or K5), which every
     other phase's one-process, one-card lean
     runs take by default: (a) against the eager loop and window graphs
     bit for bit in f64 and f32 exact, one graph launch and 3 host reads a
     run, launches equal to the eager loop's at `check_every` = the
     body's length, the condition set once a body, on Sod_circ 1000^2
     per-sweep, Sequential resumed at
     an odd cycle, Sedov 2000^2 pair, Sod 100^2 multicycle with K 8 and 3,
     Strang resumed at an odd cycle, SequentialSym, 2x2 and 1x2 meshes on
     one card, the full-state restore loop from an odd cycle, a run whose
     dt gate fails (a NaN), and a restore through `armon()`; (b) in one
     process, eager, window graphs and the whole-run graph, four runs
     each in mirrored order, the us a cycle through the lean loop of Sod
     100^2 pair and multicycle, Sedov 2000^2 per-sweep and over 1x2 on
     one card, and the main path, with the capture ms, host reads,
     iterations, launches a cycle, the card's clock after each main-path
     run; (c) the WHILE condition alone: a WHILE of 1000 iterations whose
     body is one launch that takes one from the predicate and sets the
     condition from what is left (`countdown_kernel`), against its plain
     version (the iterations and the predicate it ends with), timed an
     iteration, its `kernels` entry (`while_cond`). The body's length (1-2 steps
     against a `check_every` window), a process's first calls and the
     stalls of a capture are measured by `tools/graph_costs.py`;
 15. graphs over NCCL processes, a card a process (`core/graphs.py`: each
     process's lean run replays window graphs whose cycles hold the halo
     exchange, the CFL partials' gather and K3, one replay and one host
     read a window; the transport rules out the whole-run graph there,
     `whole_reason`, and `graphs=True` with it raises), phase 12's `--mp-worker` workers with legs of their own: (a) on two
     or more cards, two processes: Sod_circ 1000^2 over 2x1 per-sweep,
     Sedov 2000^2 over 1x2 pair, Strang over 1x2 resumed at an odd cycle,
     and the per-cycle driver (`silent=1`, one-cycle window graphs), each
     in f64 and f32 exact, the eager loop (`graphs=False`), window graphs
     and the default form: every shard bit for bit (SHA-256 of its real
     window), the same scalars, form and host reads on every process,
     the form "windows", launches equal to the eager loop's, and
     `graphs=True` with the whole-run graph raising; (b) on four cards, 2x2
     over four processes (Sod_circ 1000^2 and Strang resumed at an odd
     cycle) with the same checks; then, through `armon()`, eager, graphs,
     graphs, eager after a warm-up of each, Sod 16384^2 over 2x2 (four
     8192^2 shards, f32 fast math, 100 cycles; beside phase 12's timed
     run where it ran) and, on two processes, Sedov 2000^2 over 1x2 (500
     cycles): ms a cycle (the slowest process's solve), with and without
     the capture ms, form, host reads and captures (the second graphs run
     replays the first's windows: 0); (c) on fewer than two cards a
     line says it did not run. Its launches, summed over its workers, go
     to the `kernels` line's `launches_phase15`, and its seconds are
     printed;
 16. loops kept across calls (`core/solver.py`'s program cache, `_cached`:
     `make_jit_loop_lean` and the other loop entry points keep a loop, its
     buffers, device scalars and CUDA graphs, per configuration, devices
     and form;
     a call copies its carry in and leaves it as it was), the cache
     emptied first: (a) the main path (Sod 8192^2 f32 fast math, 100
     cycles) in `bench.py`'s pattern, `make_jit_loop_lean(params)` built
     once, one warm-up call then five timed calls on one input carry:
     per call the graphs captured (1, then 0), the copy-in and copy-out
     ms (CUDA events, on the loop's buffers), the host ms outside the
     whole-run launch, cells/s; the five calls' spread and the calls that
     stalled (over 10 ms outside the launch); every call bit for bit the
     first, launches equal, the input unchanged; a run stopped on its dt
     gate (a NaN), after which K3's ticket is 0 and the clean carry gives
     the first call's bits; in f32 exact, cold, warm and `graphs=False`
     bit for bit; (b) the same at Sod 100^2 multicycle (4000 cycles) and
     pair (2000), and Sedov 2000^2 pair (1000); (c) `armon()` twice with
     one params (Sod 8192^2, 20 cycles): the second captures nothing and
     gives equal fields; (d) on two or more cards, two NCCL processes
     (`--mp-worker` job `k2`), Sod_circ 1000^2 over 2x1 per-sweep and
     Sedov 2000^2 over 1x2 pair in f32 exact: a kept loop's window graphs
     called twice, the second capturing nothing on any process, both bit
     for bit the eager loop's, and `dist.shutdown` emptying the cache; on
     one card a line says it did not run; (e) ROADMAP A8 at the default:
     the per-cycle driver with its kept one-cycle graphs at `silent` 0
     and 1, Sod 8192^2 (20 cycles) and 100^2 (400), us a cycle of a warm
     run beside the lean loop's, host reads a cycle, K6's launches a cycle
     (one a shard a cycle and one at init in f32), and no call of the
     plain column loop on a CUDA tensor. Its launches go to the `kernels`
     line's `launches_phase16`. Each phase's kept loops are dropped after
     it;
 17. the f32 conservation sums as K6 `ff_sum` (`armon_torch/csrc/
     reduce.cu`, the port of the `lax.scan` of the JAX package's
     `_ff_sum`): (a) K6 against its plain version on CPU copies, bit for
     bit, on the final states of 20-cycle lean runs of Sod 8192^2 (fast
     math), Sod 100^2 and Sedov 2000^2 (fast math and exact), on each
     shard of Sod 1000^2 over 3x1 on one card (its real cells), on random
     blocks of 1 x 5000, 5000 x 1 and 1 x 1 real cells, and on Sod 100^2
     with an inf and a NaN in rho, twice on one scratch (its ticket back
     at 0), and on the card test's blocks (`P17_ODD`: every row stride
     modulo 4, ghosts 2, 4 and 5, an unaligned base, one row, one
     column), positive, mixed and with an inf and a NaN, twice each,
     failing unless both load paths (TMA and 4-byte copies) ran; (b) K6
     at 8192^2, 2000^2 and 100^2 by the shared timer, its load path, and
     on one column of as many rows (its second stage, the scan of the
     row sums, nearly alone; stage 1 the difference), its bound (the
     larger of bytes, operations and the chain of nx + ny dependent
     adds), the plain version on the card (one pass) and `torch.sum(rho)
     + torch.sum(rho * E)` over the same cells (a yardstick, not the same
     function); (c) the timer's `conservation_vars` section of `armon()`
     of Sod 8192^2 f32 with `check_result`, a cold and a warm call (two
     K6 launches a run); (d) phase 16 (e) in f64 (`torch.sum`): the
     per-cycle driver at `silent` 1 beside the lean loop, Sod 8192^2 and
     100^2; (e) the per-cycle driver's printed lines and initial mass and
     energy with K6 against the same run on the plain version, equal
     (Sod 100^2, and Sod 1000^2 over 3x1 on one card). K6's entry joins
     the `kernels` line (its launches phase 3's, two a run); the paths'
     launches of (c)-(e) go to the line's `launches_phase17`;
 18. the option-space fuzz (`armon_torch/fuzz.py`, the counterpart of the
     JAX package's `tests/test_option_fuzz.py`): every oracle over its
     seeds of `fuzz.CARD_SMOKE` in the card geometry (random schemes,
     cases, splittings, dtypes, dt modes, forced routes, fast math,
     graphs on and off, one-card meshes with uneven splits, extents that
     straddle the kernels' geometry branches), each case's launches
     counted; one line an oracle with each seed's branches (`fuzz.
     branches`). It fails if an oracle fails on any seed, if a branch of
     `fuzz.REQUIRED` was not reached, or if K1, K2, K3's tail, K4, K5 or
     K6 never launched; its launches go to the `kernels` line's
     `launches_phase18`;
 19. the port's last modules of the JAX package: (a) the kernel-math
     fuzz (`armon_torch/kernel_fuzz.py`, the counterpart of the JAX
     package's `tests/test_fuzz.py`), every check of `card_checks()` on
     the JAX file's random smooth states and scheme draws, at its N and 8
     times it: K1 and K2, K4 in both sweep orders, K5 (eight cycles where
     the grid fits its cap), K4 against K1 then K2 on uniform random
     states, and the X sweep (K1) commuting with the Y ghost fill, bit
     for bit against the plain versions in f64 and f32 exact; f32 fast
     math (Sod_circ and Bizarrium) within the fast-math gate of the f64
     plain version; a line a check with its draws, its largest
     difference and its launches; (b) the three example scripts
     (`examples/torch_*.py`) at the JAX scripts' sizes and defaults, on
     the card, each a subprocess (this script with `--example`) in a
     temporary directory, the Sedov example (its 13 files of 250,000
     cells) beside the other two: wall seconds, cycles, cells/s, the files each
     wrote, read back and counted (all finite), the mesh the multichip
     example chose, its launches; (c) `armon_torch.entry.
     dryrun_multichip` over 4 shards (on four cards where the machine has
     them, else on cuda:0). Every part runs; the phase fails at its end
     if one failed or if K1, K2, K3's tail, K4 or K5 never launched. Its
     launches go to the `kernels` line's `launches_phase19`.

Every kernel time is the best of 3 passes of back-to-back CUDA-event
timed calls behind a spin kernel (`armon_torch/_card.py`, shared with the
probes), so host launch time does not enter it.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. Without a CUDA card, or without the `armon_torch` package next
to this file, it exits non-zero at once. It imports nothing of JAX.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_DIR = os.path.join(HERE, "tests", "reference_data")

sys.path.insert(0, HERE)
try:  # the timing, bound and card line every timed row shares
    from armon_torch._card import bound, card_line, chain_ms, emit, time_ms
except ModuleNotFoundError as exc:  # alone, without its package: main exits 2
    if exc.name != "armon_torch":
        raise

# Operations per cell of one sweep (GAD + minmod + euler_2nd, perfect gas;
# a divide, a square root or a fused multiply-add counts as one): the
# census of the sweep's plain version, `python -m armon_torch.probes.
# roofline` (add 8, sub 17, mul 47, fma 30, div 18 and one 0-dim
# reciprocal, sqrt 1, min 8, max 8, compares 9, selects 18, abs 4, the
# signs' 4 negations; its other 18 negate an fma's operand, which the
# instruction does at no cost).
SWEEP_OPS_PER_CELL = 172

MAIN_N = 8192
# A strip of more than 65535 padded rows (ROADMAP C1), (nx, ny).
STRIP_N = (64, 70000)
MAIN_CYCLES = 100

# Route pins (`armon_torch/ops/routing.py`).
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)


def saved_counts(K):
    """The launch and tail counts (`ops/sweep.py` LAUNCHES, TAILS), to be
    put back by `restore_counts` after launches that are not a path's."""
    return dict(K.LAUNCHES), dict(K.TAILS)


def restore_counts(K, saved):
    for counts, was in zip((K.LAUNCHES, K.TAILS), saved):
        counts.update(was)


def bound_f32(nbytes, nops):
    """`bound` with `nops` f32 operations (the kernels are built with
    -fmad=false, so an operation is one lane instruction)."""
    return bound(nbytes, {"float32": nops})


def compare(torch, a, b, g):
    """(max abs diff, max norm-relative diff, max ulp distance) of two
    fields on their real cells."""
    a = a[g:-g, g:-g]
    b = b[g:-g, g:-g]
    diff = (a - b).abs()
    scale = b.abs().max().clamp_min(torch.finfo(b.dtype).tiny)
    ulp = (_ordered(torch, a) - _ordered(torch, b)).abs().max()
    nan = bool(torch.isnan(a).any() or torch.isnan(b).any())
    return (float(diff.max()), float(diff.max() / scale),
            int(ulp) if not nan else None)


def _ordered(torch, a):
    """Float bits as integers that order like the values (so the integer
    difference counts ulps, and -0 equals +0)."""
    if a.dtype == torch.float64:
        i = a.contiguous().view(torch.int64)
        low = torch.iinfo(torch.int64).min
        return torch.where(i < 0, low - i, i)
    i = a.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(2 ** 31) - i, i)


def _ptxas_summary(log):
    """["<kernel instance>: <registers>, <spills>", ...] from `ptxas -v`'s
    output (mangled names without the namespace prefix)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
            name = name.replace("_ZN5armon", "")
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = ln.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name, spill = None, ""
    return out


# K5's grids: Sod 100^2 (BASELINE config 1) and the largest the routing
# admits (`multicycle_geom_ok`'s 256 KiB cap): thin, square and the wide
# strip in f32, thin and square in f64; (nx, ny).
K5_GRIDS = (("float32", (100, 100)), ("float32", (120, 496)),
            ("float32", (240, 240)), ("float32", (3192, 4)),
            ("float64", (120, 120)), ("float64", (120, 240)))


def _cluster_plan(torch, dtype, N):
    """The cluster probe's plan on an (nx, ny) grid and what the card
    makes of it (`probes.cluster.occupancy`)."""
    from armon_torch import ArmonParameters
    from armon_torch.probes import cluster
    cfg = ArmonParameters(test="Sod", N=N, data_type=dtype, silent=5,
                          device="cuda").config
    src = tuple(torch.zeros(cfg.local_shape, dtype=getattr(torch, dtype),
                            device="cuda") for _ in range(4))
    return cluster.occupancy(cfg, src)


def _k5_geometry(torch, dtype, N):
    """K5's geometry on an (nx, ny) grid and what the card makes of it
    (`_build.multicycle_occupancy`), exact and, in f32, fast math; raises
    where the card cannot hold every tile at once or the instance
    spills."""
    from armon_torch import ArmonParameters
    from armon_torch.ops import _build
    cfg = ArmonParameters(test="Sod", N=N, data_type=dtype, silent=5,
                          device="cuda").config
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for fast in ((False, True) if dtype == "float32" else (False,)):
        occ = _build.multicycle_occupancy(cfg.local_shape, cfg.dtype, fast, False)
        if occ["tiles"] > occ["blocks_per_sm"] * sms:
            raise AssertionError(f"K5 {dtype} {N}: {occ['tiles']} tiles, the card "
                                 f"holds {occ['blocks_per_sm']} x {sms}")
        if occ["local_bytes"]:
            raise AssertionError(f"K5 {dtype} {N} spills: {occ}")
        out["fast" if fast else "exact"] = occ
    return out


def _versions():
    """The NVIDIA driver's version (nvidia-smi), the CUDA version it
    supports (`cuDriverGetVersion`, e.g. 12040 for 12.4) and nvcc's, which
    builds the kernels."""
    import ctypes
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    v = ctypes.c_int()
    rc = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(v))
    from armon_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    return {"driver": out.stdout.strip().splitlines()[0],
            "driver_cuda": v.value if rc == 0 else f"error {rc}",
            "nvcc": nvcc.stdout.strip().splitlines()[-1]}


def _k5_capture(torch):
    """Whether the card's CUDA captures K5's cooperative launch into a
    CUDA graph: one K5 launch (8 cycles of Sod 100^2 f32 exact from its
    initial state) made eagerly and replayed from a graph, each on its own
    copy of the same inputs, held bit for bit; where the capture fails, its
    error. The launches are not a path's."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused
    from armon_torch.ops import cycle as C
    from armon_torch.ops import sweep as K
    from armon_torch.ops.routing import temporal_pairs
    params = ArmonParameters(test="Sod", N=(SOD_N, SOD_N), data_type="float32",
                             use_fast_math=False, silent=5, device="cuda")
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    pairs = temporal_pairs(cfg)
    saved = saved_counts(K)
    outs = []
    try:
        for graphed in (False, True):
            src = tuple(a.clone() for a in fs[:4])
            dst = tuple(torch.empty_like(a) for a in src)
            p = fs.p.clone()
            part = C.new_multicycle_partials(src[0].shape, cfg.dtype, "cuda")
            scal, iscal = K.new_scalars(cfg.dtype, "cuda", lm=float(seed))

            def launch():
                C.multicycle(cfg, pairs, src, dst, p, part, scal, iscal)
            if graphed:
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph):
                        launch()
                except Exception as e:  # the finding phase 0 records
                    return {"captures": False,
                            "error": f"{type(e).__name__}: {e}"}
                graph.replay()
            else:
                launch()
            outs.append(src + (p, scal, iscal))
        torch.cuda.synchronize()
    finally:
        restore_counts(K, saved)
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    if not same:
        raise AssertionError("K5 replayed from a graph differs from its "
                             "eager launch")
    return {"captures": True, "bitwise_vs_eager": same}


class _Countdown:
    """A loop body for the WHILE node on its own: each step takes one from
    the predicate slot `iscal[0]` (int32, on the card), by the WHILE's
    measurement kernel (`graphs.countdown`), which with the WHILE
    condition `cond` sets it from what is left, or with `plain` by a
    PyTorch subtraction (for `graphs.while_plain`); no buffers, so its
    parity and buffer roles never change."""

    def __init__(self, torch, n, plain=False):
        self.iscal = torch.tensor([n], dtype=torch.int32, device="cuda")
        self.cur, self.nxt = [(self.iscal,)], [(self.iscal,)]
        self.plain = plain

    def cycle(self, i, cond=None):
        from armon_torch.core import graphs as G
        if self.plain:
            self.iscal.sub_(1)
        else:
            G.countdown(self.iscal, cond)

    def parity(self, i):
        return 0

    def swaps(self, i):
        return 0

    def roles(self):
        return 0


def _graph_api(torch):
    """What the card's torch offers for building on a captured graph."""
    import inspect
    G = torch.cuda.CUDAGraph
    try:
        keep = "keep_graph" in inspect.signature(G).parameters
    except (TypeError, ValueError):
        keep = None
    return {"keep_graph": keep,
            **{name: hasattr(G, name) for name in
               ("raw_cuda_graph", "raw_cuda_graph_exec", "instantiate",
                "begin_capture_to_if_node", "begin_capture_to_while_loop")}}


def _while_alone(torch, n=2):
    """The whole-run graph on its own (`core/graphs.CycleGraphs.run`): a
    WHILE node whose body's one launch takes one from its predicate and
    sets the condition from what is left, the launch recorded in a torch
    capture that is copied into the WHILE body as a child graph (the form
    the solver's bodies take), started at `n`, against its plain version
    (`graphs.while_plain`): `n` iterations and the predicate at 0 in both.
    Its launches are not a path's."""
    from armon_torch.core import graphs as G
    saved = dict(G.LAUNCHES), dict(G.MEASURE)
    try:
        run = _Countdown(torch, n)
        iters = G.CycleGraphs("cuda").run(run, 0, 1)
        plain = _Countdown(torch, n, plain=True)
        plain_iters = G.while_plain(plain, 0, 1, 0)
        torch.cuda.synchronize()
    finally:
        G.LAUNCHES.update(saved[0])
        G.MEASURE.update(saved[1])
    got = (iters, int(run.iscal.item()))
    if got != (plain_iters, int(plain.iscal.item())) or got != (n, 0):
        raise AssertionError(f"WHILE of {n}: (iterations, predicate) {got}, "
                             f"plain ({plain_iters}, {int(plain.iscal.item())})")
    return {"body": "torch capture copied in as a child graph, its launch "
                    "setting the condition",
            "iterations": iters, "plain_iterations": plain_iters,
            "predicate": got[1], "bitwise_vs_plain": True}


def phase0(torch):
    from armon_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = {src: _ptxas_summary(log)
            for src, log in _build.BUILD_INFO["logs"].items()}
    occupancy = {f"cycle_{dtype} fast={fast} biz={biz}":
                 dict(zip(("blocks_per_sm", "threads", "smem_bytes"),
                          _build.cycle_occupancy(dtype, fast, biz)))
                 for dtype, fast in (("float32", True), ("float32", False),
                                     ("float64", False))
                 for biz in (False, True)}
    plans = {f"{dtype} {N[0]}x{N[1]}": _cluster_plan(torch, dtype, N)
             for dtype, N in K5_GRIDS}
    k5_geometry = {f"{dtype} {N[0]}x{N[1]}": _k5_geometry(torch, dtype, N)
                   for dtype, N in K5_GRIDS}
    emit({"phase": 0, "card": card_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, **_versions(), "build_s": build_s,
          "graph_api": _graph_api(torch), "while_alone": _while_alone(torch),
          "k5_graph_capture": _k5_capture(torch), "ptxas": regs,
          "k4_occupancy": occupancy, "cluster_plan": plans,
          "k5_geometry": k5_geometry})
    return occupancy


def _state_after(torch, test, n, dtype, fast, cycles):
    """The port's carry after `cycles` cycles (through the per-sweep
    kernels) on an n^2 grid (or N = n, a pair), and the dt of the next
    cycle."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    N = tuple(n) if isinstance(n, (tuple, list)) else (n, n)
    params = ArmonParameters(test=test, N=N, data_type=dtype,
                             use_fast_math=fast, maxcycle=cycles, silent=5,
                             device="cuda", **PER_SWEEP)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed))
    import numpy as np
    T = np.dtype(dtype).type
    dt = T(cfg.cfl) * T(res.lm)
    if res.dt_last:
        dt = min(dt, T(1.05) * T(res.dt_last))
    return params, res.carry, float(dt)


def check_sweeps(torch, params, fs, dt):
    """One X sweep, then one Y sweep on its output, each emitting p and
    the CFL partials, through the kernels and through the plain version on
    the same inputs, then K3 against its plain version on each kernel's
    partials. Returns per-kernel diffs."""
    from armon_torch.ops import sweep as K
    from armon_torch.utils.enums import Axis
    cfg = params.config
    g = cfg.nghost
    shape = fs.rho.shape
    dev = fs.rho.device
    out = {}
    src = (fs.rho, fs.u, fs.v, fs.E)
    for axis, emit_last in ((Axis.X, True), (Axis.Y, True)):
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(fs.rho)
        nb = K.n_partials(axis, shape, dev)
        partials = torch.zeros((2, nb), dtype=fs.rho.dtype, device=dev)
        scal, iscal = K.new_scalars(cfg.dtype, dev)
        scal[K.SC_DTUSE] = dt
        iscal[K.IS_RUN] = 1
        (K.x_sweep if axis is Axis.X else K.y_sweep)(
            cfg, src, dst, p, partials, scal, iscal, 1.0, emit_last)
        ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0)
        torch.cuda.synchronize()
        names = ("rho", "u", "v", "E") + (("p",) if emit_last else ())
        got = dst + ((p,) if emit_last else ())
        fields = {nm: compare(torch, a, b, g) for nm, a, b in zip(names, got, ref)}
        res = {"fields": fields}
        if emit_last:
            mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5])
            kmx = float(partials[0].max())
            kmy = float(partials[1].max())
            res["cfl_max_rel"] = max(abs(kmx - float(mx)) / float(mx),
                                     abs(kmy - float(my)) / float(my))
            # K3 on the kernel's partials against its plain version.
            s1, i1 = K.new_scalars(cfg.dtype, dev, lm=1.0)
            i1[K.IS_RUN] = 1
            s2, i2 = s1.clone(), i1.clone()
            K.cfl_finish(cfg, partials, nb, s1, i1, fold=True, step=True)
            K.cfl_finish_plain(cfg, partials, nb, s2, i2, fold=True, step=True)
            res["k3_equal"] = bool(torch.equal(s1, s2) and torch.equal(i1, i2))
            res["k3_lm"] = float(s1[K.SC_LM])
        out[axis.name] = res
        src = dst  # the Y sweep reads the X sweep's output
    return out


# ------------------------------------------------------------ K3's tail

def _bits_equal(torch, a, b):
    """Equal bits (NaN payloads and signed zeros included)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _launcher(kind, cfg, src, x_first=True, ghosts=None, n_real=None):
    """(launch, nb): `launch(dst, p, part, scal, iscal, finish)` runs one
    emitting K1 (`x_sweep`), K2 (`y_sweep`) or K4 (`cycle`, the full dt
    on both sweeps) launch on `src`; nb is the partials it writes."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.utils.enums import Axis
    dev, shape = src[0].device, src[0].shape
    ghosts = ghosts or K.MIRRORED
    if kind == "cycle":
        def launch(dst, p, part, scal, iscal, finish):
            C.cycle(cfg, x_first, 1.0, 1.0, src, dst, p, part, scal, iscal,
                    True, ghosts, n_real, finish)
        return launch, C.n_partials(shape, dev, cfg.dtype)
    axis = Axis.X if kind == "x_sweep" else Axis.Y
    sweep = K.x_sweep if axis is Axis.X else K.y_sweep

    def launch(dst, p, part, scal, iscal, finish):
        sweep(cfg, src, dst, p, part, scal, iscal, 1.0, True, ghosts, n_real,
              finish)
    return launch, K.n_partials(axis, shape, dev)


def _tail_check(torch, cfg, launches, srcs, sc, what, runs=(1, 1, 0)):
    """K3's tail against K3 and its plain version. `launches` holds one
    `_launcher` per shard over `srcs` (one, or a one-card mesh's); the last
    shard's carries the tail over every shard's partials. Against the
    same launches then K3 `cfl_finish`, and K3 against `cfl_finish_plain`
    on the same partials and scalars: fields, stale p, partials and every
    loop scalar bit for bit (the plain version's NaNs as NaNs), in rounds
    back to back with iscal[run] set to each of `runs` (a round past the
    run's end copies, and still steps), the ticket 0 after each. `sc`
    seeds the loop scalars (`new_scalars`); `cfg` should admit every
    round's cycle (maxcycle). Raises on a difference; returns the number
    of blocks the tail's launch counted."""
    from armon_torch.ops import sweep as K
    nb = launches[0][1]
    S = len(launches)
    dev, dtype = srcs[0][0].device, srcs[0][0].dtype
    sides = []
    for _ in range(2):
        part = torch.zeros((2, S * nb), dtype=dtype, device=dev)
        scal, iscal = K.new_scalars(cfg.dtype, dev, **sc)
        out = [(tuple(torch.empty_like(a) for a in src), torch.empty_like(src[0]))
               for src in srcs]
        sides.append((part, scal, iscal, out))
    (pa, sa, ia, oa), (pb, sb, ib, ob) = sides
    ticket = K.new_ticket(dev)
    fin = K.Finish(pa, S * nb, ticket)
    for r, run in enumerate(runs):
        ia[K.IS_RUN] = run
        ib[K.IS_RUN] = run
        for k, (launch, _) in enumerate(launches):
            launch(*oa[k], pa[:, k * nb:(k + 1) * nb], sa, ia,
                   fin if k == S - 1 else None)
            launch(*ob[k], pb[:, k * nb:(k + 1) * nb], sb, ib, None)
        s0, i0 = sb.clone(), ib.clone()
        K.cfl_finish(cfg, pb, S * nb, sb, ib)
        K.cfl_finish_plain(cfg, pb, S * nb, s0, i0)
        torch.cuda.synchronize()
        same = int(ticket) == 0 and all(
            _bits_equal(torch, a, b) for (da, p_a), (db, p_b) in zip(oa, ob)
            for a, b in zip(da + (p_a,), db + (p_b,)))
        same = same and all(_bits_equal(torch, a, b)
                            for a, b in ((pa, pb), (sa, sb), (ia, ib)))
        plain = bool(((sb == s0) | (sb.isnan() & s0.isnan())).all()) \
            and torch.equal(ib, i0)
        if not (same and plain):
            raise AssertionError(
                f"{what}: K3's tail, round {r} (run={run}): tail {sa.tolist()} "
                f"{ia.tolist()} ticket {int(ticket)}, K3 {sb.tolist()} "
                f"{ib.tolist()}, plain {s0.tolist()} {i0.tolist()}")
    return S * nb


def _tail_cases(torch, cfg, kinds, src, sc, what, nan=True):
    """`_tail_check` of one launch of each of `kinds` on `src`, then (with
    `nan`) again with a NaN in u, which fails the dt gate; `cfg` is
    lifted to admit every round. Returns {kind: blocks folded}."""
    import dataclasses
    cfg = dataclasses.replace(cfg, maxcycle=1 << 23, maxtime=1e30)
    out = {}
    for kind in kinds:
        out[kind] = _tail_check(torch, cfg, [_launcher(kind, cfg, src)], [src],
                                sc, f"{what} {kind}")
        if nan:
            bad = tuple(a.clone() for a in src)
            bad[1][cfg.nghost + 3, cfg.nghost + 2] = float("nan")
            _tail_check(torch, cfg, [_launcher(kind, cfg, bad)], [bad], sc,
                        f"{what} {kind} NaN")
            del bad
    return out


def _gate(fields, dtype, fast):
    """Tolerances: f64 1e-13 relative (bitwise expected: -fmad=false and
    IEEE divides on both sides); f32 exact 4 ulp; f32 fast math 1e-4
    relative (approximate reciprocals against exact divides)."""
    for name, (absd, rel, ulp) in fields.items():
        if dtype == "float64":
            ok = rel <= 1e-13
        elif not fast:
            ok = ulp is not None and ulp <= 4
        else:
            ok = rel <= 1e-4
        if not ok:
            raise AssertionError(f"{dtype} fast={fast} {name}: abs {absd} "
                                 f"rel {rel} ulp {ulp}")


def phase1(torch, n=1024, cycles=3):
    results = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in (("float64", False), ("float32", False),
                            ("float32", True)):
            results.append(_phase1_case(torch, test, n, dtype, fast, cycles))
    # C1: a strip of more than 65535 padded rows (K1 puts rows on grid_x),
    # bit for bit in f32 exact.
    results.append(_phase1_case(torch, "Sod_circ", STRIP_N, "float32", False,
                                cycles, bitwise=True))
    emit({"phase": 1, "checks": results, "fold_checks": _fold_checks(torch)})
    return results


def _fold_checks(torch, cycles=3):
    """The cross-sweep EOS fold (`armon_torch/ops/eos.folds`) in every form
    the routes launch, against the plain versions with the same folds, bit
    for bit on real cells (exact mode, f64 and f32): Strang's three sweeps
    (X leaves the unscaled density, the middle Y reads and leaves it, the
    last X reads it and emits) and a Y-first pair, with mirror fills and
    with slabs packed from the launch's own input (a mesh's middle
    shard); K4 X first and Y first, leaving the scaled or the unscaled
    density. On Sedov 1000 x 900 (1/dx = 500, 1/dy = 450: the fold
    changes bits, and a constant taken from the wrong axis would show)
    and Sod_circ 1024^2 (1/dx a power of two), after `cycles` cycles."""
    from armon_torch.ops import sweep as K
    from armon_torch.utils.enums import Axis
    X, Y = Axis.X, Axis.Y
    seqs = {"strang": ((X, K.Fold(None, True)), (Y, K.Fold(X, True)),
                       (X, K.Fold(Y, False))),
            "yx": ((Y, K.Fold(None, True)), (X, K.Fold(Y, False)))}
    out = []
    for test, n in (("Sedov", (1000, 900)), ("Sod_circ", 1024)):
        for dtype in ("float64", "float32"):
            params, fs, dt = _state_after(torch, test, n, dtype, False, cycles)
            cfg = params.config
            g = cfg.nghost
            src = tuple(fs[:4])
            dev, shape = src[0].device, src[0].shape
            scal, iscal = K.new_scalars(cfg.dtype, dev)
            scal[K.SC_DTUSE] = dt
            iscal[K.IS_RUN] = 1
            dt_t = scal[K.SC_DTUSE] * 1.0
            part = torch.zeros((2, max(K.n_partials(a, shape, dev) for a in (X, Y))),
                               dtype=src[0].dtype, device=dev)
            err = 0.0
            for name, seq in seqs.items():
                for slab in (False, True):
                    cur = src
                    for j, (axis, fold) in enumerate(seq):
                        last = j + 1 == len(seq)
                        ghosts = K.MIRRORED
                        if slab:
                            lo, hi = ((slice(None), slice(g, 2 * g)),
                                      (slice(None), slice(-2 * g, -g)))
                            if axis is Y:
                                lo, hi = lo[::-1], hi[::-1]
                            ghosts = tuple(torch.stack([a[s] for a in cur]).contiguous()
                                           for s in (lo, hi))
                        dst = tuple(torch.empty_like(a) for a in src)
                        p = torch.empty_like(src[0])
                        (K.x_sweep if axis is X else K.y_sweep)(
                            cfg, cur, dst, p, part, scal, iscal, 1.0, last,
                            ghosts, fold=fold)
                        ref = K.sweep_plain(cfg, axis, *cur, dt_t, ghosts,
                                            fold=fold)
                        torch.cuda.synchronize()
                        what = f"fold {test} {n} {dtype} {name} slab={slab} sweep {j}"
                        err = max(err, _gate_fields(
                            torch, dst + ((p,) if last else ()),
                            ref[:5 if last else 4], g, False, what))
                        cur = dst
            for x_first in (True, False):
                for keep in (False, True):
                    err = max(err, _k4_vs_plain(
                        torch, cfg, src, dt, x_first, False,
                        f"fold K4 {test} {n} {dtype} x_first={x_first} keep={keep}",
                        keep=keep))
            out.append({"test": test, "n": n, "dtype": dtype, "max_abs_err": err})
    return out


def _phase1_case(torch, test, n, dtype, fast, cycles, bitwise=False):
    params, fs, dt = _state_after(torch, test, n, dtype, fast, cycles)
    res = check_sweeps(torch, params, fs, dt)
    # K3's tail in K1's and K2's emitting launch (a NaN case on Sod_circ).
    res["tail_blocks"] = _tail_cases(
        torch, params.config, ("x_sweep", "y_sweep"), tuple(fs[:4]),
        dict(cycle=cycles, dt_prev=dt, lm=1.0), f"{test} {n} {dtype} fast={fast}",
        nan=test == "Sod_circ")
    for ax in ("X", "Y"):
        _gate(res[ax]["fields"], dtype, fast)
        if bitwise and any(d[0] for d in res[ax]["fields"].values()):
            raise AssertionError(f"{test} {n} {dtype}: not bit for bit: {res[ax]}")
        cfl_tol = 0.0 if bitwise else 1e-13 if dtype == "float64" else (
            8 * 1.2e-7 if not fast else 1e-4)
        if res[ax]["cfl_max_rel"] > cfl_tol or not res[ax]["k3_equal"]:
            raise AssertionError(f"CFL check failed: {test} {dtype} "
                                 f"fast={fast}: {res[ax]}")
    return {"test": test, "dtype": dtype, "fast": fast, "n": n, "dt": dt, **res}


def _read_golden(path, dtype):
    import numpy as np
    with open(path) as f:
        dt_s, cyc_s = f.readline().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1).astype(dtype)
    return np.dtype(dtype).type(dt_s), int(cyc_s), data


GOLDEN_MODES = (("float64", False), ("float32", False), ("float32", True))
GOLDEN_TESTS = ("Sod", "Sod_y", "Sod_circ", "Sedov", "Bizarrium")
# The JAX package's golden gates (`tests/test_convergence.py:50-86`): most
# differing cells, largest relative difference, largest non-p one (None: no
# gate), as `tests/test_torch_op_path.py` `GATES`. Sedov f64's gate is zero
# differences, which every route meets with the cross-sweep EOS fold
# (`armon_torch/ops/eos.folds`, ROADMAP C2).
GOLDEN_GATES = {("Sod", 64): (0, 0.0, None), ("Sod", 32): (0, 0.0, None),
                ("Sedov", 64): (0, 0.0, None), ("Sedov", 32): (1500, 1e-4, None),
                ("Bizarrium", 64): (16000, 1e-5, 1e-12),
                ("Bizarrium", 32): (6000, None, 5e-3)}


def _golden_diffs(ref, ours, bits):
    """(differing cells, largest relative difference, largest non-p one)
    over the saved variables (x, y, rho, u, v, p), with the JAX package's
    comparator (`armon_tpu/io/output.py` `count_differences`)."""
    import numpy as np
    atol = 1e-13 if bits == 64 else 1e-5
    rtol = 4 * np.finfo(np.float64).eps if bits == 64 \
        else 20 * np.finfo(np.float32).eps
    ref, ours = ref.astype(np.float64), ours.astype(np.float64)
    err = np.abs(ref - ours)
    bad = ~(err <= np.maximum(atol, rtol * np.maximum(np.abs(ref), np.abs(ours))))
    rel = np.where(bad, err / np.maximum(np.abs(ref), 5e-324), 0.0)
    return int(bad.sum()), float(rel.max()), float(rel[:, :5].max())


def _goldens(torch, route, modes=GOLDEN_MODES):
    """The five cases at 100^2 through `armon()` on one route, held to the
    JAX package's gates (`GOLDEN_GATES`: zero differences for the Sod
    family) in f64 and f32 exact; the f32 fast-math counts are
    reported."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.interop import to_numpy
    rows = []
    for test in GOLDEN_TESTS:
        for dtype, fast in modes:
            bits = 64 if dtype == "float64" else 32
            ref_dt, ref_cycles, ref = _read_golden(
                os.path.join(REF_DIR, f"ref_{test}_{bits}bits.csv"), dtype)
            params = ArmonParameters(
                test=test, N=(100, 100), data_type=dtype, scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod", nghost=4,
                maxcycle=1000, silent=5, measure_time=False,
                return_data=True, use_fast_math=fast, device="cuda",
                **route)
            stats = armon(params)
            st = to_numpy(stats.data)
            g = params.nghost
            ours = np.stack([getattr(st, v)[g:-g, g:-g].reshape(-1)
                             for v in ("x", "y", "rho", "u", "v", "p")], 1)
            diffs, largest, non_p = _golden_diffs(ref, ours, bits)
            rows.append({"test": test, "dtype": dtype, "fast": fast,
                         "cycles": stats.cycles, "ref_cycles": ref_cycles,
                         "diffs": diffs, "max_rel": largest, "max_rel_non_p": non_p})
            most, top, top_non_p = GOLDEN_GATES[
                ("Sod" if test.startswith("Sod") else test, bits)]
            missed = (diffs > most or stats.cycles != ref_cycles
                      or (top == 0.0 and largest != 0.0)
                      or (top and largest >= top)
                      or (top_non_p is not None and non_p >= top_non_p))
            if not fast and missed:
                raise AssertionError(f"golden {test} {dtype} {route}: {rows[-1]}")
    # Sedov's counts on this route, a line of their own (ROADMAP C2).
    emit({"sedov_golden": route, "counts": {
        f"{r['dtype']}{'_fast' if r['fast'] else ''}": [r["diffs"], r["max_rel"]]
        for r in rows if r["test"] == "Sedov"}})
    return rows


def phase2(torch):
    rows = _goldens(torch, PER_SWEEP)
    emit({"phase": 2, "goldens": rows})
    return rows


def phase3(torch):
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import conservation_vars, conservation_scalar
    from armon_torch.utils.enums import Axis
    from armon_torch.core.state import FusedCarry
    opts = dict(test="Sod", N=(MAIN_N, MAIN_N), data_type="float32",
                scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
                nghost=4, axis_splitting="Sequential", use_fast_math=True,
                silent=5, device="cuda")
    armon(ArmonParameters(maxcycle=2, **opts))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = ArmonParameters(maxcycle=MAIN_CYCLES, check_result=True,
                             return_data=True, **opts)
    cfg = params.config
    K.reset_launches()
    G.reset_launches()
    stats = armon(params)
    torch.cuda.synchronize()
    launches, tails = saved_counts(K)
    conds = G.LAUNCHES["while_tail"]  # the whole-run graph's iterations
    peak = torch.cuda.max_memory_allocated()
    st = stats.data
    m, e = conservation_vars(cfg, st.rho, st.E)
    m, e = conservation_scalar(cfg, m), conservation_scalar(cfg, e)
    mass_drift = abs(m - params.initial_mass) / params.initial_mass
    energy_drift = abs(e - params.initial_energy) / params.initial_energy
    if stats.cycles != MAIN_CYCLES or not np.isfinite(st.rho.sum().item()):
        raise AssertionError(f"main path: {stats.cycles} cycles")
    counts = {**launches, **tails}
    for name in ("x_sweep", "y_sweep", "cfl_finish", "cfl_tail"):
        if counts[name] == 0:
            raise AssertionError(f"main path never launched {name}")
    if launches["cycle"] or launches["multicycle"]:
        raise AssertionError(f"8192^2 left the per-sweep route: {launches}")
    # Two launches a cycle: K1, then K2 with K3's tail; K3 once, for the
    # first step; the run is one whole-run graph, whose condition K2's
    # tail sets once a body.
    if not (launches["cfl_finish"] == 1 and launches["x_sweep"]
            == launches["y_sweep"] == tails["cfl_tail"]):
        raise AssertionError(f"main path sequencing: {launches} {tails}")
    if conds == 0 or stats.host_reads != 3:
        raise AssertionError(f"main path: {conds} WHILE iterations, "
                             f"{stats.host_reads} host reads")
    if mass_drift > 1e-6 or energy_drift > 1e-6:
        raise AssertionError(f"conservation drift {mass_drift} {energy_drift}")
    cells = MAIN_N * MAIN_N
    main = {"phase": 3, "N": MAIN_N, "cycles": stats.cycles,
            "solve_s": stats.solve_time,
            "cells_per_s": cells * stats.cycles / stats.solve_time,
            "grind_ns": stats.solve_time / stats.cycles / cells * 1e9,
            "host_reads": stats.host_reads, "launches": launches, "tails": tails,
            "launches_per_cycle": sum(launches.values()) / stats.cycles,
            "while_tail": conds,
            "mass_drift": mass_drift, "energy_drift": energy_drift,
            "max_memory_allocated": peak, "memory_allocated_before": before}

    # Kernels at the main path's shapes: times (CUDA events), their plain
    # versions' times, bounds, and the check against the plain versions.
    fs_src = (st.rho, st.u, st.v, st.E)
    shape = st.rho.shape
    dev = st.rho.device
    dst = tuple(torch.empty_like(a) for a in fs_src)
    p = torch.empty_like(st.rho)
    nbx = K.n_partials(Axis.X, shape, dev)
    nby = K.n_partials(Axis.Y, shape, dev)
    partials = torch.zeros((2, max(nbx, nby)), dtype=st.rho.dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = stats.last_dt
    iscal[K.IS_RUN] = 1
    field_bytes = st.rho.numel() * st.rho.element_size()
    ops = SWEEP_OPS_PER_CELL * st.rho.numel()

    saved = saved_counts(K)
    x_ms = time_ms(lambda i: K.x_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, False), k=20)
    y_ms = time_ms(lambda i: K.y_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, True), k=20)
    # K3, and K1, K2 and K4 with and without its tail: each call from the
    # same scalars (an untimed reset before it), so every call folds.
    import dataclasses
    from armon_torch.ops import cycle as C
    tcfg = dataclasses.replace(cfg, maxcycle=1 << 23, maxtime=1e30)
    s0, i0 = scal.clone(), iscal.clone()
    s2, i2 = scal.clone(), iscal.clone()

    def reset():
        s2.copy_(s0)
        i2.copy_(i0)
    k3_ms = time_ms(lambda i: K.cfl_finish(tcfg, partials, nby, s2, i2),
                    k=50, reset=reset)
    part4 = torch.zeros((2, C.n_partials(shape, dev, cfg.dtype)),
                        dtype=st.rho.dtype, device=dev)

    def with_tail(launch, part, nb):
        """ms of `launch(finish)` without and with the tail over nb
        partials, three passes each in turns. The tail's cost is the
        difference of the best passes, resolved where it exceeds the
        spread of either side's passes."""
        fin = K.Finish(part, nb, K.new_ticket(dev))
        out = {"without": [], "with": []}
        for _ in range(3):
            for key, f in (("without", None), ("with", fin)):
                out[key].append(time_ms(lambda i: launch(f), k=20, reset=reset))
        d = min(out["with"]) - min(out["without"])
        spread = max(max(v) - min(v) for v in out.values())
        return {**out, "tail_ms": d, "spread_ms": spread, "resolved": d > spread}
    tails_ms = {
        "y_sweep": with_tail(lambda f: K.y_sweep(
            tcfg, fs_src, dst, p, partials, s2, i2, 1.0, True, finish=f),
            partials, nby),
        "x_sweep": with_tail(lambda f: K.x_sweep(
            tcfg, fs_src, dst, p, partials, s2, i2, 1.0, True, finish=f),
            partials, nbx),
        "cycle": with_tail(lambda f: C.cycle(
            tcfg, True, 1.0, 1.0, fs_src, dst, p, part4, s2, i2, True, finish=f),
            part4, part4.shape[1])}
    reset()
    dt_t = scal[K.SC_DTUSE] * 1.0
    xp_ms = time_ms(lambda i: K.sweep_plain(cfg, Axis.X, *fs_src, dt_t), k=3)
    yp_ms = time_ms(lambda i: K.sweep_plain(cfg, Axis.Y, *fs_src, dt_t), k=3)
    k3p_ms = time_ms(lambda i: K.cfl_finish_plain(tcfg, partials, nby, s2.clone(),
                                                 i2.clone()), k=20)
    amax_ms = time_ms(lambda i: torch.amax(partials[:, :nby], dim=1), k=50)
    # K4 on the same state (8200^2 padded; X first, the full dt on both
    # sweeps): the pair route's kernel at the main path's size, timed and
    # held against its plain version within the fast-math gate.
    k4_ms = time_ms(lambda i: C.cycle(cfg, True, 1.0, 1.0, fs_src, dst, p,
                                      part4, scal, iscal, True), k=20)
    k4_err = _k4_vs_plain(torch, cfg, fs_src, stats.last_dt, True, True,
                          f"K4 at Sod {MAIN_N}^2 fast math", factors=(1.0, 1.0))
    del part4
    # The exact instances (f32, IEEE divides) on the same state, as a
    # Sequential cycle launches them with the cross-sweep EOS fold: K1
    # leaves the unscaled new density, K2 rebuilds rho from it. Timed
    # beside the fast-math launches above, and held bit for bit against
    # the plain versions with the same folds.
    ecfg = dataclasses.replace(cfg, fast_math=False)
    f1, f2 = K.Fold(None, True), K.Fold(Axis.X, False)
    emid = tuple(torch.empty_like(a) for a in fs_src)
    eout = tuple(torch.empty_like(a) for a in fs_src)
    ep = torch.empty_like(st.rho)
    xe_ms = time_ms(lambda i: K.x_sweep(ecfg, fs_src, emid, ep, partials, scal,
                                       iscal, 1.0, False, fold=f1), k=20)
    ye_ms = time_ms(lambda i: K.y_sweep(ecfg, emid, eout, ep, partials, scal,
                                       iscal, 1.0, True, fold=f2), k=20)
    ref1 = K.sweep_plain(ecfg, Axis.X, *fs_src, dt_t, fold=f1)[:4]
    ref2 = K.sweep_plain(ecfg, Axis.Y, *ref1, dt_t, fold=f2)[:5]
    torch.cuda.synchronize()
    exact_err = _gate_fields(torch, emid + eout + (ep,), ref1 + ref2,
                             cfg.nghost, False,
                             f"K1 -> K2 f32 exact, folded, at Sod {MAIN_N}^2")
    del emid, eout, ep, ref1, ref2

    # Against the plain version at these shapes (f32 fast math vs exact).
    checks = check_sweeps(torch, params, FusedCarry(st.rho, st.u, st.v, st.E, st.p),
                          stats.last_dt)
    # K3's tail in K1, K2 and K4 at 8200^2: thousands of blocks a launch.
    checks["tail_blocks"] = _tail_cases(
        torch, cfg, ("x_sweep", "y_sweep", "cycle"), fs_src,
        dict(t=stats.final_time, cycle=stats.cycles, dt_prev=stats.last_dt,
             lm=params._final_local_min), f"Sod {MAIN_N}^2")
    for ax in ("X", "Y"):
        _gate(checks[ax]["fields"], "float32", True)
        if checks[ax]["cfl_max_rel"] > 1e-4 or not checks[ax]["k3_equal"]:
            raise AssertionError(f"main-path CFL check failed: {checks[ax]}")
    restore_counts(K, saved)  # timing and check launches are not main-path ones

    part_bytes = 2 * nby * st.rho.element_size()
    # The tail has no launch of its own: its entry times the main path's
    # launch that carries it, K2 with the tail (`y_sweep_finish_kernel`),
    # against K2's and K3's plain versions, with the bound of both.
    carrier = tails_ms["y_sweep"]
    kernels = []
    for name, src_file, replaces, ms, pms, nbytes, nops, lib, diffs in (
            ("x_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:978", x_ms, xp_ms,
             8 * field_bytes, ops, None, checks["X"]["fields"]),
            ("y_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:1092", y_ms, yp_ms,
             9 * field_bytes + part_bytes, ops, None, checks["Y"]["fields"]),
            ("cfl_finish", "armon_torch/csrc/cfl.cu",
             "armon_tpu/ops/pallas/sweep.py:968", k3_ms, k3p_ms,
             part_bytes + 64, 4 * nby, amax_ms, None),
            ("cfl_tail", "armon_torch/csrc/common.cuh",
             "armon_tpu/ops/pallas/sweep.py:924", min(carrier["with"]),
             yp_ms + k3p_ms, 9 * field_bytes + 2 * part_bytes + 64,
             ops + 4 * nby, None, None)):
        b_ms, b_by = bound_f32(nbytes, nops)
        # K3 against its plain version; the tail's check raised on any
        # difference from K3 and its plain version.
        err = max(d[0] for d in diffs.values()) if diffs else \
            (0.0 if checks["Y"]["k3_equal"] or name == "cfl_tail" else float("inf"))
        kernels.append({"name": name, "route": "cuda", "source": src_file,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib})
    kernels[-1].update(carrier="y_sweep", tail_ms=carrier["tail_ms"],
                       tail_resolved=carrier["resolved"])
    main["kernel_ms"] = {"x_sweep": x_ms, "y_sweep": y_ms, "cfl_finish": k3_ms,
                         "cycle_8200": k4_ms,
                         "with_and_without_tail_from_reset": tails_ms}
    main["kernel_ms_exact"] = {"x_sweep": xe_ms, "y_sweep": ye_ms,
                               "folded_max_abs_err": exact_err}
    main["checks"] = checks
    main["cycle_8200_fast_math_max_abs_err"] = k4_err
    emit(main)
    return kernels + [{"cells_per_s": main["cells_per_s"],
                       "kernel_ms": main["kernel_ms"], "while_tail": conds,
                       "ff_sum_launches": counts["ff_sum"],
                       "memory": {"peak": peak, "before": before}}]


# ------------------------------------------------------- small-grid routes

SMALL_OPTS = dict(data_type="float32", scheme="GAD", projection="euler_2nd",
                  riemann_limiter="minmod", nghost=4, use_fast_math=True,
                  maxtime=1e30, silent=5, device="cuda")
SEDOV_N, SEDOV_CYCLES = 2000, 1000  # BASELINE config 3
SOD_N, SOD_CYCLES = 100, 4000       # BASELINE config 1


def _exact_cfgs(test, N, **extra):
    """(dtype, config) in f32 and f64 exact mode (no fast math), the timed
    runs' other options kept: the configs that hold a kernel bit for bit
    against its plain version on a timed run's final state."""
    from armon_torch import ArmonParameters
    return [(dtype, ArmonParameters(
        test=test, N=N, **{**SMALL_OPTS, "data_type": dtype,
                           "use_fast_math": False, **extra}).config)
            for dtype in ("float32", "float64")]


def _loop_from_init(params):
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    [fs], seed = make_init_fused(params)()
    return make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))


def _gate_fields(torch, got, ref, g, fast, what):
    """Real cells of each pair: bit for bit in exact mode, within 1e-4 of
    the field's scale in fast math. Returns the max abs difference."""
    r = (slice(g, -g), slice(g, -g))
    err = 0.0
    for a, b in zip(got, ref):
        d = float((a[r] - b[r]).abs().max())
        err = max(err, d)
        ok = (d <= 1e-4 * float(b[r].abs().max())) if fast \
            else torch.equal(a[r], b[r])
        if not ok:
            raise AssertionError(f"{what}: max abs diff {d}")
    return err


def _k4_vs_plain(torch, cfg, src, dt, x_first, fast, what,
                 factors=(0.5, 1.0), keep=False):
    """One emitting K4 launch against `cycle_plain` on the same inputs, and
    K3 on its partials against K3's plain version. `factors` are the dt
    factors of the first and the second sweep (Strang's pair by default);
    `keep`, the second sweep leaves its new density unscaled (the
    cross-sweep EOS fold, `ops/sweep.Fold`). Returns the max abs
    difference of the fields."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    dev = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, dev, cfg.dtype)
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    fx, fy = factors if x_first else factors[::-1]
    C.cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal, True,
            keep=keep)
    dt_t = scal[K.SC_DTUSE]
    ref = C.cycle_plain(cfg, x_first, *src, dt_t * fx, dt_t * fy, keep=keep)
    torch.cuda.synchronize()
    err = _gate_fields(torch, dst + (p,), ref[:5], cfg.nghost, fast, what)
    for got, want in ((partials[0].max(), ref[5]), (partials[1].max(), ref[6])):
        if abs(float(got) - float(want)) > (1e-4 * float(want) if fast else 0.0):
            raise AssertionError(f"{what}: CFL max {float(got)} vs {float(want)}")
    s2, i2 = scal.clone(), iscal.clone()
    K.cfl_finish(cfg, partials, nb, scal, iscal)
    K.cfl_finish_plain(cfg, partials, nb, s2, i2)
    if not (torch.equal(scal, s2) and torch.equal(iscal, i2)):
        raise AssertionError(f"{what}: K3 on K4's partials")
    return err


def _k4_vs_sweeps(torch, cfg, src, dt):
    """One emitting K4 launch (X first, the full dt on both sweeps)
    against K1 then K2 on the same state and mode, each in the cross-sweep
    EOS fold of a Sequential cycle where the mode takes it: (max abs
    difference of rho/u/v/E/p on real cells, the largest over each
    field's scale)."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.utils.enums import Axis
    dev, shape = src[0].device, src[0].shape
    on = K.fold_on(cfg, dev)
    f1, f2 = (K.Fold(None, True), K.Fold(Axis.X, False)) if on else (None, None)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    part = torch.zeros((2, max(K.n_partials(Axis.Y, shape, dev),
                               C.n_partials(shape, dev, cfg.dtype))),
                       dtype=src[0].dtype, device=dev)
    mid, out, out4 = ([torch.empty_like(a) for a in src] for _ in range(3))
    p, p4 = torch.empty_like(src[0]), torch.empty_like(src[0])
    K.x_sweep(cfg, src, mid, p, part, scal, iscal, 1.0, False, fold=f1)
    K.y_sweep(cfg, mid, out, p, part, scal, iscal, 1.0, True, fold=f2)
    C.cycle(cfg, True, 1.0, 1.0, src, out4, p4, part, scal, iscal, True)
    torch.cuda.synchronize()
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    err = rel = 0.0
    for a, b in zip(out4 + [p4], out + [p]):
        d = float((a[r] - b[r]).abs().max())
        err = max(err, d)
        rel = max(rel, d / max(float(b[r].abs().max()), 1e-300))
    return err, rel


def _k5_inputs(torch, cfg, src, p, sc):
    """Fresh copies of K5's operands: [fields, second buffer set, stale p,
    scal, iscal], the loop scalars from `sc` (t, cycle, dt_prev, lm)."""
    from armon_torch.ops import sweep as K
    scal, iscal = K.new_scalars(cfg.dtype, src[0].device, **sc)
    return [tuple(a.clone() for a in src), tuple(torch.empty_like(a) for a in src),
            p.clone(), scal, iscal]


def _k5_check(torch, cfg, pairs, src, p, sc, fast, what):
    """One K5 launch against `multicycle_plain` on copies of the same
    inputs (each with the cross-sweep EOS fold where the mode takes it):
    fields, p and every loop scalar, bit for bit in exact mode. Returns
    (max abs diff, the cycle counter after the launch)."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    a, b = _k5_inputs(torch, cfg, src, p, sc), _k5_inputs(torch, cfg, src, p, sc)
    C.multicycle(cfg, pairs, a[0], a[1], a[2],
                 C.new_multicycle_partials(src[0].shape, cfg.dtype, src[0].device),
                 a[3], a[4])
    C.multicycle_plain(cfg, pairs, len(pairs), *b)
    torch.cuda.synchronize()
    k = len(pairs) % 2  # the buffer set the carry ends in
    err = _gate_fields(torch, a[k] + (a[2],), b[k] + (b[2],), cfg.nghost,
                       fast, what)
    if not torch.equal(a[4], b[4]):
        raise AssertionError(f"{what}: loop ints {a[4].tolist()} vs {b[4].tolist()}")
    if fast:
        rel = float(((a[3] - b[3]).abs() / b[3].abs().clamp_min(1e-30)).max())
        if rel > 1e-4:
            raise AssertionError(f"{what}: loop scalars off by {rel}")
    elif not torch.equal(a[3], b[3]):
        raise AssertionError(f"{what}: loop scalars {a[3].tolist()} vs {b[3].tolist()}")
    return err, int(a[4][K.IS_CYCLE])


def _k5_vs_plain(torch, params, warm, what):
    """One K5 launch from the state after `warm` per-sweep cycles against
    `multicycle_plain` on the same inputs (`_k5_check`). Returns (max abs
    diff, cycles run)."""
    import numpy as np
    from armon_torch import ArmonParameters
    from armon_torch.ops.routing import temporal_pairs
    cfg = params.config
    fast = params.use_fast_math and cfg.dtype == np.float32
    opts = {k: getattr(params, k) for k in ("N", "data_type", "use_fast_math",
                                             "axis_splitting", "cst_dt", "Dt",
                                             "dt_on_even_cycles")}
    res = _loop_from_init(ArmonParameters(
        test=params.test, maxcycle=warm, silent=5, device="cuda", **opts,
        **PER_SWEEP))
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    err, cyc = _k5_check(torch, cfg, temporal_pairs(cfg), tuple(res.carry[:4]),
                         res.carry.p, sc, fast, what)
    return err, cyc - res.cycles


def _routes_bitwise(torch, test, n, dtype, routes, cycles=20):
    """The same run on each route: equal bits on real cells and equal t,
    cycles, dt and lm (exact mode). `n`: the side of a square grid, or
    N."""
    from armon_torch import ArmonParameters
    from armon_torch.ops.routing import route as route_of
    out, names = [], []
    for route in routes:
        N = tuple(n) if isinstance(n, tuple) else (n, n)
        params = ArmonParameters(test=test, N=N, data_type=dtype,
                                 use_fast_math=False, maxcycle=cycles,
                                 silent=5, device="cuda", **route)
        names.append(route_of(params.config))
        out.append(_loop_from_init(params))
    g = 4
    for name, res in zip(names[1:], out[1:]):
        base = out[0]
        same = (res.t, res.cycles, res.dt_last, res.lm) == \
            (base.t, base.cycles, base.dt_last, base.lm) and all(
                torch.equal(a[g:-g, g:-g], b[g:-g, g:-g])
                for a, b in zip(res.carry, base.carry))
        if not same:
            raise AssertionError(f"route {name} differs from {names[0]} at "
                                 f"{test} {N} {dtype} {routes[0]}")
    return names


def _timed(torch, test, n, cycles, **route):
    """A warm-up run, then `cycles` timed cycles through `armon()` (f32
    fast math, maxtime=1e30), with the launch counts, host reads, peak
    memory and conservation drift of the timed run. `route` may place a
    mesh (`P`, `devices`)."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import conservation_vars, conservation_scalar
    from armon_torch.ops.routing import route as route_of
    opts = dict(test=test, N=(n, n), **SMALL_OPTS, **route)
    armon(ArmonParameters(maxcycle=16, **opts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = ArmonParameters(maxcycle=cycles, check_result=True,
                             return_data=True, **opts)
    cfg = params.config
    K.reset_launches()
    stats = armon(params)
    torch.cuda.synchronize()
    launches, tails = saved_counts(K)
    peak = torch.cuda.max_memory_allocated()
    st = stats.data
    if stats.cycles != cycles or not np.isfinite(float(st.rho.sum())):
        raise AssertionError(f"{test} {n}^2 {route}: {stats.cycles} cycles")
    m, e = conservation_vars(cfg, st.rho, st.E, cfg.n_global)
    cells = n * n
    return {"test": test, "N": n, "route": route_of(cfg),
            "options": {k: v for k, v in route.items() if k != "devices"},
            "cycles": stats.cycles, "solve_s": stats.solve_time,
            "cells_per_s": cells * stats.cycles / stats.solve_time,
            "grind_ns": stats.solve_time / stats.cycles / cells * 1e9,
            "cycle_ms": stats.solve_time / stats.cycles * 1e3,
            "host_reads": stats.host_reads, "launches": launches, "tails": tails,
            "kernel_launches_per_cycle": sum(launches.values()) / stats.cycles,
            "max_memory_allocated": peak, "memory_allocated_before": before,
            "mass_drift": abs(conservation_scalar(cfg, m) - params.initial_mass)
            / params.initial_mass,
            "energy_drift": abs(conservation_scalar(cfg, e) - params.initial_energy)
            / params.initial_energy}, params, stats


def phase4(torch):
    """The small-grid routes: K4/K5 against their plain versions, the
    routes against each other, the goldens, and timed runs of BASELINE
    configs 3 and 1; returns the kernels-line entries of K4 and K5."""
    from armon_torch import ArmonParameters
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.core.state import FusedCarry
    from armon_torch.ops.routing import temporal_pairs
    out = {"phase": 4}
    modes = (("float64", False), ("float32", False), ("float32", True))

    # (a) each kernel against its plain version
    k4 = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in modes:
            params, fs, dt = _state_after(torch, test, 1024, dtype, fast, 3)
            for x_first in (True, False):
                err = _k4_vs_plain(torch, params.config, tuple(fs[:4]), dt,
                                   x_first, fast,
                                   f"K4 {test} {dtype} fast={fast} x_first={x_first}")
                k4.append({"test": test, "dtype": dtype, "fast": fast,
                           "x_first": x_first, "max_abs_err": err})
    out["k4_vs_plain"] = k4
    k5 = []
    for test, extra in (("Sod", {}), ("Sod_circ", dict(axis_splitting="Godunov")),
                        ("Sod", dict(maxcycle=13)),
                        ("Sod_circ", dict(dt_on_even_cycles=True)),
                        ("Sod", dict(cst_dt=True, Dt=1e-3))):
        for dtype, fast in modes:
            params = ArmonParameters(test=test, N=(100, 100), data_type=dtype,
                                     use_fast_math=fast, silent=5,
                                     device="cuda", **{"maxcycle": 100, **extra})
            what = f"K5 {test} {extra} {dtype} fast={fast}"
            err, ran = _k5_vs_plain(torch, params, 10, what)
            k5.append({"test": test, "options": extra, "dtype": dtype,
                       "fast": fast, "cycles_run": ran, "max_abs_err": err})
    out["k5_vs_plain"] = k5
    # K5 at the largest grids the routing admits.
    k5x = []
    for dtype, N in K5_GRIDS[1:]:
        for fast in ((False, True) if dtype == "float32" else (False,)):
            params = ArmonParameters(test="Sod_circ", N=N, data_type=dtype,
                                     use_fast_math=fast, silent=5,
                                     device="cuda", maxcycle=100)
            err, ran = _k5_vs_plain(torch, params, 10,
                                    f"K5 Sod_circ {N} {dtype} fast={fast}")
            k5x.append({"N": N, "dtype": dtype, "fast": fast,
                        "cycles_run": ran, "max_abs_err": err})
    out["k5_extremes_vs_plain"] = k5x

    # (b) the routes against each other, exact mode; Sedov on a grid
    # where dx != dy (the cross-sweep EOS fold's constant per axis), with
    # its splitting and with Strang's (the middle sweep reads and leaves
    # the unscaled density)
    strang = {"axis_splitting": "Strang"}
    out["routes_bitwise"] = [
        {"test": test, "N": n, "dtype": dtype, "options": routes[0],
         "routes": _routes_bitwise(torch, test, n, dtype, routes)}
        for test, n, routes in (("Sod_circ", 100, (PER_SWEEP, PAIR, {})),
                                ("Sod_circ", 1024, (PER_SWEEP, PAIR)),
                                ("Sedov", 100, (PER_SWEEP, PAIR, {})),
                                ("Sedov", (131, 77), (PER_SWEEP, PAIR, {})),
                                ("Sedov", (131, 77), ({**PER_SWEEP, **strang},
                                                      {**PAIR, **strang})))
        for dtype in ("float64", "float32")]

    # (c) the goldens through the two new routes (per-sweep: phase 2)
    out["goldens"] = {"pair": _goldens(torch, PAIR), "multicycle": _goldens(torch, {})}

    # (d) timed runs through armon()
    runs = []
    sedov, sedov_params, sedov_stats = _timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES)
    runs.append(sedov)
    runs.append(_timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES, pair_threshold=0)[0])
    sod, sod_params, sod_stats = _timed(torch, "Sod", SOD_N, SOD_CYCLES)
    runs.append(sod)
    runs.append(_timed(torch, "Sod", SOD_N, SOD_CYCLES, temporal_blocking=1)[0])
    la, lb, lc, ld = (r["launches"] for r in runs)
    if not (la["cycle"] and not la["x_sweep"] and not la["y_sweep"]
            and not la["multicycle"]):
        raise AssertionError(f"Sedov {SEDOV_N}^2 default route: {la}")
    if not (lb["x_sweep"] and lb["y_sweep"] and not lb["cycle"]):
        raise AssertionError(f"Sedov {SEDOV_N}^2 pair_threshold=0: {lb}")
    if not (lc["multicycle"] and not lc["cycle"] and not lc["x_sweep"]):
        raise AssertionError(f"Sod {SOD_N}^2 default route: {lc}")
    if not (ld["cycle"] and ld["cfl_finish"] and not ld["multicycle"]):
        raise AssertionError(f"Sod {SOD_N}^2 temporal_blocking=1: {ld}")
    # One launch a cycle on the pair route (K4 with K3's tail), two
    # per-sweep (K1, K2 with the tail); K3 once a run.
    for name, r, last in (("Sedov pair", runs[0], "cycle"),
                          ("Sedov per-sweep", runs[1], "y_sweep"),
                          ("Sod pair", runs[3], "cycle")):
        ln, tails = r["launches"], r["tails"]
        if not (ln["cfl_finish"] == 1 and tails["cfl_tail"] == ln[last]):
            raise AssertionError(f"{name} sequencing: {ln} {tails}")
    out["timed"] = runs

    # Kernels at their paths' shapes: checks against the plain versions
    # on each timed run's final state, bit for bit in f32 exact and f64
    # (those max abs differences go to the kernels line) and within the
    # fast-math gate as timed; then times (CUDA events), plain versions'
    # times and bounds. These launches are not counted as the paths'.
    saved = saved_counts(K)
    kernels = []

    # K4 at Sedov 2000^2 (Sequential: X then Y, the full dt each).
    cfg = sedov_params.config
    st = sedov_stats.data
    src = (st.rho, st.u, st.v, st.E)
    dev = st.rho.device
    k4_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N)):
        for keep in (False, True):  # the cycle's last launch, Strang's pair
            k4_err = max(k4_err, _k4_vs_plain(
                torch, ecfg, tuple(a.to(getattr(torch, dtype)) for a in src),
                sedov_stats.last_dt, True, False,
                f"K4 at Sedov {SEDOV_N}^2 {dtype} exact keep={keep}",
                factors=(1.0, 1.0), keep=keep))
    k4_fast = _k4_vs_plain(torch, cfg, src, sedov_stats.last_dt, True, True,
                           f"K4 at Sedov {SEDOV_N}^2 fast math",
                           factors=(1.0, 1.0))
    # K3's tail in K4's launch at Sedov 2000^2 (as timed, and f32 exact),
    # and on grids of one block (K4 at 40^2, K2 at 96 x 20).
    sc = dict(t=sedov_stats.final_time, cycle=sedov_stats.cycles,
              dt_prev=sedov_stats.last_dt, lm=sedov_params._final_local_min)
    tails = {"sedov_fast": _tail_cases(torch, cfg, ("cycle",), src, sc,
                                       f"Sedov {SEDOV_N}^2 fast math"),
             "sedov_f32_exact": _tail_cases(
                 torch, _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N))[0][1], ("cycle",),
                 src, sc, f"Sedov {SEDOV_N}^2 f32 exact", nan=False)}
    for kind, n in (("cycle", (40, 40)), ("y_sweep", (96, 20))):
        for dtype in ("float64", "float32"):
            tp, tfs, tdt = _state_after(torch, "Sod_circ", n, dtype, False, 3)
            blocks = _tail_cases(torch, tp.config, (kind,), tuple(tfs[:4]),
                                 dict(cycle=3, dt_prev=tdt, lm=1.0),
                                 f"one block {n} {dtype}")
            if blocks[kind] != 1:
                raise AssertionError(f"{kind} at {n}: {blocks} blocks, not one")
            tails[f"{kind}_{n[0]}x{n[1]}_{dtype}"] = blocks
    out["tail_blocks"] = tails
    # K4 against K1 -> K2 on the same state: fast math as timed (reported)
    # and f32 exact (bit for bit, as the routes agree).
    e_abs, e_rel = _k4_vs_sweeps(torch, cfg, src, sedov_stats.last_dt)
    out["k4_vs_k1_k2"] = {"fast_math_max_abs": e_abs, "fast_math_max_rel": e_rel}
    ecfg = _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N))[0][1]
    x_abs, _ = _k4_vs_sweeps(torch, ecfg, src, sedov_stats.last_dt)
    if x_abs != 0.0:
        raise AssertionError(f"K4 f32 exact differs from K1 -> K2 by {x_abs}")
    out["k4_vs_k1_k2"]["exact_max_abs"] = x_abs
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(st.rho)
    nb = C.n_partials(st.rho.shape, dev, cfg.dtype)
    partials = torch.zeros((2, nb), dtype=st.rho.dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = sedov_stats.last_dt
    iscal[K.IS_RUN] = 1
    k4_ms = time_ms(lambda i: C.cycle(cfg, True, 1.0, 1.0, src, dst, p,
                                           partials, scal, iscal, True), k=20)
    dt_t = scal[K.SC_DTUSE]
    k4p_ms = time_ms(lambda i: C.cycle_plain(cfg, True, *src, dt_t, dt_t),
                     k=3)
    # The exact instances on the same state, as the pair route launches
    # them (the cross-sweep EOS fold between the sweeps), beside the
    # fast-math time.
    k4_exact_ms = {}
    for dtype, ecfg in _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N)):
        tdt = getattr(torch, dtype)
        esrc = tuple(a.to(tdt) for a in src)
        edst = tuple(torch.empty_like(a) for a in esrc)
        ep = torch.empty_like(esrc[0])
        epart = torch.zeros((2, C.n_partials(st.rho.shape, dev, ecfg.dtype)),
                            dtype=tdt, device=dev)
        es, ei = K.new_scalars(ecfg.dtype, dev)
        es[K.SC_DTUSE] = sedov_stats.last_dt
        ei[K.IS_RUN] = 1
        k4_exact_ms[dtype] = time_ms(lambda i: C.cycle(
            ecfg, True, 1.0, 1.0, esrc, edst, ep, epart, es, ei, True), k=20)
        del esrc, edst, ep
    fb = st.rho.numel() * st.rho.element_size()
    b_ms, b_by = bound_f32(9 * fb + 2 * nb * st.rho.element_size(),
                          2 * SWEEP_OPS_PER_CELL * st.rho.numel())
    kernels.append({"name": "cycle", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1571",
                    "launches": la["cycle"], "max_abs_err": k4_err,
                    "ms": k4_ms, "plain_ms": k4p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    # K5 at Sod 100^2, one launch of K cycles from the timed run's final
    # state (maxcycle lifted so every cycle runs).
    params = ArmonParameters(test="Sod", N=(SOD_N, SOD_N), maxcycle=1 << 23,
                             **SMALL_OPTS)
    cfg = params.config
    pairs = temporal_pairs(cfg)
    st = sod_stats.data
    fs = FusedCarry(st.rho, st.u, st.v, st.E, st.p)
    sc = dict(t=sod_stats.final_time, cycle=sod_stats.cycles,
              dt_prev=sod_stats.last_dt, lm=sod_params._final_local_min)
    k5_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sod", (SOD_N, SOD_N), maxcycle=1 << 23):
        tdt = getattr(torch, dtype)
        err, cyc = _k5_check(torch, ecfg, temporal_pairs(ecfg),
                             tuple(a.to(tdt) for a in fs[:4]), fs.p.to(tdt),
                             sc, False, f"K5 at Sod {SOD_N}^2 {dtype} exact")
        if cyc != sod_stats.cycles + len(pairs):
            raise AssertionError(f"K5 {dtype} exact did not run every cycle")
        k5_err = max(k5_err, err)
    k5_fast, cyc = _k5_check(torch, cfg, pairs, tuple(fs[:4]), fs.p, sc, True,
                             f"K5 at Sod {SOD_N}^2 fast math")
    if cyc != sod_stats.cycles + len(pairs):
        raise AssertionError("K5 fast math did not run every cycle")
    a = _k5_inputs(torch, cfg, tuple(fs[:4]), fs.p, sc)
    b = _k5_inputs(torch, cfg, tuple(fs[:4]), fs.p, sc)
    part = C.new_multicycle_partials(st.rho.shape, cfg.dtype, dev)
    k5_ms = time_ms(lambda i: C.multicycle(cfg, pairs, a[0], a[1], a[2],
                                                part, a[3], a[4]), k=20)
    k5p_ms = time_ms(lambda i: C.multicycle_plain(cfg, pairs, len(pairs),
                                                       *b), k=2)
    # The exact instances, as the multicycle route launches them (with the
    # cross-sweep EOS fold), each call from the state the one before left.
    k5_exact_ms = {}
    for dtype, ecfg in _exact_cfgs("Sod", (SOD_N, SOD_N), maxcycle=1 << 23):
        tdt = getattr(torch, dtype)
        e = _k5_inputs(torch, ecfg, tuple(a.to(tdt) for a in fs[:4]),
                       fs.p.to(tdt), sc)
        epart = C.new_multicycle_partials(st.rho.shape, ecfg.dtype, dev)
        k5_exact_ms[dtype] = time_ms(lambda i: C.multicycle(
            ecfg, temporal_pairs(ecfg), e[0], e[1], e[2], epart, e[3], e[4]),
            k=20)
    fb = st.rho.numel() * st.rho.element_size()
    b_ms, b_by = bound_f32(10 * fb, 2 * SWEEP_OPS_PER_CELL * st.rho.numel()
                          * len(pairs))
    kernels.append({"name": "multicycle", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1905",
                    "launches": lc["multicycle"], "max_abs_err": k5_err,
                    "ms": k5_ms, "plain_ms": k5p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    out["fast_math_max_abs_err"] = {"cycle": k4_fast, "multicycle": k5_fast}
    restore_counts(K, saved)
    out["kernel_ms"] = {"cycle": k4_ms, "multicycle": k5_ms,
                        "multicycle_per_cycle": k5_ms / len(pairs)}
    out["kernel_ms_exact"] = {"cycle": k4_exact_ms, "multicycle": k5_exact_ms}
    emit(out)
    return kernels + [{"sedov_pair_cells_per_s": sedov["cells_per_s"],
                       "sedov_pair_cycle_ms": sedov["solve_s"] / sedov["cycles"] * 1e3,
                       "cycle_ms": k4_ms}]


# ------------------------------------------------------- route crossovers

def _loop_rate(torch, params, loop, cycles):
    """cells/s of `cycles` cycles of a lean loop from the initial state
    (host clock to a host read), after a warm-up on the same shapes."""
    from armon_torch.core.solver import make_init_fused
    [fs], seed = make_init_fused(params)()
    loop(fs, 0.0, 0, 0.0, float(seed))  # warm-up (maxcycle bounds it)
    [fs], seed = make_init_fused(params)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop(fs, 0.0, 0, 0.0, float(seed))
    dt = time.perf_counter() - t0
    n = params.N[0] * params.N[1]
    return n * res.cycles / dt, res.cycles


def _k5_rate(torch, params, pairs):
    """cells/s of K5 launches of len(pairs) cycles from the initial state
    to maxcycle, with one host read of the stop flag per launch as the
    lean loop's multicycle branch makes them, but on any grid whose tiles
    fit co-resident (past the routing's cap); after a warm-up run."""
    from armon_torch.core.solver import make_init_fused
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    cfg = params.config

    def run():
        [fs], seed = make_init_fused(params)()
        cur = tuple(fs[:4])
        nxt = tuple(torch.empty_like(a) for a in cur)
        part = C.new_multicycle_partials(fs.rho.shape, cfg.dtype, fs.rho.device)
        scal, iscal = K.new_scalars(cfg.dtype, fs.rho.device, lm=float(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        running = True
        while running:
            C.multicycle(cfg, pairs, cur, nxt, fs.p, part, scal, iscal)
            if len(pairs) % 2:
                cur, nxt = nxt, cur
            running = bool(iscal[K.IS_NEXT].item())
        return time.perf_counter() - t0, int(iscal[K.IS_CYCLE])

    run()
    dt, cycles = run()
    return params.N[0] * params.N[1] * cycles / dt


def phase5(torch):
    """Route crossovers, for retuning `pair_threshold` and
    `temporal_blocking` on this card (no default changes here). Sod f32
    fast math: per-sweep against pair at 256^2-8192^2 (alternating
    per, pair, pair, per), kernel times of K1, K2 and K4 at 8192^2, and
    pair against multicycle (K=8) on small grids, K5 driven past the
    routing's 256 KiB cap up to 360^2, the largest grid whose tiles fit
    co-resident on the H100."""
    from armon_torch import ArmonParameters
    from armon_torch.core.step import make_time_loop_lean
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.utils.enums import Axis
    out = {"phase": 5, "card": card_line()}
    rows = []
    for n in (256, 512, 1024, 2048, 4096, 8192):
        cycles = max(40, min(400, int(4e9 // (n * n))))
        rates = {"per_sweep": [], "pair": []}
        for name in ("per_sweep", "pair", "pair", "per_sweep"):
            route = PER_SWEEP if name == "per_sweep" else \
                dict(pair_threshold=n, temporal_blocking=1)
            params = ArmonParameters(test="Sod", N=(n, n), maxcycle=cycles,
                                     **SMALL_OPTS, **route)
            rates[name].append(_loop_rate(torch, params,
                                          make_time_loop_lean(params.config),
                                          cycles)[0])
        rows.append({"N": n, "cycles": cycles, **rates})
    out["pair_vs_per_sweep"] = rows

    # Kernel times at 8192^2 on one state (CUDA events).
    params = ArmonParameters(test="Sod", N=(8192, 8192), maxcycle=4,
                             **SMALL_OPTS, **PER_SWEEP)
    cfg = params.config
    res = _loop_from_init(params)
    src = tuple(res.carry[:4])
    dev = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = max(C.n_partials(src[0].shape, dev, cfg.dtype),
             K.n_partials(Axis.X, src[0].shape, dev),
             K.n_partials(Axis.Y, src[0].shape, dev))
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = res.dt_last
    iscal[K.IS_RUN] = 1
    out["kernel_ms_8192"] = {
        "x_sweep": time_ms(lambda i: K.x_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, False), k=20),
        "y_sweep": time_ms(lambda i: K.y_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, True), k=20),
        "cycle": time_ms(lambda i: C.cycle(
            cfg, True, 1.0, 1.0, src, dst, p, partials, scal, iscal, True),
            k=20)}

    rows = []
    pairs = ((True, 1.0, 1.0),) * 8  # Sequential, K = 8
    for n in (64, 128, 240, 256, 360):
        cycles = 400
        params = ArmonParameters(test="Sod", N=(n, n), maxcycle=cycles,
                                 **SMALL_OPTS, temporal_blocking=1)
        row = {"N": n, "cycles": cycles, "pair": [], "multicycle": []}
        for name in ("pair", "multicycle", "multicycle", "pair"):
            row[name].append(
                _loop_rate(torch, params, make_time_loop_lean(params.config),
                           cycles)[0] if name == "pair"
                else _k5_rate(torch, params, pairs))
        rows.append(row)
    out["multicycle_vs_pair"] = rows
    emit(out)


# ------------------------------------------------- domain-decomposed runs

MESH_N, MESH_P, MESH_CYCLES = 16384, (2, 2), 100  # 8192^2 shards
SEDOV_P = (1, 2)
CHECK_SHARD = 1024   # the slab checks' shard edge
AGREE_N, AGREE_CYCLES, SEDOV_AGREE_CYCLES = 1000, 20, 50


def _one_card(P):
    """Options that place every shard of a P mesh on cuda:0."""
    return dict(P=P, devices=["cuda:0"] * (P[0] * P[1]))


def _mesh_mid_state(torch, test, N, P, dtype, fast, cycles=3, **route):
    """A one-card mesh after `cycles` cycles: (cfg, mesh, result, the dt
    of the next cycle)."""
    import numpy as np
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    params = ArmonParameters(test=test, N=N, data_type=dtype,
                             use_fast_math=fast, maxcycle=cycles, silent=5,
                             **_one_card(P), **route)
    cfg = params.config
    mesh = make_mesh(params)
    fs, seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg, mesh)(fs, 0.0, 0, 0.0, float(seed))
    T = np.dtype(dtype).type
    dt = min(T(cfg.cfl) * T(res.lm), T(1.05) * T(res.dt_last))
    return cfg, mesh, res, float(dt)


def _gate_mesh(torch, got, want, real, fast, what):
    """Per field, every shard's real cells: bit for bit in exact mode,
    within 1e-4 of the field's scale over the whole mesh in fast math.
    Returns the max abs difference."""
    err = 0.0
    for k in range(len(got[0])):
        scale = max(float(b[k][r].abs().max()) for b, r in zip(want, real))
        for a, b, r in zip(got, want, real):
            d = float((a[k][r] - b[k][r]).abs().max())
            err = max(err, d)
            ok = d <= 1e-4 * scale if fast else torch.equal(a[k][r], b[k][r])
            if not ok:
                raise AssertionError(f"{what}: field {k} max abs diff {d}")
    return err


def _cfl_gate(part, want, fast, what):
    got = float(part.max())
    if abs(got - float(want)) > (1e-4 * float(want) if fast else 0.0):
        raise AssertionError(f"{what}: CFL max {got} vs {float(want)}")


def _slab_sweep_checks(torch, cfg, mesh, cur, dt, fast, what, shards=None):
    """K1 with X slabs and K2 with Y slabs (the neighbours' real lines on
    the sides that face one, the mirror on global borders) on each of
    `shards` (every shard of `mesh` by default), against `sweep_plain`
    with the same ghosts: fields, p and the CFL partial maxima. `cur[s]`
    is shard s's (rho, u, v, E). Returns the max abs difference per axis
    name."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import real_slice
    from armon_torch.parallel.halo import halo_slabs
    from armon_torch.utils.enums import Axis
    err = {}
    for axis, sweep in ((Axis.X, K.x_sweep), (Axis.Y, K.y_sweep)):
        ghosts = halo_slabs(cfg, mesh, cur, axis)
        got, want, real = [], [], []
        for s in shards or mesh:
            src = cur[s.index]
            dev = src[0].device
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            nb = K.n_partials(axis, src[0].shape, dev)
            partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
            scal, iscal = K.new_scalars(cfg.dtype, dev)
            scal[K.SC_DTUSE] = dt
            iscal[K.IS_RUN] = 1
            sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True,
                  ghosts[s.index], s.n_real)
            ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0,
                                ghosts[s.index], s.n_real)
            mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5], s.n_real)
            torch.cuda.synchronize()
            _cfl_gate(partials[0], mx, fast, f"{what} {axis.name} {s}")
            _cfl_gate(partials[1], my, fast, f"{what} {axis.name} {s}")
            got.append(dst + (p,))
            want.append(ref[:5])
            real.append(real_slice(cfg, s.n_real))
        err[axis.name] = _gate_mesh(torch, got, want, real, fast,
                                    f"{what} {axis.name}")
    return err


def _slab_cycle_checks(torch, cfg, mesh, cur, dt, fast, what, shards=None,
                       factors=(0.5, 1.0)):
    """K4 with Y slabs and the X mirror after the splice, both sweep
    orders (`factors`: the dt factors of the first and the second sweep,
    Strang's by default), on each of `shards` (every shard by default)
    against `cycle_plain` with the same ghosts. Its first sweep runs on the
    ghost rows, so the corner cells (f_x times a neighbour's value) reach
    real cells here. Returns the max abs difference."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.ops.reductions import real_slice
    from armon_torch.parallel.halo import halo_slabs
    from armon_torch.utils.enums import Axis
    ghosts = halo_slabs(cfg, mesh, cur, Axis.Y)
    err = 0.0
    for x_first in (True, False):
        fx, fy = factors if x_first else factors[::-1]
        got, want, real = [], [], []
        for s in shards or mesh:
            src = cur[s.index]
            dev = src[0].device
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            nb = C.n_partials(src[0].shape, dev, cfg.dtype)
            partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
            scal, iscal = K.new_scalars(cfg.dtype, dev)
            scal[K.SC_DTUSE] = dt
            iscal[K.IS_RUN] = 1
            C.cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal,
                    True, ghosts[s.index], s.n_real)
            dt_t = scal[K.SC_DTUSE]
            ref = C.cycle_plain(cfg, x_first, *src, dt_t * fx, dt_t * fy,
                                ghosts[s.index], s.n_real)
            torch.cuda.synchronize()
            _cfl_gate(partials[0], ref[5], fast, f"{what} {s}")
            _cfl_gate(partials[1], ref[6], fast, f"{what} {s}")
            got.append(dst + (p,))
            want.append(ref[:5])
            real.append(real_slice(cfg, s.n_real))
        err = max(err, _gate_mesh(torch, got, want, real, fast,
                                  f"{what} x_first={x_first}"))
    return err


def _mesh_vs_single(torch, test, N, P, dtype, cycles, single, devices=None,
                    **route):
    """`armon()` on a mesh (one card unless `devices`) against the
    one-device run `single` (a SolverStats with data): dt, t, cycles and
    rho/u/v/E/p on real cells, bit for bit."""
    from armon_torch import ArmonParameters, armon
    place = _one_card(P) if devices is None else dict(P=P, devices=devices)
    stats = armon(ArmonParameters(
        test=test, N=N, data_type=dtype, use_fast_math=False,
        maxcycle=cycles, silent=5, return_data=True, **place, **route))
    same = (stats.cycles, stats.final_time, stats.last_dt) == \
        (single.cycles, single.final_time, single.last_dt)
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        a = getattr(stats.data, name)[g:-g, g:-g]
        b = getattr(single.data, name)[g:-g, g:-g].to(a.device)
        same = same and torch.equal(a, b)
    if not same:
        raise AssertionError(f"mesh {P} {test} {N} {dtype} {route} differs "
                             f"from one device: {stats.cycles} cycles, dt "
                             f"{stats.last_dt} vs {single.last_dt}")
    return {"test": test, "N": list(N), "P": list(P), "dtype": dtype,
            "cycles": stats.cycles, "dt": stats.last_dt, **route}


def _single(torch, test, N, dtype, cycles, **route):
    from armon_torch import ArmonParameters, armon
    return armon(ArmonParameters(test=test, N=N, data_type=dtype,
                                 use_fast_math=False, maxcycle=cycles,
                                 silent=5, return_data=True, device="cuda",
                                 **route))


def _mesh_tail(torch, cfg, mesh, res, kind, dt):
    """`_tail_check` of one `kind` launch a shard over a one-card mesh's
    state `res` (slab ghosts along the launch's axis), the last shard's
    launch carrying the tail. Returns the partials it folds."""
    import dataclasses
    from armon_torch.parallel.halo import halo_slabs
    from armon_torch.utils.enums import Axis
    cfg = dataclasses.replace(cfg, maxcycle=1 << 23, maxtime=1e30)
    cur = [tuple(c[:4]) for c in res.carry]
    ghosts = halo_slabs(cfg, mesh, cur, Axis.X if kind == "x_sweep" else Axis.Y)
    launches = [_launcher(kind, cfg, cur[s.index], ghosts=ghosts[s.index],
                          n_real=s.n_real) for s in mesh]
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    return _tail_check(torch, cfg, launches, cur, sc,
                       f"{kind} tail over {len(mesh)} shards")


def _slab_pack_count(mesh, axis):
    """Slab buffers refilled per sweep along `axis` (one per side that
    faces a neighbour)."""
    return sum(mesh.neighbour(s, axis, side) is not None
               for s in mesh for side in (0, 1))


def phase7(torch, rates):
    """Domain-decomposed runs on one card (see the module doc); returns
    the kernels-line entries of the three slab variants."""
    from armon_torch.core.state import FusedCarry
    from armon_torch.core.solver import make_mesh
    from armon_torch.interop import scatter_state
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.ops.routing import route as route_of
    from armon_torch.parallel.halo import halo_slabs, new_slab_buffers
    from armon_torch.utils.enums import Axis
    out = {"phase": 7, "card": card_line()}
    modes = (("float64", False), ("float32", False), ("float32", True))

    # (1) the slab variants against their plain versions, 1024^2 shards
    checks = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in modes:
            n = 3 * CHECK_SHARD
            cfg, mesh, res, dt = _mesh_mid_state(torch, test, (n, n),
                                                 (3, 3), dtype, fast)
            e1 = _slab_sweep_checks(torch, cfg, mesh,
                                    [tuple(c[:4]) for c in res.carry], dt,
                                    fast, f"K1/K2 slab {test} {dtype} fast={fast}")
            cfg, mesh, res, dt = _mesh_mid_state(torch, test, (CHECK_SHARD, n),
                                                 (1, 3), dtype, fast,
                                                 temporal_blocking=1)
            if route_of(cfg) != "pair":
                raise AssertionError("the 1x3 mesh left the pair route")
            e4 = _slab_cycle_checks(torch, cfg, mesh,
                                    [tuple(c[:4]) for c in res.carry], dt,
                                    fast, f"K4 slab {test} {dtype} fast={fast}")
            checks.append({"test": test, "dtype": dtype, "fast": fast,
                           "sweeps_max_abs_err": e1, "cycle_max_abs_err": e4})
    out["slab_vs_plain"] = checks

    # K3's tail on one-card meshes: the last shard's launch folds every
    # shard's partials (K1 / K2 slab launches on 2x2, K4 on 1x2).
    tails = []
    for dtype in ("float64", "float32"):
        for P, kind, route in (((2, 2), "x_sweep", {}), ((2, 2), "y_sweep", {}),
                               ((1, 2), "cycle", dict(temporal_blocking=1))):
            n = 2 * CHECK_SHARD
            N = (n if P[0] > 1 else CHECK_SHARD, n)
            cfg, mesh, res, dt = _mesh_mid_state(torch, "Sod_circ", N, P, dtype,
                                                 False, **route)
            tails.append({"P": list(P), "kernel": kind, "dtype": dtype,
                          "blocks": _mesh_tail(torch, cfg, mesh, res, kind, dt)})
    out["tail_on_meshes"] = tails
    emit(out)

    # (2) meshes against the one-device run, bit for bit, exact mode
    agree = []
    for dtype in ("float64", "float32"):
        n = AGREE_N
        for N, meshes in (((n, n), ((2, 2), (1, 2), (2, 1), (4, 1), (3, 2))),
                          ((n, n - 1), ((3, 2),))):
            single = _single(torch, "Sod_circ", N, dtype, AGREE_CYCLES)
            for P in meshes:
                agree.append(_mesh_vs_single(torch, "Sod_circ", N, P, dtype,
                                             AGREE_CYCLES, single))
        N = (SEDOV_N, SEDOV_N)
        single = _single(torch, "Sedov", N, dtype, SEDOV_AGREE_CYCLES)
        agree.append(_mesh_vs_single(torch, "Sedov", N, SEDOV_P, dtype,
                                     SEDOV_AGREE_CYCLES, single))
    out = {"phase": 7, "mesh_vs_single": agree}

    # (3) the goldens through a 2x2 mesh
    out["goldens_2x2"] = _goldens(torch, _one_card((2, 2)))
    emit(out)

    # (4) timed runs. On each one's final state, at the timed shapes, every
    # slab kernel against its plain version on the first shard (slabs on
    # its high sides) and the last (slabs on its low sides): bit for bit in
    # f32 exact and f64 (those max abs differences go to the kernels line),
    # within the fast-math gate as timed. These launches, and the timing
    # ones, are not counted as the path's.
    sod, params, stats = _timed(torch, "Sod", MESH_N, MESH_CYCLES,
                                **_one_card(MESH_P))
    for name in ("x_sweep_slab", "y_sweep_slab", "cfl_finish", "cfl_tail"):
        if not {**sod["launches"], **sod["tails"]}[name]:
            raise AssertionError(f"the 2x2 mesh never launched {name}")
    ln = sod["launches"]
    if not (ln["cfl_finish"] == 1 and 4 * sod["tails"]["cfl_tail"] == ln["y_sweep_slab"]):
        raise AssertionError(f"the 2x2 mesh's sequencing: {ln} {sod['tails']}")
    cfg = params.config
    mesh = make_mesh(params)
    st = stats.data
    cur = [tuple(c[:4]) for c in
           scatter_state(params, FusedCarry(st.rho, st.u, st.v, st.E, st.p))]
    last_dt = stats.last_dt
    del st, stats
    ends = (mesh.shards[0], mesh.shards[-1])
    s0 = mesh.shards[0]  # a slab on its high sides, the mirror on its low ones
    src = cur[0]
    shape, dev = src[0].shape, src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nbx, nby = K.n_partials(Axis.X, shape, dev), K.n_partials(Axis.Y, shape, dev)
    partials = torch.zeros((2, len(mesh) * max(nbx, nby)), dtype=src[0].dtype,
                           device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = last_dt
    iscal[K.IS_RUN] = 1
    bufs = {a: new_slab_buffers(cfg, mesh, cur, a) for a in (Axis.X, Axis.Y)}
    gx = halo_slabs(cfg, mesh, cur, Axis.X, bufs[Axis.X])[0]
    gy = halo_slabs(cfg, mesh, cur, Axis.Y, bufs[Axis.Y])[0]
    saved = saved_counts(K)
    ms = {
        "x_sweep_slab": time_ms(lambda i: K.x_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, False, gx, s0.n_real),
            k=20),
        "y_sweep_slab": time_ms(lambda i: K.y_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, True, gy, s0.n_real),
            k=20)}
    s2, i2 = scal.clone(), iscal.clone()

    def reset():  # every call folds: from the same scalars
        s2.copy_(scal)
        i2.copy_(iscal)
    ms["cfl_finish_4_shards"] = time_ms(lambda i: K.cfl_finish(
        cfg, partials, len(mesh) * nby, s2, i2), k=50, reset=reset)
    ms["slab_copies_per_cycle"] = time_ms(lambda i: (
        halo_slabs(cfg, mesh, cur, Axis.X, bufs[Axis.X]),
        halo_slabs(cfg, mesh, cur, Axis.Y, bufs[Axis.Y])), k=20)
    dt_t = scal[K.SC_DTUSE] * 1.0
    plain = {"x_sweep_slab": time_ms(lambda i: K.sweep_plain(
                 cfg, Axis.X, *src, dt_t, gx, s0.n_real), k=3),
             "y_sweep_slab": time_ms(lambda i: K.sweep_plain(
                 cfg, Axis.Y, *src, dt_t, gy, s0.n_real), k=3)}
    del dst, p, partials, bufs, gx, gy
    sweep_err = {"X": 0.0, "Y": 0.0}
    for dtype, ecfg in _exact_cfgs("Sod", (MESH_N, MESH_N), **_one_card(MESH_P)):
        tdt = getattr(torch, dtype)
        e = _slab_sweep_checks(
            torch, ecfg, mesh, [tuple(a.to(tdt) for a in c) for c in cur],
            last_dt, False, f"K1/K2 slab at Sod {MESH_N}^2 {dtype} exact", ends)
        sweep_err = {k: max(sweep_err[k], e[k]) for k in e}
    sod["slab_vs_plain"] = {
        "shards": [s.index for s in ends], "exact_max_abs_err": sweep_err,
        "fast_math_max_abs_err": _slab_sweep_checks(
            torch, cfg, mesh, cur, last_dt, True,
            f"K1/K2 slab at Sod {MESH_N}^2 fast math", ends)}
    restore_counts(K, saved)
    sod["kernel_ms_per_shard"] = ms
    rates["mesh_slab_copies_ms"] = ms["slab_copies_per_cycle"]
    rates["mesh_cycle_ms"] = sod["cycle_ms"]
    rates["mesh_memory"] = {"peak": sod["max_memory_allocated"],
                            "before": sod["memory_allocated_before"]}
    sod["slab_packs_per_cycle"] = sum(_slab_pack_count(mesh, a)
                                      for a in (Axis.X, Axis.Y))
    sod["single_device_8192_cells_per_s"] = rates.get("main", {}).get("cells_per_s")
    fb = src[0].numel() * src[0].element_size()
    rows, cols = shape
    g = cfg.nghost
    isz = src[0].element_size()
    ops = SWEEP_OPS_PER_CELL * src[0].numel()
    kernels = []
    for name, replaces, nbytes, err in (
            ("x_sweep_slab", "armon_tpu/ops/pallas/sweep.py:1008", 8 * fb
             + 4 * rows * g * isz, sweep_err["X"]),
            ("y_sweep_slab", "armon_tpu/ops/pallas/sweep.py:1118", 9 * fb
             + 4 * g * cols * isz + 2 * nby * isz, sweep_err["Y"])):
        b_ms, b_by = bound_f32(nbytes, ops)
        kernels.append({"name": name, "route": "cuda",
                        "source": "armon_torch/csrc/sweep.cuh",
                        "replaces": replaces, "launches": sod["launches"][name],
                        "max_abs_err": err, "ms": ms[name],
                        "plain_ms": plain[name], "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    del cur, src
    emit({"phase": 7, "timed_main_mesh": sod})

    sedov, params, stats = _timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES,
                                  **_one_card(SEDOV_P))
    ln = sedov["launches"]
    if sedov["route"] != "pair" or not ln["cycle_slab"] or not (
            ln["cfl_finish"] == 1 and 2 * sedov["tails"]["cfl_tail"] == ln["cycle_slab"]):
        raise AssertionError(f"Sedov over {SEDOV_P}: {ln} {sedov['tails']}")
    cfg = params.config
    mesh = make_mesh(params)
    st = stats.data
    cur = [tuple(c[:4]) for c in
           scatter_state(params, FusedCarry(st.rho, st.u, st.v, st.E, st.p))]
    src = cur[0]
    dev = src[0].device
    ghosts = halo_slabs(cfg, mesh, cur, Axis.Y)[0]
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, dev, cfg.dtype)
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = stats.last_dt
    iscal[K.IS_RUN] = 1
    saved = saved_counts(K)
    k4_ms = time_ms(lambda i: C.cycle(cfg, True, 1.0, 1.0, src, dst, p,
                                           partials, scal, iscal, True,
                                           ghosts, mesh.shards[0].n_real),
                    k=20)
    dt_t = scal[K.SC_DTUSE]
    k4p_ms = time_ms(lambda i: C.cycle_plain(cfg, True, *src, dt_t, dt_t,
                                                  ghosts, mesh.shards[0].n_real),
                     k=3)
    ends = (mesh.shards[0], mesh.shards[-1])  # Y slabs above, below
    cycle_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N), **_one_card(SEDOV_P)):
        tdt = getattr(torch, dtype)
        cycle_err = max(cycle_err, _slab_cycle_checks(
            torch, ecfg, mesh, [tuple(a.to(tdt) for a in c) for c in cur],
            stats.last_dt, False, f"K4 slab at Sedov {SEDOV_N}^2 {dtype} exact",
            ends, factors=(1.0, 1.0)))
    sedov["slab_vs_plain"] = {
        "shards": [s.index for s in ends], "exact_max_abs_err": cycle_err,
        "fast_math_max_abs_err": _slab_cycle_checks(
            torch, cfg, mesh, cur, stats.last_dt, True,
            f"K4 slab at Sedov {SEDOV_N}^2 fast math", ends, factors=(1.0, 1.0))}
    restore_counts(K, saved)
    sedov["kernel_ms_per_shard"] = {"cycle_slab": k4_ms}
    sedov["slab_packs_per_cycle"] = _slab_pack_count(mesh, Axis.Y)
    sedov["single_device"] = rates.get("small")
    emit({"phase": 7, "timed_sedov_mesh": sedov})
    fb = src[0].numel() * src[0].element_size()
    b_ms, b_by = bound_f32(9 * fb + 4 * cfg.nghost * src[0].shape[1]
                          * src[0].element_size() + 2 * nb * src[0].element_size(),
                          2 * SWEEP_OPS_PER_CELL * src[0].numel())
    kernels.append({"name": "cycle_slab", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1592",
                    "launches": sedov["launches"]["cycle_slab"],
                    "max_abs_err": cycle_err, "ms": k4_ms, "plain_ms": k4p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "corner_cells_checked": "both shards of the timed 1x2 "
                                            "mesh and a 1x3 mesh of 1024^2 "
                                            "shards: Y slabs, X mirror after "
                                            "the splice, both sweep orders"})

    # (5) four cards, where the machine has them
    if torch.cuda.device_count() >= 4:
        four = []
        N = (AGREE_N, AGREE_N)
        for dtype in ("float64", "float32"):
            single = _single(torch, "Sod_circ", N, dtype, AGREE_CYCLES)
            four.append(_mesh_vs_single(
                torch, "Sod_circ", N, (2, 2), dtype, AGREE_CYCLES, single,
                devices=[f"cuda:{i}" for i in range(4)]))
        emit({"phase": 7, "four_cards": four})
    else:
        emit({"phase": 7, "four_cards": "not run: the machine has "
                                        f"{torch.cuda.device_count()} card(s)"})
    return kernels


# --------------------------------------------------------------- probes

def phase8(torch):
    """The probes (see the module doc); returns their kernels-line
    entries. Each probe's counts are set to 0 just before its entry point
    runs and read just after; its checks against the plain versions do
    not count."""
    from armon_torch import probes
    from armon_torch.probes import (flip, ff, roofline_io, roofline, cycle_variants,
                                    cluster)
    kernels, launches = [], {}
    for mod in (flip, ff, roofline_io, roofline, cycle_variants, cluster):
        probes.reset_launches()
        res = mod.run("cuda")
        torch.cuda.synchronize()
        counted = dict(probes.LAUNCHES)
        errs = mod.check("cuda")
        probes.reset_launches()
        probes.LAUNCHES.update(counted)
        entries = mod.entries(res, errs)
        for e in entries:
            if not e["launches"]:
                raise AssertionError(f"probe {mod.__name__} never launched {e['name']}")
        kernels += entries
        launches.update(counted)
    emit({"phase": 8, "card": card_line(), "launches": launches,
          "max_abs_err": {e["name"]: e["max_abs_err"] for e in kernels}})
    return kernels


# ---------------------------------------------------------------- op path

OP_CYCLES = 20
OP_F64_N, OP_F64_CYCLES = 1024, 3


def _op_vs_kernels(torch, test, n, dtype, cycles, timed=False):
    """`armon()` on the op path and on the per-sweep kernels in exact mode
    (`use_fast_math=False`) from the same initial state over the same
    cycles: the op path's stats, params and the largest difference per
    field (max abs, norm-relative, ulps) on the real cells; with `timed`,
    its peak memory and its launches of the hand-written kernels (none
    may happen)."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    opts = dict(test=test, N=(n, n), data_type=dtype, scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod", nghost=4,
                axis_splitting="Sequential", maxcycle=cycles, maxtime=1e30,
                silent=5, return_data=True, device="cuda")
    out = {}
    if timed:
        armon(ArmonParameters(kernel_tier="torch", **dict(opts, maxcycle=2)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["memory_allocated_before"] = torch.cuda.memory_allocated()
        K.reset_launches()
    params = ArmonParameters(kernel_tier="torch", **opts)
    op = armon(params)
    torch.cuda.synchronize()
    if timed:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["kernel_launches"] = sum(K.LAUNCHES.values()) + sum(K.TAILS.values())
        if out["kernel_launches"]:
            raise AssertionError(f"the op path launched kernels: {K.LAUNCHES}")
    ref = armon(ArmonParameters(use_fast_math=False, **PER_SWEEP, **opts))
    if op.cycles != cycles or ref.cycles != cycles:
        raise AssertionError(f"op path {test} {n}^2: {op.cycles} / "
                             f"{ref.cycles} cycles of {cycles}")
    out["diff"] = {v: compare(torch, getattr(op.data, v), getattr(ref.data, v),
                              params.nghost)
                   for v in ("rho", "u", "v", "E", "p")}
    out["t_diff"] = op.final_time - ref.final_time
    out["dt_diff"] = op.last_dt - ref.last_dt
    return op, params, ref, out


def _launches_per_cycle(torch, n):
    """What a cycle of the op path at Sod n^2 f32 launches: the CUDA
    kernels `torch.profiler` sees (None where it sees no device event),
    their device ms and the eight costliest kinds, each as the difference
    between runs of one and two stop-check batches over the cycles
    between them (a batch computes all its cycles)."""
    from torch.profiler import profile, ProfilerActivity
    from armon_torch import ArmonParameters, armon
    from armon_torch.core.step import STOP_CHECK_EVERY

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    runs = []
    for c in (STOP_CHECK_EVERY, 2 * STOP_CHECK_EVERY):
        params = ArmonParameters(test="Sod", N=(n, n), data_type="float32",
                                 maxcycle=c, maxtime=1e30, silent=5,
                                 kernel_tier="torch", device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            armon(params)
            torch.cuda.synchronize()
        runs.append({e.key: (e.count, device_us(e))
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("Memcpy", "Memset"))})
    k1, k2 = runs
    per = {}  # by `_kernel_label`: [launches, ms] a cycle
    for key, (c, us) in k2.items():
        c0, us0 = k1.get(key, (0, 0))
        row = per.setdefault(_kernel_label(key), [0.0, 0.0])
        row[0] += (c - c0) / STOP_CHECK_EVERY
        row[1] += (us - us0) / STOP_CHECK_EVERY / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    return {"cuda_kernels_per_cycle":
            sum(c for c, _ in per.values()) if k2 else None,
            "device_ms_per_cycle": sum(ms for _, ms in per.values()),
            "top_kernels_per_cycle": {k: {"launches": c, "ms": ms}
                                      for k, (c, ms) in top}}


_LAUNCHERS = ("vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
              "elementwise_kernel", "gpu_kernel_impl", "gpu_kernel_impl_nocast",
              "reduce_kernel")


def _kernel_label(key):
    """A short name for a PyTorch CUDA kernel: the last functor, kernel or
    implementation named in its signature that is not a generic launcher."""
    import re
    names = [m for m in re.findall(r"[A-Za-z_]\w*", key)
             if m.endswith(("Functor", "kernel", "_impl", "_cuda"))
             or "Functor_" in m]
    names = [m for m in names if m not in _LAUNCHERS]
    return names[-1] if names else key[:60]


def phase9(torch):
    """The op path (``kernel_tier="torch"``, plain PyTorch ops) on the
    card: (a) the goldens, (b) the main path's configuration, timed and
    held against the per-sweep kernels in exact mode, (c) f64 Sod_circ
    against the kernels within `tests/test_fuzz.py:87`'s tolerance."""
    import numpy as np
    from armon_torch.ops import sweep as K
    from armon_torch.core.step import STOP_CHECK_EVERY
    saved = saved_counts(K)
    golden = _goldens(torch, dict(kernel_tier="torch"), GOLDEN_MODES[:2])
    emit({"phase": 9, "goldens": golden})

    op, params, _, main = _op_vs_kernels(torch, "Sod", MAIN_N, "float32",
                                         OP_CYCLES, timed=True)
    if not np.isfinite(float(op.data.rho.sum())):
        raise AssertionError("op path main configuration: not finite")
    _gate(main["diff"], "float32", False)  # exact mode: within 4 ulp
    cells = MAIN_N * MAIN_N
    computed = -(-op.cycles // STOP_CHECK_EVERY) * STOP_CHECK_EVERY
    main.update({"phase": 9, "card": card_line(), "N": MAIN_N,
                 "cycles": op.cycles, "cycles_computed": computed,
                 "solve_s": op.solve_time,
                 "cells_per_s": cells * op.cycles / op.solve_time,
                 "grind_ns": op.solve_time / op.cycles / cells * 1e9,
                 "cycle_ms": op.solve_time / op.cycles * 1e3,
                 "computed_cycle_ms": op.solve_time / computed * 1e3,
                 "host_reads": op.host_reads},
                **_launches_per_cycle(torch, MAIN_N))
    main["device_busy_share"] = main["device_ms_per_cycle"] \
        / main["computed_cycle_ms"]
    emit(main)
    del op, params

    op, params, ref, f64 = _op_vs_kernels(torch, "Sod_circ", OP_F64_N,
                                          "float64", OP_F64_CYCLES)
    g = params.nghost
    for v in f64["diff"]:
        a = getattr(op.data, v)[g:-g, g:-g]
        if not torch.allclose(a, getattr(ref.data, v)[g:-g, g:-g],
                              rtol=1e-12, atol=1e-14):
            raise AssertionError(f"op path f64 Sod_circ {v}: {f64['diff']}")
    emit({"phase": 9, "f64_sod_circ": f64, "N": OP_F64_N,
          "cycles": OP_F64_CYCLES})
    restore_counts(K, saved)
    return {"peak": main["max_memory_allocated"],
            "before": main["memory_allocated_before"]}


# ------------------------------------------------- drivers, I/O, restart

RESTART_CYCLES = 16        # the 8192^2 restart: snapshot at 8, resume to 16
SEDOV_CUT = 500            # Sedov 2000^2: resume at cycle 500 of 1000
K5_CYCLES, K5_EVEN, K5_ODD = 40, 16, 17
CPU_N, CPU_CYCLES = 200, 20
# Phase 10's meshes (not phase 7's MESH_N: each phase keeps its own names).
P10_MESH_N, P10_MESH_CYCLES = 1000, 20


class _Counted:
    """Launch counts of the paths phase 10 drives: each path runs with the
    counts set to 0 just before it, and is read just after; each path's
    counts go into phase 10's lines, and their sums into the `kernels`
    line's `launches_phase10` (never into `launches`). Runs outside `path` (the
    uninterrupted references) leave the counts as they were."""

    def __init__(self, torch):
        from armon_torch.ops import sweep as K
        self.torch, self.K = torch, K
        self.total = {}

    def path(self, what, fn, expect):
        K = self.K
        saved = saved_counts(K)
        K.reset_launches()
        out = fn()
        self.torch.cuda.synchronize()
        counts = {**K.LAUNCHES, **K.TAILS}
        restore_counts(K, saved)
        missing = [k for k in expect if not counts[k]]
        if missing:
            raise AssertionError(f"{what}: never launched {missing}: {counts}")
        for k, n in counts.items():
            self.total[k] = self.total.get(k, 0) + n
        return out, {k: n for k, n in counts.items() if n}

    def quiet(self, fn):
        saved = saved_counts(self.K)
        out = fn()
        self.torch.cuda.synchronize()
        restore_counts(self.K, saved)
        return out


def _same_run(torch, a, b, what, real=False, report=False,
              fields=("rho", "u", "v", "E", "p")):
    """Bit for bit: cycles, t, dt and `fields` (on the real cells with
    `real`: a mesh's gathered ghosts are not the one-device run's). With
    `report`, the differences are returned, not raised: {"scalars_equal",
    "max_abs_diff"}."""
    sa = (a.cycles, a.final_time, a.last_dt)
    sb = (b.cycles, b.final_time, b.last_dt)
    r = (slice(4, -4), slice(4, -4)) if real else (slice(None),) * 2
    err = 0.0
    for f in fields:
        x = getattr(a.data, f)[r]
        y = getattr(b.data, f)[r].to(x.device)
        if not torch.equal(x, y):
            err = max(err, float((x - y).abs().max()))
    if report:
        return {"scalars_equal": sa == sb, "max_abs_diff": err}
    if sa != sb or err:
        raise AssertionError(f"{what}: {sa} vs {sb}, fields differ by {err}")
    return None


def _p10_restart_main(torch, tmp, cnt):
    """The 8192^2 restart through the main path's configuration."""
    import shutil
    from armon_torch import ArmonParameters, armon
    from armon_torch.io import restart
    opts = dict(test="Sod", N=(MAIN_N, MAIN_N), data_type="float32",
                scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
                nghost=4, axis_splitting="Sequential", use_fast_math=True,
                device="cuda", return_data=True, output_dir=tmp,
                output_file="main")
    cnt.quiet(lambda: armon(ArmonParameters(maxcycle=2, silent=5, **opts)))
    lean = cnt.quiet(lambda: armon(ArmonParameters(
        maxcycle=RESTART_CYCLES, silent=5, **opts)))
    saves = []
    real_save = restart.save_checkpoint

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        real_save(*a, **k)
        saves.append(time.perf_counter() - t0)
    free = shutil.disk_usage(tmp).free
    print(f"chip_smoke: {free / 1e9:.2f} GB free in {tmp} before the "
          f"{MAIN_N}^2 snapshot", file=sys.stderr)
    restart.save_checkpoint = timed_save
    try:
        half = RESTART_CYCLES // 2
        _, c_save = cnt.path("8192^2 per-cycle run with checkpoint_step",
                             lambda: armon(ArmonParameters(
                                 maxcycle=half, silent=2, checkpoint_step=half,
                                 **opts)),
                             ("x_sweep", "y_sweep", "cfl_finish", "cfl_tail"))
    finally:
        restart.save_checkpoint = real_save
    ckpt = os.path.join(tmp, "main.ckpt.npz")
    size = os.path.getsize(ckpt)
    rp = ArmonParameters(maxcycle=RESTART_CYCLES, silent=5, **opts)
    resumed, c_res = cnt.path("8192^2 lean resume",
                              lambda: armon(rp, restore_from=ckpt),
                              ("x_sweep", "y_sweep", "cfl_finish", "cfl_tail"))
    _same_run(torch, lean, resumed, "8192^2 resume vs uninterrupted")
    load_s = resumed.timer["init"]["seconds"]
    os.remove(ckpt)
    del resumed
    per, c_per = cnt.path("8192^2 per-cycle run",
                          lambda: armon(ArmonParameters(
                              maxcycle=RESTART_CYCLES, silent=2,
                              checkpoint_step=10 * RESTART_CYCLES, **opts)),
                          ("x_sweep", "y_sweep", "cfl_finish", "cfl_tail"))
    _same_run(torch, lean, per, "8192^2 per-cycle vs lean")
    cells = MAIN_N * MAIN_N
    out = {"N": MAIN_N, "cycles": RESTART_CYCLES, "snapshot_bytes": size,
           "disk_free_bytes_before": free, "save_s": saves,
           "load_s": load_s, "resume_bitwise": True,
           "per_cycle_bitwise": True,
           "lean_cells_per_s": cells * lean.cycles / lean.solve_time,
           "lean_cycle_ms": lean.solve_time / lean.cycles * 1e3,
           "lean_host_reads_per_cycle": lean.host_reads / lean.cycles,
           "per_cycle_cells_per_s": cells * per.cycles / per.solve_time,
           "per_cycle_cycle_ms": per.solve_time / per.cycles * 1e3,
           "per_cycle_host_reads_per_cycle": per.host_reads / per.cycles,
           "launches": {"per_cycle_with_save": c_save, "resume": c_res,
                        "per_cycle": c_per}}
    del lean, per
    torch.cuda.empty_cache()
    return out


def _cut_and_resume(torch, cnt, what, opts, total, cut, expect, tmp,
                    report=False):
    """A lean run to `cut` cycles, saved through the params that ran it,
    resumed to `total`; against the uninterrupted run, bit for bit unless
    `report`. Returns (launch counts of the resume, the differences with
    `report`)."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.io import restart
    full = cnt.quiet(lambda: armon(ArmonParameters(maxcycle=total, **opts)))
    p1 = ArmonParameters(maxcycle=cut, **opts)
    s1 = cnt.quiet(lambda: armon(p1))
    ckpt = os.path.join(tmp, "cut.npz")
    restart.save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                            s1.last_dt)
    s2, c = cnt.path(what, lambda: armon(ArmonParameters(maxcycle=total, **opts),
                                         restore_from=ckpt), expect)
    return c, _same_run(torch, full, s2, what, report=report)


def _p10_routes(torch, tmp, cnt):
    """Sedov 2000^2 (pair, K4) through the per-cycle driver's snapshot;
    Sod 100^2 (K5) at an even and an odd cycle; a CPU snapshot on the
    card."""
    from armon_torch import ArmonParameters, armon
    out = {}
    sedov = dict(SMALL_OPTS, test="Sedov", N=(SEDOV_N, SEDOV_N),
                 return_data=True, output_dir=tmp, output_file="sedov")
    full = cnt.quiet(lambda: armon(ArmonParameters(maxcycle=SEDOV_CYCLES,
                                                   **sedov)))
    _, c_cut = cnt.path("Sedov per-cycle run", lambda: armon(ArmonParameters(
        maxcycle=SEDOV_CUT, checkpoint_step=SEDOV_CUT, **dict(sedov, silent=2))),
        ("cycle", "cfl_finish", "cfl_tail"))
    res, c_res = cnt.path("Sedov resume", lambda: armon(
        ArmonParameters(maxcycle=SEDOV_CYCLES, **sedov),
        restore_from=os.path.join(tmp, "sedov.ckpt.npz")),
        ("cycle", "cfl_finish", "cfl_tail"))
    _same_run(torch, full, res, "Sedov 2000^2 resume at 500")
    out["sedov_pair"] = {"N": SEDOV_N, "cut": SEDOV_CUT, "cycles": SEDOV_CYCLES,
                         "bitwise": True, "launches": {"per_cycle": c_cut,
                                                       "resume": c_res}}
    del full, res

    sod = []
    modes = (("float32", False), ("float64", False), ("float32", True))
    for dtype, fast in modes:
        opts = dict(SMALL_OPTS, test="Sod", N=(SOD_N, SOD_N), data_type=dtype,
                    use_fast_math=fast, return_data=True)
        c_even, even_diff = _cut_and_resume(torch, cnt, f"Sod 100^2 {dtype} fast={fast}"
                                    f" even resume", opts, K5_CYCLES, K5_EVEN,
                                    ("multicycle",), tmp, report=fast)
        c_odd, diff = _cut_and_resume(torch, cnt, f"Sod 100^2 {dtype} fast={fast}"
                                     f" odd resume", opts, K5_CYCLES, K5_ODD,
                                     ("cycle", "cfl_finish", "cfl_tail"), tmp,
                                     report=fast)
        if even_diff and (not even_diff["scalars_equal"]
                          or even_diff["max_abs_diff"]):
            raise AssertionError(f"K5 even resume in fast math: {even_diff}")
        sod.append({"dtype": dtype, "fast": fast, "even": K5_EVEN,
                    "odd": K5_ODD, "cycles": K5_CYCLES,
                    "odd_vs_uninterrupted": diff or "bit for bit",
                    "launches": {"even": c_even,
                                                          "odd": c_odd}})
    out["sod_multicycle"] = sod

    # A snapshot the port writes on the CPU, resumed on the card.
    cpu = dict(test="Sod_circ", N=(CPU_N, CPU_N), data_type="float64",
               silent=5, return_data=True, maxtime=1e30)
    full = armon(ArmonParameters(maxcycle=CPU_CYCLES, device="cpu", **cpu))
    armon(ArmonParameters(maxcycle=CPU_CYCLES // 2, device="cpu",
                          checkpoint_step=CPU_CYCLES // 2, output_dir=tmp,
                          output_file="cpu", **cpu))
    res, c = cnt.path("CPU snapshot resumed on the card", lambda: armon(
        ArmonParameters(maxcycle=CPU_CYCLES, device="cuda", **cpu),
        restore_from=os.path.join(tmp, "cpu.ckpt.npz")),
        ("cycle", "cfl_finish", "cfl_tail"))
    _same_run(torch, full, res, "CPU snapshot resumed on the card")
    out["cpu_to_card"] = {"N": CPU_N, "cycles": CPU_CYCLES, "bitwise": True,
                          "launches": c}
    return out


def _p10_files(torch, tmp, cnt):
    """Goldens through written files, card files against CPU files, and a
    1024^2 write."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.io import output
    from armon_torch.interop import to_numpy
    rows = []
    for test in ("Sod", "Sod_y", "Sod_circ"):
        for dtype in ("float64", "float32"):
            bits = 64 if dtype == "float64" else 32
            opts = dict(test=test, N=(100, 100), data_type=dtype,
                        use_fast_math=False, maxcycle=1000, silent=5,
                        write_output=True)
            cnt.quiet(lambda: armon(ArmonParameters(
                device="cuda", output_dir=tmp, output_file="card", **opts)))
            armon(ArmonParameters(device="cpu", output_dir=tmp,
                                  output_file="cpu", **opts))
            cfg = ArmonParameters(device="cpu", **opts).config
            ours = output.read_state_file(cfg, os.path.join(tmp, "card"))
            _, cyc, ref = output.read_reference_csv(
                cfg, os.path.join(REF_DIR, f"ref_{test}_{bits}bits.csv"))
            atol = 1e-13 if bits == 64 else 1e-5
            rtol = 4 * np.finfo(np.float64).eps if bits == 64 \
                else 20 * np.finfo(np.float32).eps
            diffs, _, _ = output.count_differences(cfg, ours, ref, atol, rtol)
            with open(os.path.join(tmp, "card"), "rb") as a, \
                    open(os.path.join(tmp, "cpu"), "rb") as b:
                same = a.read() == b.read()
            rows.append({"test": test, "dtype": dtype, "golden_diffs": diffs,
                         "card_file_equals_cpu_file": same})
            if diffs or not same:
                raise AssertionError(f"written golden {test} {dtype}: {rows[-1]}")

    opts = dict(test="Sod", N=(1024, 1024), data_type="float32",
                use_fast_math=True, maxcycle=20, silent=5, device="cuda",
                write_output=True, write_slices=True, return_data=True,
                output_dir=tmp, output_file="big")
    t0 = time.perf_counter()
    stats = cnt.quiet(lambda: armon(ArmonParameters(**opts)))
    total_s = time.perf_counter() - t0
    params = ArmonParameters(**opts)
    path = os.path.join(tmp, "big")
    t0 = time.perf_counter()
    back = output.read_state_file(params.config, path)
    read_s = time.perf_counter() - t0
    st = to_numpy(stats.data)
    g = params.nghost
    for v, a in back.items():
        if not np.array_equal(a, getattr(st, v)[g:-g, g:-g]):
            raise AssertionError(f"1024^2 file read back: {v} differs")
    t0 = time.perf_counter()
    output.write_state_file(params.config, stats.data, path + ".again")
    write_s = time.perf_counter() - t0
    sizes = {name: os.path.getsize(os.path.join(tmp, name))
             for name in ("big", "big_X_slice", "big_Y_slice", "big_D_slice")}
    return {"goldens": rows,
            "big": {"N": 1024, "run_and_write_s": total_s,
                    "solve_s": stats.solve_time, "write_s": write_s,
                    "read_s": read_s, "bytes": sizes,
                    "read_back_equals_state": True}}


def _p10_compare(torch, tmp):
    """Step files written by the port on the CPU, compared on the card
    (the op path's sub-steps)."""
    import contextlib
    import io
    from armon_torch import ArmonParameters, armon
    opts = dict(test="Sod", N=(100, 100), data_type="float64", maxcycle=2,
                silent=5, compare=True, output_dir=tmp, output_file="cmp")
    armon(ArmonParameters(device="cpu", is_ref=True, **opts))
    files = len(os.listdir(tmp))
    out = {}
    for name, extra in (("clean", {}), ("cfl_0.5", dict(cfl=0.5))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = armon(ArmonParameters(device="cuda", **opts, **extra))
        text = buf.getvalue()
        out[name] = {"cycles": stats.cycles,
                     "differences_reported": "difference" in text}
    if out["clean"] != {"cycles": 2, "differences_reported": False}:
        raise AssertionError(f"compare mode on the card: {out}")
    if out["cfl_0.5"]["cycles"] != 0:
        raise AssertionError(f"compare mode, cfl=0.5: {out}")
    out["step_files"] = files
    return out


def _p10_meshes(torch, tmp, cnt):
    """Sod_circ 1000^2 over 2x2 on cuda:0 with `use_MPI`: per-shard files
    against the one-device file's windows, and per-shard snapshots resumed
    on 2x2, 1x1 and 3x2."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.io import output, subdomain
    out = []
    for dtype in ("float64", "float32"):
        opts = dict(test="Sod_circ", N=(P10_MESH_N, P10_MESH_N), data_type=dtype,
                    use_fast_math=False, silent=5, return_data=True,
                    output_dir=tmp, maxtime=1e30)
        files = dtype == "float64"
        one = cnt.quiet(lambda: armon(ArmonParameters(
            maxcycle=P10_MESH_CYCLES, device="cuda", write_output=files,
            output_file="one", **opts)))
        half = P10_MESH_CYCLES // 2
        _, c_cut = cnt.path(f"2x2 per-cycle run {dtype}", lambda: armon(
            ArmonParameters(maxcycle=half, checkpoint_step=half, use_MPI=True,
                            output_file="mesh", **_one_card((2, 2)),
                            **dict(opts, silent=2))),
            ("x_sweep_slab", "y_sweep_slab", "cfl_finish", "cfl_tail"))
        ckpt = os.path.join(tmp, "mesh.ckpt.npz")
        row = {"dtype": dtype, "launches": {"per_cycle": c_cut}}
        for P in ((2, 2), (1, 1), (3, 2)):
            extra = _one_card(P) if P != (1, 1) else dict(device="cuda")
            w = files and P == (2, 2)
            res, c = cnt.path(f"{dtype} resume on {P}", lambda: armon(
                ArmonParameters(maxcycle=P10_MESH_CYCLES, use_MPI=True,
                                write_output=w, output_file="shards",
                                **extra, **opts),
                restore_from=ckpt), ("cfl_finish", "cfl_tail"))
            _same_run(torch, one, res, f"{dtype} resume on {P}", real=True)
            row["launches"][f"resume_{P[0]}x{P[1]}"] = c
            if w:
                mp = ArmonParameters(maxcycle=P10_MESH_CYCLES, use_MPI=True,
                                     **_one_card(P), **opts)
                for s in range(4):
                    coords = (s % 2, s // 2)
                    mine = subdomain.read_sub_domain_file(
                        mp.config, subdomain.sub_domain_file_path(
                            os.path.join(tmp, "shards"), coords), coords)
                    _, win = subdomain.read_global_file_window(
                        mp.config, os.path.join(tmp, "one"), coords)
                    for v in mine:
                        if not np.array_equal(mine[v], win[v]):
                            raise AssertionError(f"shard file {coords} {v}")
                row["shard_files_equal_windows"] = True
        row["resumes_bitwise"] = ["2x2", "1x1", "3x2"]
        out.append(row)
        del one, res
    return out


def phase10(torch):
    """Drivers, I/O and restart: the per-cycle driver and resumed runs
    through `armon()` on the card, bit for bit against the uninterrupted
    runs; written files against the goldens and the CPU's; compare mode
    across devices; meshes. Returns phase 10's launch counts by kernel."""
    import shutil
    import tempfile
    cnt = _Counted(torch)
    tmp = tempfile.mkdtemp(prefix="armon_p10_")
    try:
        out = {"phase": 10, "card": card_line()}
        out["restart_main"] = _p10_restart_main(torch, tmp, cnt)
        emit(out)
        routes = _p10_routes(torch, tmp, cnt)
        files = _p10_files(torch, tmp, cnt)
        cmp_dir = os.path.join(tmp, "cmp")
        os.makedirs(cmp_dir)
        compare_mode = _p10_compare(torch, cmp_dir)
        meshes = _p10_meshes(torch, tmp, cnt)
        emit({"phase": 10, "routes": routes, "files": files,
              "compare": compare_mode, "meshes": meshes,
              "launches": cnt.total})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cnt.total


# ----------------------------------------------------------- observability

OBS_CYCLES = 20          # the main path under the profiler, (a) and (b)
OBS_MESH_CYCLES = 10     # the 2x2 mesh under the profiler, (c)
A12_N, A12_CYCLES = 1000, 10
# A measured peak may exceed `memory_required()`'s total by this share:
# the caching allocator rounds each block up to 2 MiB and keeps small
# tensors (scalars, partials, slabs of K3's tail) in pools of their own.
MEM_MARGIN = 0.02
# The main path's kernels by the names CUPTI gives them (the template's
# base name, `csrc/*.cuh`): K1, K2 carrying K3's tail, K3; K4 and K5
# must not run.
OBS_KERNELS = {"x_sweep_kernel": "x_sweep", "y_sweep_finish_kernel": "y_sweep",
               "cfl_finish_kernel": "cfl_finish"}
OBS_ABSENT = ("cycle_kernel", "cycle_finish_kernel", "multicycle_kernel",
              "x_sweep_finish_kernel", "y_sweep_kernel")


def _base_kernel(name):
    """`x_sweep_kernel` of 'void armon::x_sweep_kernel<float, true, ...>'."""
    import re
    m = re.search(r"\b(\w+_kernel)<", name)
    return m.group(1) if m else name


def _trace_events(log_dir):
    """{kernel or copy name: [device us, in start order]} of the Chrome
    trace that `profiling=["trace"]` wrote under `log_dir/profile`, and
    the span in us from the first device event's start to the last's
    end."""
    import glob
    import json
    [path] = glob.glob(os.path.join(log_dir, "profile", "trace_*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    events.sort(key=lambda e: e["ts"])
    out = {}
    for e in events:
        out.setdefault(e["name"], []).append(float(e["dur"]))
    span = max(e["ts"] + e["dur"] for e in events) - events[0]["ts"] \
        if events else 0.0
    return out, span


def _by_base(table):
    """Sum a {name: value} table over `_base_kernel` names."""
    out = {}
    for k, v in table.items():
        b = _base_kernel(k)
        out[b] = out.get(b, 0) + v
    return out


def _windows_run(torch, opts):
    """The lean loop with window graphs (`whole=False`, the form a traced
    run takes) on `opts`' initial state, timed as `armon()` times its
    solve: (cycles, seconds)."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    params = ArmonParameters(**opts)
    fs, seed = make_init_fused(params)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = make_time_loop_lean(params.config, make_mesh(params),
                              whole=False)(fs, 0.0, 0, 0.0, float(seed))
    return res.cycles, time.perf_counter() - t0


def _p11_main_traced(torch, tmp, opts, rates):
    """(a) the main path's lean loop under the profiler: untraced with the
    whole-run graph ("whole") and with window graphs ("plain"), traced
    (window graphs), traced, then the untraced runs in reverse; the
    trace's cost against the untraced runs of its own form; the first
    traced run's kernels against the wrapper counts and phase 3's
    CUDA-event times."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    cells = MAIN_N * MAIN_N
    armon(ArmonParameters(**dict(opts, maxcycle=2)))
    _windows_run(torch, dict(opts, maxcycle=2))
    armon(ArmonParameters(**dict(opts, maxcycle=2, profiling=["trace"],
                                 output_dir=os.path.join(tmp, "warm"))))
    runs, traced = {"whole": [], "plain": [], "trace": []}, []
    for i, kind in enumerate(("whole", "plain", "trace", "trace", "plain",
                              "whole")):
        d = os.path.join(tmp, f"a{i}")
        K.reset_launches()
        if kind == "plain":
            cycles, secs = _windows_run(torch, opts)
        else:
            extra = dict(profiling=["trace"], output_dir=d) \
                if kind == "trace" else {}
            st = armon(ArmonParameters(**opts, **extra))
            cycles, secs = st.cycles, st.solve_time
        counts = {**K.LAUNCHES, **K.TAILS}
        if cycles != OBS_CYCLES:
            raise AssertionError(f"phase 11 (a): {cycles} cycles")
        runs[kind].append(cells * cycles / secs)
        if kind == "trace":
            traced.append((st, counts, d))
    st, counts, d = traced[0]
    events, span = _trace_events(d)
    calls = _by_base({k: len(v) for k, v in events.items()})
    for base, name in OBS_KERNELS.items():
        if calls.get(base, 0) != counts[name]:
            raise AssertionError(f"trace: {base} x{calls.get(base, 0)}, "
                                 f"wrapper {name} x{counts[name]}")
    if counts["cfl_finish"] != 1 or counts["x_sweep"] != counts["cfl_tail"] \
            or counts["x_sweep"] < st.cycles:
        raise AssertionError(f"main path sequencing under the trace: {counts}")
    for base in OBS_ABSENT:
        if calls.get(base, 0):
            raise AssertionError(f"the main path ran {base}: {calls}")
    # Per launch: the launches that computed a cycle (the last stop-check
    # batch launches past the run's end, passing the fields through).
    per = {}
    for base in OBS_KERNELS:
        durs = [u for k, v in events.items() if _base_kernel(k) == base
                for u in v][:st.cycles]
        per[base] = sum(durs) / len(durs) / 1e3
    p3 = rates.get("main", {}).get("kernel_ms")
    k3_ms = _k3_step_ms(torch, opts)
    ref = {"x_sweep_kernel": p3 and p3["x_sweep"],
           "y_sweep_finish_kernel": p3 and min(
               p3["with_and_without_tail_from_reset"]["y_sweep"]["with"]),
           "cfl_finish_kernel": k3_ms}
    within = {}
    for base in ("x_sweep_kernel", "y_sweep_finish_kernel"):
        if ref[base] is None:
            within[base] = "not measured: phase 3 did not run"
            continue
        within[base] = abs(per[base] - ref[base]) / ref[base]
        if within[base] > 0.10:
            raise AssertionError(f"{base}: {per[base]} ms a launch in the "
                                 f"trace, {ref[base]} ms by CUDA events")
    busy = sum(u for v in events.values() for u in v) / 1e6
    return {"cycles": st.cycles, "launches": counts,
            "trace_calls": {b: calls.get(b, 0)
                            for b in tuple(OBS_KERNELS) + OBS_ABSENT},
            "trace_ms_per_launch": per, "event_ms_per_launch": ref,
            "relative_difference": within,
            "cells_per_s": runs, "trace_overhead": 1 - (
                sum(runs["trace"]) / sum(runs["plain"])),
            "trace_against_whole_run": 1 - (
                sum(runs["trace"]) / sum(runs["whole"])),
            "device_busy_share_of_solve": busy / st.solve_time,
            "device_busy_share_of_span": busy * 1e6 / span if span else None,
            "trace_names": sorted(events)}


def _k3_step_ms(torch, opts):
    """CUDA-event ms of K3 as the main path runs it, once a run: no fold,
    one dt step, from the same scalars each call."""
    from armon_torch import ArmonParameters
    from armon_torch.ops import sweep as K
    cfg = ArmonParameters(**opts).config
    saved = saved_counts(K)
    dev = torch.device("cuda")
    partials = torch.zeros((2, 1), dtype=torch.float32, device=dev)
    s0, i0 = K.new_scalars(cfg.dtype, dev, lm=1e-4)
    s, i = s0.clone(), i0.clone()

    def reset():
        s.copy_(s0)
        i.copy_(i0)
    ms = time_ms(lambda _: K.cfl_finish(cfg, partials, 0, s, i, fold=False,
                                        step=True), k=50, reset=reset)
    restore_counts(K, saved)
    return ms


def _p11_logged(torch, tmp, opts, main):
    """(b) the same configuration through the per-cycle driver with
    `log_blocks` and the trace: the log against the device scalars of a
    run without it, the sections, the timer."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import step
    from armon_torch.ops import sweep as K
    # The scalars before each cycle of an unlogged lean run: t after the
    # cycle and the dt it uses (the previous launch's tail stepped them).
    # The spy reads them to the host before each cycle, which a graph's
    # capture cannot do, so this reference run is the eager loop's.
    seen = []
    real_cycle = step.KernelCycles.cycle

    def spy(self, cycle):
        seen.append(tuple(self.scal.tolist()))
        return real_cycle(self, cycle)
    step.KernelCycles.cycle = spy
    try:
        armon(ArmonParameters(**opts), graphs=False)
    finally:
        step.KernelCycles.cycle = real_cycle
    want = [(sc[K.SC_T], sc[K.SC_DTUSE]) for sc in seen[:OBS_CYCLES]]
    d = os.path.join(tmp, "b")
    K.reset_launches()
    st = armon(ArmonParameters(**opts, log_blocks=True, profiling=["trace"],
                               check_result=True, output_dir=d))
    log = st.grid_log
    got = [(e.t, e.dt) for e in log.events]
    if len(log.events) != OBS_CYCLES or got != want:
        raise AssertionError(f"solver log: {len(log.events)} events, "
                             f"{got[:3]} against {want[:3]}")
    a = log.analyse()
    probes = a.get("probe_sections", {})
    for key in ("sweep_X", "sweep_Y", "ghost_exchange_X", "ghost_exchange_Y"):
        if not probes.get(key, 0) > 0:
            raise AssertionError(f"probe section {key}: {probes}")
    if a["sections_source"] != "trace":
        raise AssertionError(f"sections from {a['sections_source']}")
    if set(st.timer) != {"init", "conservation_vars", "solver_cycle"} or \
            any(v["calls"] != 1 for v in st.timer.values()):
        raise AssertionError(f"timer {st.timer}")
    calls = _by_base({k: v["calls"] for k, v in log.trace_sections.items()})
    secs = _by_base({k: v["seconds"] for k, v in log.trace_sections.items()})
    expect = {"x_sweep_kernel": OBS_CYCLES, "y_sweep_finish_kernel": OBS_CYCLES,
              "cfl_finish_kernel": 1}
    for base, n in expect.items():
        if calls.get(base) != n:
            events, _ = _trace_events(d)
            raise AssertionError(
                f"per-cycle trace: {base} x{calls.get(base)}; table {calls}, "
                f"Chrome trace {_by_base({k: len(v) for k, v in events.items()})}")
    for base in OBS_ABSENT:
        if calls.get(base, 0):
            raise AssertionError(f"the per-cycle driver ran {base}")
    return {"events": len(log.events), "bitwise_vs_unlogged": True,
            "host_reads": st.host_reads, "timer": st.timer,
            "mean_cycle_ms": a["mean_cycle_seconds"] * 1e3,
            "cycle_time_trend": a.get("cycle_time_trend"),
            "probe_sections_ms": {k: v * 1e3 for k, v in probes.items()},
            "trace_ms_per_launch": {b: secs[b] / calls[b] * 1e3
                                    for b in expect},
            "lean_trace_ms_per_launch": main["trace_ms_per_launch"],
            "wrapper_launches_with_probes": {**K.LAUNCHES, **K.TAILS},
            "trace_kernels": {k: v for k, v in list(
                log.trace_sections.items())[:12]}}


def _p11_mesh(torch, tmp, rates):
    """(c) Sod 16384^2 over 2x2 on one card with `log_blocks` and the
    trace: the slab copies' share of device time."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.utils.solver_log import _is_collective
    d = os.path.join(tmp, "c")
    st = armon(ArmonParameters(test="Sod", N=(MESH_N, MESH_N), **SMALL_OPTS,
                               **_one_card(MESH_P), maxcycle=OBS_MESH_CYCLES,
                               log_blocks=True, profiling=["trace"],
                               output_dir=d))
    a = st.grid_log.analyse()
    coll = {k: v for k, v in st.grid_log.trace_sections.items()
            if _is_collective(k)}
    if st.cycles != OBS_MESH_CYCLES or not a["collective_seconds"] > 0:
        raise AssertionError(f"2x2 mesh under the trace: {st.cycles} cycles, "
                             f"collective {a['collective_seconds']}")
    return {"N": MESH_N, "P": list(MESH_P), "cycles": st.cycles,
            "collective_seconds": a["collective_seconds"],
            "collective_ms_per_cycle": a["collective_seconds"] / st.cycles * 1e3,
            "collective_wait_share": a["collective_wait_share"],
            "phase7_slab_copies_ms_per_cycle": rates.get(
                "mesh_slab_copies_ms", "not measured: phase 7 did not run"),
            "collective_kernels": coll,
            "trace_names": sorted(st.grid_log.trace_sections)}


def _p11_roundtrip(torch):
    """(e) `host_to_device(device_to_host(s))` on the shards of a run: each
    shard's real cells bit for bit, and the gathered grid (ghost bands
    included) bit for bit through gather, scatter, gather. A run's
    shards hold stale copies in the ghost bands they share with a
    neighbour (the kernels read the neighbour's slab), and an uneven
    split's edge shards dead slack: neither is state."""
    import numpy as np
    from armon_torch import (ArmonParameters, device_to_host,
                             host_to_device)
    from armon_torch.core.solver import (make_init_fused, make_mesh,
                                         make_rehydrate)
    from armon_torch.core.step import make_time_loop_lean
    out = {}
    for P in ((1, 1), (2, 2), (3, 2)):
        extra = _one_card(P) if P != (1, 1) else {}
        params = ArmonParameters(test="Sod_circ", N=(A12_N, A12_N),
                                 **SMALL_OPTS, **extra, maxcycle=A12_CYCLES)
        fs, local0 = make_init_fused(params)()
        res = make_time_loop_lean(params.config, make_mesh(params))(
            fs, np.float32(0), 0, np.float32(0), local0)
        shards = make_rehydrate(params)(res.carry)
        host = device_to_host(params, shards)
        back = host_to_device(params, host)
        g = params.nghost
        for shard, a, b in zip(make_mesh(params), shards, back):
            wx, hy = shard.n_real
            real = (slice(g, g + hy), slice(g, g + wx))
            if not all(torch.equal(x[real], y[real]) for x, y in zip(a, b)):
                raise AssertionError(f"round trip on {P}, shard {shard.index}")
        if not all(np.array_equal(x, y) for x, y in
                   zip(host, device_to_host(params, back))):
            raise AssertionError(f"gather, scatter, gather on {P}")
        out[f"{P[0]}x{P[1]}"] = {"shards": len(shards), "cycles": A12_CYCLES,
                                 "bitwise": True}
    return out


def _p11_cli(torch):
    """(f) `python -m armon_torch` on the card, as a user runs it."""
    import subprocess
    args = [sys.executable, "-m", "armon_torch", "test=Sod", "N=1024,1024",
            "maxcycle=10", "silent=4"]
    t0 = time.perf_counter()
    out = subprocess.run(args, cwd=HERE, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
    if out.returncode != 0 or "cycles:      10" not in out.stdout:
        raise AssertionError(f"CLI: rc {out.returncode}\n{out.stdout}\n"
                             f"{out.stderr}")
    return {"argv": args[1:], "rc": out.returncode,
            "stdout": out.stdout.strip().splitlines(),
            "seconds": time.perf_counter() - t0}


def _p11_memory(torch, opts, rates):
    """(d) `memory_required()` against the peaks measured on the card:
    one shard's initialisation and the main path's lean loop here, phase
    3's run (kernels, `return_data`), phase 7's 2x2 mesh on one card
    (`return_data`) and phase 9's (the op path); each peak over the
    allocation before its run."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.core.solver import make_init_fused
    kern = ArmonParameters(**opts).memory_required()
    kern_data = ArmonParameters(**opts, return_data=True).memory_required()
    op = ArmonParameters(**opts, kernel_tier="torch").memory_required()

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        del r
        return peak
    field = kern["per_device_field_bytes"]
    init = peak_of(lambda: make_init_fused(ArmonParameters(**opts))())
    lean = peak_of(lambda: armon(ArmonParameters(**opts)))
    rows = {"kernels_init": (init, kern["per_device_fused_total_bytes"]),
            "kernels_lean_run": (lean, kern["per_device_fused_total_bytes"])}
    p3, p9 = rates.get("main", {}).get("memory"), rates.get("op_memory")
    p7 = rates.get("mesh_memory")
    if p3:
        rows["kernels_phase3_return_data"] = (
            p3["peak"] - p3["before"], kern_data["per_device_fused_total_bytes"])
    if p9:
        rows["op_path_phase9"] = (p9["peak"] - p9["before"],
                                  op["per_device_total_bytes"])
    if p7:
        mesh = ArmonParameters(test="Sod", N=(MESH_N, MESH_N), **SMALL_OPTS,
                               **_one_card(MESH_P), return_data=True)
        rows["kernels_phase7_2x2_return_data"] = (
            p7["peak"] - p7["before"],
            mesh.memory_required()["per_device_fused_total_bytes"])
    out = {name: {"peak_bytes": peak, "reported_total_bytes": total,
                  "peak_fields": peak / field, "total_fields": total / field,
                  "peak_over_total": peak / total}
           for name, (peak, total) in rows.items()}
    out["margin"] = MEM_MARGIN
    out["not_measured"] = [n for n, r in (("phase 3", p3), ("phase 7", p7),
                                          ("phase 9", p9)) if not r]
    out["memory_required"] = {"kernels": kern, "kernels_return_data": kern_data,
                              "op_path": op}
    return out


def phase11(torch, rates):
    """Observability and the public API on the card (see the module doc).
    The solver's probe warnings are errors here."""
    import shutil
    import tempfile
    import warnings
    opts = dict(test="Sod", N=(MAIN_N, MAIN_N), data_type="float32",
                scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
                nghost=4, axis_splitting="Sequential", use_fast_math=True,
                silent=5, device="cuda", maxcycle=OBS_CYCLES)
    tmp = tempfile.mkdtemp(prefix="armon_p11_")
    card = card_line()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            # f32 runs with check_result warn that mass and energy moved
            # (their 1e-12 gate is an f64 gate, ROADMAP C2); (b) checks.
            warnings.filterwarnings("ignore", message="Mass and energy")
            # torch.profiler's own notice, given once a process, by the
            # first trace: phase 9's where it runs, else (a)'s.
            warnings.filterwarnings("ignore",
                                    message="Warning: Profiler clears events")
            main = _p11_main_traced(torch, tmp, opts, rates)
            emit({"phase": 11, "card": card, "main_traced": main})
            logged = _p11_logged(torch, tmp, opts, main)
            emit({"phase": 11, "card": card, "per_cycle_logged": logged})
            mesh = _p11_mesh(torch, tmp, rates)
            emit({"phase": 11, "card": card, "mesh_traced": mesh})
            emit({"phase": 11, "roundtrip": _p11_roundtrip(torch),
                  "cli": _p11_cli(torch)})
            torch.cuda.empty_cache()
            mem = _p11_memory(torch, opts, rates)
            emit({"phase": 11, "card": card, "memory": mem})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, row in mem.items():
        if isinstance(row, dict) and "peak_over_total" in row \
                and row["peak_over_total"] > 1 + MEM_MARGIN:
            raise AssertionError(f"memory: {name} peaks at {row['peak_bytes']}"
                                 f" B over memory_required's "
                                 f"{row['reported_total_bytes']} B")



# ------------------------------------------------------------ processes

# Phase 12's jobs: (a) two processes on cuda:0 over gloo (host copies,
# `gpu_aware=False`); (b) NCCL, a card a process. Each job's workers are
# this script run with `--mp-worker JOB RANK PORT DIR`; every leg of a
# job runs in one process group.
MP_JOBS = {
    "a": dict(nprocs=2, one_card=True, sedov=True, goldens=True,
              snapshot=True, timed=True,
              agree=(((AGREE_N, AGREE_N), (2, 1)), ((AGREE_N, AGREE_N), (2, 2)),
                     ((AGREE_N, AGREE_N - 1), (3, 2)))),
    "b2": dict(nprocs=2, one_card=False, sedov=True, goldens=False,
               snapshot=False, timed=False,
               agree=(((AGREE_N, AGREE_N), (2, 1)),)),
    "b4": dict(nprocs=4, one_card=False, sedov=False, goldens=True,
               snapshot=True, timed=True,
               agree=(((AGREE_N, AGREE_N), (2, 2)),)),
    # Phase 15's jobs (`_gp_worker`): graphs over NCCL, a card a process.
    "g2": dict(nprocs=2, one_card=False, graphs=True),
    "g4": dict(nprocs=4, one_card=False, graphs=True),
    # Phase 16 (d)'s job (`_kc_worker`): loops kept across calls over NCCL.
    "k2": dict(nprocs=2, one_card=False, cache=True),
}
MP_TIMEOUT = 400       # seconds a job may take, its workers' start included
MP_SNAPSHOT_AT = AGREE_CYCLES // 2
MP_FIELDS = ("rho", "u", "v", "E", "p")


def _mp_place(job, P):
    """Where a job's processes put their shards."""
    spec = MP_JOBS[job]
    if spec["one_card"]:
        return dict(devices=["cuda:0"] * (P[0] * P[1] // spec["nprocs"]),
                    gpu_aware=False)
    return dict(device="cuda")


def _digests(params, data):
    """{"cx,cy": {field: SHA-256 of the shard's real window}} of the
    shards of `data` (this process's, or one process's global State cut
    into `params`' layout): bit-for-bit comparisons across processes
    without moving the fields."""
    import hashlib
    import numpy as np
    from armon_torch.io.subdomain import shard_coords_iter, shard_real_window
    out = {}
    for coords, blk in shard_coords_iter(params, data, vars=MP_FIELDS):
        rs, cs, _, _ = shard_real_window(params.config, coords)
        out[f"{coords[0]},{coords[1]}"] = {
            v: hashlib.sha256(np.ascontiguousarray(blk[v][rs, cs]).tobytes()
                              ).hexdigest() for v in MP_FIELDS}
    return out


def _mp_expect(P, pair=False):
    """The kernels a mesh's run must launch across processes (K3 once a
    cycle, no tail)."""
    if pair:
        return ("cycle_slab", "cfl_finish")
    return (("x_sweep_slab",) if P[0] > 1 else ()) + (
        "y_sweep_slab" if P[1] > 1 else "y_sweep", "cfl_finish")


def _mp_worker(job, rank, port, tmp):
    """One process of a phase-12 job: its legs' results as one JSON
    line (digests, counts, times); the parent compares them."""
    import numpy as np
    import torch
    from armon_torch import ArmonParameters, armon, gather_state, SolverException
    from armon_torch.core import graphs as G
    from armon_torch.io.restart import save_checkpoint
    from armon_torch.io.subdomain import compare_sub_domain_with_golden, shard_states
    from armon_torch.ops import sweep as K
    from armon_torch.parallel import dist
    from armon_torch.parallel.halo import halo_slabs, new_slab_buffers
    from armon_torch.parallel.mesh import Mesh
    from armon_torch.scaling import _time_rounds
    from armon_torch.utils.enums import Axis
    spec = MP_JOBS[job]
    base = dict(coordinator_address=f"localhost:{port}",
                num_processes=spec["nprocs"], process_id=rank, silent=5,
                measure_time=False)
    cnt = _Counted(torch)
    out = {"rank": rank, "agree": [], "launches": {}}

    def run(what, expect, P, restore_from=None, graphs=None, **opts):
        params = ArmonParameters(P=P, **base, **_mp_place(job, P), **opts)
        stats, c = cnt.path(f"{job} {what}", lambda: armon(
            params, restore_from=restore_from, graphs=graphs), expect)
        out["launches"][what] = c
        return params, stats

    for dtype in ("float64", "float32"):
        cases = [("Sod_circ", N, P, AGREE_CYCLES, {}) for N, P in spec["agree"]]
        if spec["sedov"]:
            cases.append(("Sedov", (SEDOV_N, SEDOV_N), SEDOV_P,
                          SEDOV_AGREE_CYCLES, PAIR))
        for test, N, P, cycles, route in cases:
            what = f"{test} {N} {P} {dtype}"
            params, stats = run(what, _mp_expect(P, bool(route)), P,
                                test=test, N=N, data_type=dtype,
                                use_fast_math=False, maxcycle=cycles,
                                return_data=True, **route)
            out["agree"].append({
                "test": test, "N": list(N), "P": list(P), "dtype": dtype,
                "scalars": [stats.cycles, stats.final_time, stats.last_dt],
                "digests": _digests(params, stats.data)})
    try:
        gather_state(params, stats.data)
        raise AssertionError("gather_state did not raise across processes")
    except SolverException as e:
        if "per-shard" not in str(e):
            raise
    out["gather_refused"] = True

    if spec["goldens"]:
        golden = []
        for test in ("Sod", "Sod_y", "Sod_circ"):
            for dtype in ("float64", "float32"):
                bits = 64 if dtype == "float64" else 32
                params, stats = run(
                    f"golden {test} {dtype}", _mp_expect((2, 2)), (2, 2),
                    test=test, N=(100, 100), data_type=dtype,
                    use_fast_math=False, maxcycle=1000, return_data=True)
                _, ref_cycles, diffs, _ = compare_sub_domain_with_golden(
                    params, stats.data,
                    os.path.join(REF_DIR, f"ref_{test}_{bits}bits.csv"),
                    1e-13 if bits == 64 else 1e-5,
                    4 * np.finfo(np.float64).eps if bits == 64
                    else 20 * np.finfo(np.float32).eps)
                golden.append({"test": test, "dtype": dtype, "diffs": diffs,
                               "cycles": stats.cycles,
                               "ref_cycles": ref_cycles})
        out["goldens_2x2"] = golden

    if spec["snapshot"]:
        opts = dict(test="Sod_circ", N=(AGREE_N, AGREE_N), data_type="float64",
                    use_fast_math=False, return_data=True)
        P = (2, 2)
        p1, s1 = run("snapshot run", _mp_expect(P), P,
                     maxcycle=MP_SNAPSHOT_AT, **opts)
        ckpt = os.path.join(tmp, f"mp12_{job}.ckpt.npz")
        save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                        s1.last_dt)
        p2, s2 = run("resume", _mp_expect(P), P, restore_from=ckpt,
                     maxcycle=AGREE_CYCLES, **opts)
        out["resumed"] = {"scalars": [s2.cycles, s2.final_time, s2.last_dt],
                          "digests": _digests(p2, s2.data)}

    if spec["timed"]:
        P = MESH_P
        opts = dict(test="Sod", N=(MESH_N, MESH_N),
                    **{k: v for k, v in SMALL_OPTS.items()
                       if k not in ("silent", "device")})
        # The eager loop, the yardstick over processes (phase 15 times the
        # graph forms).
        armon(ArmonParameters(P=P, maxcycle=16, **base, **_mp_place(job, P),
                              **opts), graphs=False)
        torch.cuda.synchronize()
        staged = dict(dist.STAGED)
        params, stats = run("timed", _mp_expect(P), P, graphs=False,
                            maxcycle=MESH_CYCLES, return_data=True, **opts)
        cyc, solve_s = stats.cycles, stats.solve_time
        form = G.STATS["form"]
        cfg, dev = params.config, params.device
        mesh = Mesh.of(params)
        cur = [(st.rho, st.u, st.v, st.E)
               for st in shard_states(params, stats.data)]
        del stats
        bufs = {a: new_slab_buffers(cfg, mesh, cur, a) for a in (Axis.X, Axis.Y)}
        timed = {
            "cycles": cyc, "solve_s": solve_s, "form": form,
            "staged_per_cycle": {k: (dist.STAGED[k] - staged[k]) / cyc
                                 for k in staged},
            "exchange_ms_per_cycle": _time_rounds(
                lambda: [halo_slabs(cfg, mesh, cur, a, bufs[a]) for a in bufs],
                dev, 3),
            "gather_ms_per_cycle": _time_rounds(
                lambda: dist.all_gather_rows(torch.zeros(
                    (2, len(mesh.local) * K.n_partials(Axis.Y, cur[0][0].shape, dev)),
                    dtype=cur[0][0].dtype, device=dev)), dev, 3)}
        out["timed"] = timed
    print(dist.result_line(out), flush=True)
    dist.shutdown()
    return 0


def _ref_digests(torch, test, N, P, dtype, single):
    """`_digests` of a one-process run `single` cut into P's layout."""
    from armon_torch import ArmonParameters
    params = ArmonParameters(test=test, N=N, P=P, data_type=dtype,
                             devices=["cuda:0"] * (P[0] * P[1]))
    return _digests(params, single.data)


def _mp_job(torch, job, tmp):
    """Run one job's workers; their JSON results in rank order."""
    from armon_torch.parallel.dist import run_workers
    return run_workers(
        lambda rank, port: [sys.executable, os.path.abspath(__file__),
                            "--mp-worker", job, rank, port, tmp],
        MP_JOBS[job]["nprocs"], MP_TIMEOUT, tmp, cwd=HERE)


def _mp_check(torch, job, results, singles):
    """Every agree run's shards, over the job's processes, bit for bit
    against the one-process run; the goldens with 0 differences; the
    resumed snapshot bit for bit; every worker's launches. Returns the
    job's line and its launches by kernel."""
    spec = MP_JOBS[job]
    line = {"job": job, "processes": spec["nprocs"],
            "transport": "gloo (host copies), cuda:0" if spec["one_card"]
            else "nccl, a card a process"}
    agree = []
    for k, row in enumerate(results[0]["agree"]):
        test, N, P, dtype = row["test"], tuple(row["N"]), tuple(row["P"]), row["dtype"]
        single = singles[test, N, dtype]
        want = _ref_digests(torch, test, N, P, dtype, single)
        got = {}
        for r in results:
            rr = r["agree"][k]
            if rr["scalars"] != [single.cycles, single.final_time, single.last_dt]:
                raise AssertionError(f"{job} {row['test']} {N} {P} {dtype}: "
                                     f"scalars {rr['scalars']} vs one process")
            got.update(rr["digests"])
        if got != want:
            bad = sorted(c for c in want if got.get(c) != want[c])
            raise AssertionError(f"{job} {test} {N} {P} {dtype}: shards {bad} "
                                 f"differ from the one-process run")
        agree.append({"test": test, "N": list(N), "P": list(P), "dtype": dtype,
                      "cycles": single.cycles, "bitwise": True})
    line["processes_vs_one_process"] = agree
    line["gather_state_refused"] = all(r["gather_refused"] for r in results)
    if spec["goldens"]:
        rows = []
        for k, g in enumerate(results[0]["goldens_2x2"]):
            diffs = sum(r["goldens_2x2"][k]["diffs"] for r in results)
            if diffs or g["cycles"] != g["ref_cycles"]:
                raise AssertionError(f"{job} golden {g}: {diffs} differences")
            rows.append(dict(g, diffs=diffs))
        line["goldens_2x2"] = rows
    if spec["snapshot"]:
        single = singles["Sod_circ", (AGREE_N, AGREE_N), "float64"]
        want = _ref_digests(torch, "Sod_circ", (AGREE_N, AGREE_N), (2, 2),
                            "float64", single)
        got = {}
        for r in results:
            got.update(r["resumed"]["digests"])
            if r["resumed"]["scalars"] != [single.cycles, single.final_time,
                                           single.last_dt]:
                raise AssertionError(f"{job} resume: {r['resumed']['scalars']}")
        if got != want:
            raise AssertionError(f"{job}: the per-shard snapshot resumed at "
                                 f"{MP_SNAPSHOT_AT} differs")
        line["snapshot_resumed_bitwise"] = f"at {MP_SNAPSHOT_AT} of {AGREE_CYCLES}"
    launches = {}
    for r in results:
        for counts in r["launches"].values():
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
    line["launches"] = launches
    return line, launches


def _mp_timed(results, rates):
    """The timed run's line: cells/s from the slowest process's solve."""
    t = [r["timed"] for r in results]
    solve = max(x["solve_s"] for x in t)
    cells = MESH_N * MESH_N * MESH_CYCLES
    launches = {}
    for r in results:
        for name, n in r["launches"]["timed"].items():
            launches[name] = launches.get(name, 0) + n
    forms = {x["form"] for x in t}
    if len(forms) != 1:
        raise AssertionError(f"the timed run's processes took forms {forms}")
    out = {"test": "Sod", "N": MESH_N, "P": list(MESH_P), "cycles": MESH_CYCLES,
           "form": forms.pop(),
           "cells_per_s": cells / solve, "cycle_ms": solve / MESH_CYCLES * 1e3,
           "launches_per_cycle": {k: n / MESH_CYCLES for k, n in launches.items()},
           "exchange_ms_per_cycle": max(x["exchange_ms_per_cycle"] for x in t),
           "gather_ms_per_cycle": max(x["gather_ms_per_cycle"] for x in t),
           "staged_copies_per_cycle_per_process": t[0]["staged_per_cycle"],
           "one_process_mesh_cycle_ms": rates.get("mesh_cycle_ms"),
           "one_card_8192_cells_per_s": rates.get("main", {}).get("cells_per_s")}
    if out["one_process_mesh_cycle_ms"]:
        out["over_one_process_ms_per_cycle"] = \
            out["cycle_ms"] - out["one_process_mesh_cycle_ms"]
    return out


def phase12(torch, rates):
    """Runs over several processes (see the module doc); returns phase
    12's launches by kernel."""
    import shutil
    import tempfile
    torch.cuda.empty_cache()
    singles = {}
    for dtype in ("float64", "float32"):
        for N in ((AGREE_N, AGREE_N), (AGREE_N, AGREE_N - 1)):
            singles["Sod_circ", N, dtype] = _single(torch, "Sod_circ", N, dtype,
                                                   AGREE_CYCLES)
        singles["Sedov", (SEDOV_N, SEDOV_N), dtype] = _single(
            torch, "Sedov", (SEDOV_N, SEDOV_N), dtype, SEDOV_AGREE_CYCLES)
    total = {}
    tmp = tempfile.mkdtemp(prefix="armon_p12_")
    try:
        jobs = ["a"]
        cards = torch.cuda.device_count()
        jobs += [j for j, need in (("b2", 2), ("b4", 4)) if cards >= need]
        for job in jobs:
            t0 = time.perf_counter()
            results = _mp_job(torch, job, tmp)
            line, launches = _mp_check(torch, job, results, singles)
            if MP_JOBS[job]["timed"]:
                line["timed"] = _mp_timed(results, rates)
                rates[f"p12_{job}_timed"] = line["timed"]
            line["seconds"] = time.perf_counter() - t0
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            emit({"phase": 12, "card": card_line(), **line})
        if cards < 4:
            emit({"phase": 12, "nccl": "not run" + (" on four cards" if cards >= 2
                                                     else "") +
                  f": the machine has {cards} card(s)"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# ------------------------------------------------------------ graphs

GRAPH_CYCLES = 40        # phase 13 (a)'s runs
GRAPH_RESUME_AT = 7      # (a)'s resumed run starts at this odd cycle
# (b)'s cells: (name, armon() options, cycles).
GRAPH_CELLS = (
    ("Sod 100^2 pair", dict(test="Sod", N=(SOD_N, SOD_N), **PAIR), 2000),
    ("Sod 100^2 multicycle", dict(test="Sod", N=(SOD_N, SOD_N)), 4000),
    ("Sedov 2000^2 per-sweep", dict(test="Sedov", N=(SEDOV_N, SEDOV_N),
                                    **PER_SWEEP), 500),
    ("Sedov 2000^2 over 1x2", dict(test="Sedov", N=(SEDOV_N, SEDOV_N),
                                   **_one_card(SEDOV_P)), 500),
    ("main path Sod 8192^2", dict(test="Sod", N=(MAIN_N, MAIN_N)), MAIN_CYCLES),
    # The per-cycle driver with no host work but its read a cycle (a
    # snapshot step it never reaches).
    ("per-cycle driver Sod 8192^2", dict(test="Sod", N=(MAIN_N, MAIN_N),
                                         checkpoint_step=1 << 30), 32),
)


def _outcome(res):
    """(the scalars, host reads included, and the fields) of an `armon()`
    result with its data or of a loop's `LoopResult`."""
    if hasattr(res, "data"):
        d = res.data
        return ((res.cycles, res.final_time, res.last_dt, res.host_reads),
                [d.rho, d.u, d.v, d.E, d.p])
    carry = res.carry if isinstance(res.carry, list) else [res.carry]
    return ((res.cycles, res.t, res.dt_last, res.lm, res.ok, res.host_reads),
            [a for c in carry for a in c])


def _same_scalars(a, b):
    """Two tuples of a run's scalars equal bit for bit (a NaN equals the
    same NaN)."""
    import struct
    return len(a) == len(b) and all(
        struct.pack("<d", x) == struct.pack("<d", y)
        if isinstance(x, float) and isinstance(y, float) else x == y
        for x, y in zip(a, b))


def _graphs_vs_eager(torch, what, run):
    """`run(graphs)` eager (graphs=False), then with graphs (None, the
    default): the same scalars and host reads, every field bit for bit,
    the same launch counts, graphs replayed only in the second."""
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    got = []
    for graphs in (False, None):
        K.reset_launches()
        G.reset_stats()
        res = run(graphs)
        torch.cuda.synchronize()
        got.append((_outcome(res), {**K.LAUNCHES, **K.TAILS}, dict(G.STATS)))
    ((sc_e, f_e), n_e, g_e), ((sc_g, f_g), n_g, g_g) = got
    if not _same_scalars(sc_e, sc_g) or not all(_bits_equal(torch, a, b)
                               for a, b in zip(f_e, f_g)):
        raise AssertionError(f"graphs against eager, {what}: {sc_g} "
                             f"against {sc_e}")
    if n_e != n_g or g_e["replays"] or not g_g["replays"]:
        raise AssertionError(f"graphs against eager, {what}: launches "
                             f"{n_g} against {n_e}, graphs {g_g}, eager {g_e}")
    return {"case": what, "cycles": sc_g[0], "host_reads": sc_g[-1],
            "launches": {k: v for k, v in n_g.items() if v},
            "graphs": g_g["graphs"], "replays": g_g["replays"],
            "capture_ms": g_g["capture_ms"], "bitwise": True}


class _Lean:
    """A lean run ready to go again: ``run(graphs, whole, every)`` is the
    lean loop (`make_time_loop_lean` with those arguments, `check_every`
    = `every`) on a copy of the carry, from cycle `start` (the carry of an
    eager run that far: a resume), with `kind` as the loop builder takes
    it, the shards where the options place them, and `poison(carry)`
    applied after the initialisation. `k` is the cycles of one step (K on
    the multicycle route, else 1)."""

    def __init__(self, base, start=0, every=8, whole=True, kind=None,
                 poison=None, **opts):
        import dataclasses
        from armon_torch import ArmonParameters
        from armon_torch.core.solver import make_init_fused, make_mesh
        from armon_torch.core.step import make_time_loop_lean
        from armon_torch.ops.routing import route, temporal_pairs
        params = ArmonParameters(**{**base, **opts})
        self.cfg = cfg = params.config
        self.mesh, self.kind = make_mesh(params), kind
        self.every, self.whole, self.start = every, whole, start
        multi = (kind or route(cfg)) == "multicycle"
        self.k = len(temporal_pairs(cfg)) if multi else 1
        fs, seed = make_init_fused(params)()
        if poison:
            poison(fs)
        t, dt, lm = 0.0, 0.0, float(seed)
        if start:
            first = make_time_loop_lean(
                dataclasses.replace(cfg, maxcycle=start), self.mesh, kind=kind,
                graphs=False)(fs, t, 0, dt, lm)
            fs, t, dt, lm = first.carry, first.t, first.dt_last, first.lm
        self.fs, self.t, self.dt, self.lm = fs, t, dt, lm
        self.build = make_time_loop_lean

    def __call__(self, graphs, whole=..., every=None):
        carry = [type(f)(*(a.clone() for a in f)) for f in self.fs]
        return self.build(self.cfg, self.mesh, kind=self.kind, graphs=graphs,
                          whole=self.whole if whole is ... else whole)(
            carry, self.t, self.start, self.dt, self.lm,
            check_every=every or self.every)


def _p13_agree(torch):
    """(a) window graphs against the eager loop on every path, f64 and
    f32 exact."""
    import contextlib
    import io
    from armon_torch import ArmonParameters, armon
    rows = []
    for dtype in ("float64", "float32"):
        base = dict(data_type=dtype, use_fast_math=False, silent=5,
                    device="cuda", maxcycle=GRAPH_CYCLES, return_data=True)

        def windows(start=0, every=8, **opts):
            return _Lean(base, start, every, whole=False, **opts)

        def driver(**opts):
            def run(graphs):
                with contextlib.redirect_stdout(io.StringIO()):
                    return armon(ArmonParameters(**{**base, **opts}),
                                 graphs=graphs)
            return run

        cases = (
            ("Sod_circ 1000^2 per-sweep", windows(
                test="Sod_circ", N=(AGREE_N, AGREE_N), **PER_SWEEP)),
            ("Sedov 2000^2 pair", windows(
                test="Sedov", N=(SEDOV_N, SEDOV_N), **PAIR)),
            ("Sod 100^2 multicycle", windows(
                test="Sod", N=(SOD_N, SOD_N), maxcycle=4 * GRAPH_CYCLES)),
            (f"Strang pair resumed at cycle {GRAPH_RESUME_AT}", windows(
                GRAPH_RESUME_AT, 8, test="Sod_circ", N=(AGREE_N, AGREE_N),
                axis_splitting="Strang", **PAIR)),
            ("SequentialSym pair, check_every=3", windows(
                0, 3, test="Sod_circ", N=(AGREE_N, AGREE_N),
                axis_splitting="SequentialSym", **PAIR)),
            ("Sod_circ 1000^2 over 2x2 on one card", windows(
                test="Sod_circ", N=(AGREE_N, AGREE_N), **_one_card((2, 2)))),
            ("per-cycle driver, Sod_circ 1000^2 pair, silent=1",
             driver(test="Sod_circ", N=(AGREE_N, AGREE_N), silent=1, **PAIR)),
        )
        for what, run in cases:
            row = _graphs_vs_eager(torch, what, run)
            row["dtype"] = dtype
            rows.append(row)
    driver = [r for r in rows if r["case"].startswith("per-cycle")]
    if any(r["replays"] != r["cycles"] for r in driver):
        raise AssertionError(f"the per-cycle driver: {driver}")
    return rows


def _p13_timed(torch):
    """(b) us a cycle through `armon()` of the per-cycle driver at the
    main path's size (one-cycle window graphs), f32 fast math: eager,
    graphs, graphs, eager in one process, after a warm-up run of each.
    The lean cells are timed by phase 14 (b), eager, window graphs and
    the whole-run graph."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    from armon_torch.ops.routing import route as route_of
    out = []
    for name, opts, cycles in GRAPH_CELLS[-1:]:
        opts = {**SMALL_OPTS, **opts}
        for graphs in (False, None):
            armon(ArmonParameters(maxcycle=16, **opts), graphs=graphs)
        runs = []
        for graphs in (False, None, None, False):
            torch.cuda.synchronize()
            K.reset_launches()
            G.reset_stats()
            st = armon(ArmonParameters(maxcycle=cycles, **opts),
                       graphs=graphs)
            launches = sum(K.LAUNCHES.values())
            runs.append({"graphs": graphs is None, "cycles": st.cycles,
                         "cycle_us": st.solve_time / st.cycles * 1e6,
                         "cycle_us_without_capture":
                             (st.solve_time - G.STATS["capture_ms"] / 1e3)
                             / st.cycles * 1e6,
                         "capture_ms": G.STATS["capture_ms"],
                         "graphs_captured": G.STATS["graphs"],
                         # a second run with graphs replays the one-cycle
                         # graph the first captured (the program cache)
                         "replayed_only": graphs is None
                         and not G.STATS["graphs"],
                         "replays": G.STATS["replays"],
                         "host_reads": st.host_reads,
                         "launches_per_cycle": launches / st.cycles})
        same = {(r["cycles"], r["host_reads"], r["launches_per_cycle"])
                for r in runs}
        if len(same) != 1:
            raise AssertionError(f"{name}: graphs changed the run: {runs}")
        eager = [r["cycle_us"] for r in runs if not r["graphs"]]
        graphed = [r["cycle_us"] for r in runs if r["graphs"]]
        out.append({"cell": name, "route": route_of(
            ArmonParameters(maxcycle=cycles, **opts).config),
            "eager_cycle_us": eager, "graph_cycle_us": graphed,
            "speedup_of_means": sum(eager) / sum(graphed), "runs": runs})
    return out


def phase13(torch):
    """The compile-once loop layer: graphs against the eager loop, bit
    for bit, and the time a cycle with and without them."""
    card = card_line()
    emit({"phase": 13, "card": card, "graphs_vs_eager": _p13_agree(torch)})
    emit({"phase": 13, "card": card, "timed": _p13_timed(torch)})


# ------------------------------------------------------ whole-run graphs

WHOLE_FORMS = ("eager", "windows", "whole")  # phase 14's forms
# (b)'s order: each form four times, mirrored, so drift in the card's
# state or the host's load falls on every form alike.
WHOLE_ORDER = (WHOLE_FORMS + WHOLE_FORMS[::-1]) * 2
WHILE_N = 1000  # (c): iterations of the WHILE timed alone


def _form_args(form):
    """(graphs, whole) of a phase 14 form."""
    return {"eager": (False, False), "windows": (None, False),
            "whole": (None, True)}[form]


def _run_form(torch, lean, form, every=None):
    """`lean` run once in `form`, from zeroed counts: (result, launch
    counts, graph statistics and the count of the tails that set the
    WHILE condition)."""
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    K.reset_launches()
    G.reset_launches()
    G.reset_stats()
    graphs, whole = _form_args(form)
    res = lean(graphs, whole, every)
    torch.cuda.synchronize()
    return res, {**K.LAUNCHES, **K.TAILS}, {**G.STATS, **G.LAUNCHES}


def _whole_vs_eager(torch, what, lean):
    """(a) one case: eager, window graphs and the whole-run graph, bit
    for bit; a whole run is one graph launch and one host read (3 with
    the result's two), its launches those of the eager loop with
    `check_every` the body's length, the condition set by one launch a
    body."""
    sc_e, f_e = _outcome(_run_form(torch, lean, "eager")[0])
    out = {"case": what, "cycles": sc_e[0]}
    for form in WHOLE_FORMS[1:]:
        res, counts, st = _run_form(torch, lean, form)
        sc, f = _outcome(res)
        if not _same_scalars(sc[:-1], sc_e[:-1]) or not all(
                _bits_equal(torch, a, b) for a, b in zip(f, f_e)):
            raise AssertionError(f"{what}, {form}: {sc} against eager {sc_e}")
        if form == "windows":
            continue
        body = st["body_steps"]
        _, n_eager, _ = _run_form(torch, lean, "eager", body * lean.k)
        bodies = -(-(sc[0] - lean.start) // (body * lean.k))
        if (st["runs"], st["replays"], st["graphs"], sc[-1]) != (1, 1, 1, 3) \
                or counts != n_eager or \
                st["while_tail"] != st["iterations"] or \
                (sc[4] is not False and st["iterations"] != bodies):
            raise AssertionError(f"{what}, {form}: {st}, host reads {sc[-1]}, "
                                 f"launches {counts} against {n_eager}")
        out.update({"body_steps": body, "iterations": st["iterations"],
                    "host_reads": sc[-1], "capture_ms": st["capture_ms"],
                    "launches": {k: v for k, v in counts.items() if v}})
    out["bitwise"] = True
    return out


def _p14_restore_armon(torch, dtype):
    """(a) through `armon()`: Sod 100^2 (a K5 grid) saved at the odd cycle
    7 by the per-cycle driver, resumed to 40 through the full-state
    restore loop with graphs and without: bit for bit, one whole run."""
    import contextlib
    import io
    import shutil
    import tempfile
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    tmp = tempfile.mkdtemp(prefix="armon_p14_")
    try:
        opts = dict(test="Sod", N=(SOD_N, SOD_N), data_type=dtype,
                    use_fast_math=False, silent=5, device="cuda",
                    output_dir=tmp, output_file="snap")
        with contextlib.redirect_stdout(io.StringIO()):
            armon(ArmonParameters(maxcycle=GRAPH_RESUME_AT,
                                  checkpoint_step=GRAPH_RESUME_AT, **opts))
        snap = os.path.join(tmp, "snap.ckpt.npz")
        runs = []
        for graphs in (False, None):
            G.reset_stats()
            st = armon(ArmonParameters(maxcycle=GRAPH_CYCLES,
                                       return_data=True, **opts),
                       restore_from=snap, graphs=graphs)
            torch.cuda.synchronize()
            runs.append((_outcome(st), dict(G.STATS)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ((sc_e, f_e), _), ((sc_w, f_w), g) = runs
    if not _same_scalars(sc_w[:-1], sc_e[:-1]) or sc_w[-1] != 3 or \
            g["runs"] != 1 or \
            not all(_bits_equal(torch, a, b) for a, b in zip(f_w, f_e)):
        raise AssertionError(f"restore through armon(): {sc_w} {g} against "
                             f"{sc_e}")
    return {"case": f"Sod 100^2 restored at {GRAPH_RESUME_AT} through armon()",
            "dtype": dtype, "cycles": sc_w[0], "host_reads": sc_w[-1],
            "iterations": g["iterations"], "bitwise": True}


def _p14_agree(torch):
    """(a) the whole-run graph against the eager loop and window graphs on
    every path, f64 and f32 exact."""
    from armon_torch.ops.routing import cycle_route
    from armon_torch import ArmonParameters
    rows = []
    for dtype in ("float64", "float32"):
        base = dict(data_type=dtype, use_fast_math=False, silent=5,
                    device="cuda", maxcycle=GRAPH_CYCLES)
        sod = dict(test="Sod", N=(SOD_N, SOD_N))
        restore = cycle_route(ArmonParameters(**base, **sod).config)
        g = 4

        def nan_u(fs):
            fs[0].u[g + 5, g + 7] = float("nan")
        cases = (
            ("Sod_circ 1000^2 per-sweep", _Lean(
                base, test="Sod_circ", N=(AGREE_N, AGREE_N), **PER_SWEEP)),
            ("Sod 1000^2 per-sweep, Sequential (a body of one cycle), "
             f"resumed at {GRAPH_RESUME_AT}", _Lean(
                 base, GRAPH_RESUME_AT, test="Sod", N=(AGREE_N, AGREE_N),
                 **PER_SWEEP)),
            ("Sedov 2000^2 pair", _Lean(
                base, test="Sedov", N=(SEDOV_N, SEDOV_N), **PAIR)),
            ("Sod 100^2 multicycle", _Lean(
                base, maxcycle=4 * GRAPH_CYCLES, **sod)),
            ("Sod 100^2 multicycle, K = 3", _Lean(
                base, maxcycle=4 * GRAPH_CYCLES, temporal_blocking=3, **sod)),
            (f"Strang pair resumed at cycle {GRAPH_RESUME_AT}", _Lean(
                base, GRAPH_RESUME_AT, test="Sod_circ", N=(AGREE_N, AGREE_N),
                axis_splitting="Strang", **PAIR)),
            ("SequentialSym pair, check_every=3", _Lean(
                base, 0, 3, test="Sod_circ", N=(AGREE_N, AGREE_N),
                axis_splitting="SequentialSym", **PAIR)),
            ("Sod_circ 1000^2 over 2x2 on one card", _Lean(
                base, test="Sod_circ", N=(AGREE_N, AGREE_N),
                **_one_card((2, 2)))),
            ("Sedov 2000^2 over 1x2 on one card, pair", _Lean(
                base, test="Sedov", N=(SEDOV_N, SEDOV_N),
                **_one_card(SEDOV_P))),
            (f"full-state restore loop, Sod 100^2 from {GRAPH_RESUME_AT}",
             _Lean(base, GRAPH_RESUME_AT, kind=restore, **sod)),
            ("failing dt gate (a NaN in u), Sod_circ 1000^2 per-sweep", _Lean(
                base, test="Sod_circ", N=(AGREE_N, AGREE_N), poison=nan_u,
                **PER_SWEEP)),
        )
        for what, lean in cases:
            row = _whole_vs_eager(torch, what, lean)
            row["dtype"] = dtype
            if what.startswith("failing") and (row["cycles"] >= GRAPH_CYCLES):
                raise AssertionError(f"{what}: ran {row['cycles']} cycles")
            rows.append(row)
        rows.append(_p14_restore_armon(torch, dtype))
    return rows


def _card_state():
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _p14_timed(torch):
    """(b) us a cycle of phase 13's lean cells through the lean loop (the
    solve `armon()` times), f32 fast math: eager, window graphs and the
    whole-run graph, each four times in `WHOLE_ORDER`, after a warm-up run of each;
    the bits of every run against the first eager run's; on the main
    path, the card's SM clock, power and temperature after each run."""
    from armon_torch.ops.routing import route as route_of
    out = []
    for name, opts, cycles in GRAPH_CELLS[:-1]:
        lean = _Lean({**SMALL_OPTS, "maxcycle": cycles}, **opts)
        for form in WHOLE_FORMS:
            _run_form(torch, lean, form)
        runs, ref = [], None
        for form in WHOLE_ORDER:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, counts, st = _run_form(torch, lean, form)
            secs = time.perf_counter() - t0
            sc, f = _outcome(res)
            if ref is None:
                ref = sc, f
            elif not _same_scalars(sc[:-1], ref[0][:-1]) or not all(
                    _bits_equal(torch, a, b) for a, b in zip(f, ref[1])):
                raise AssertionError(f"{name}, {form}: {sc} against {ref[0]}")
            runs.append({"form": form, "cycle_us": secs / sc[0] * 1e6,
                         "cycle_us_without_capture":
                             (secs - st["capture_ms"] / 1e3) / sc[0] * 1e6,
                         "capture_ms": st["capture_ms"],
                         "graphs": st["graphs"], "replays": st["replays"],
                         "iterations": st["iterations"],
                         "host_reads": sc[-1],
                         "launches_per_cycle": sum(
                             v for k, v in counts.items() if k != "cfl_tail")
                         / sc[0]})
            if opts["N"][0] == MAIN_N:
                runs[-1]["card_after"] = _card_state()
        by = {form: [r["cycle_us"] for r in runs if r["form"] == form]
              for form in WHOLE_FORMS}
        less = {form: [r["cycle_us_without_capture"] for r in runs
                       if r["form"] == form] for form in WHOLE_FORMS}
        out.append({"cell": name, "route": route_of(lean.cfg),
                    "cycles": cycles, "cycle_us": by,
                    "cycle_us_without_capture": less, "runs": runs})
    return out


def _p14_while(torch, launches):
    """(c) the WHILE condition alone: a WHILE of `WHILE_N` iterations whose
    body is one launch that takes one from the predicate and sets the
    condition from what is left (`_Countdown`, `countdown_kernel`), as the
    solver's last launch sets it from the predicate it writes, built by
    the solver's own `CycleGraphs.run`, then relaunched and timed a launch
    (an untimed reset of the predicate before each), against its plain
    version (`graphs.while_plain` over a PyTorch decrement, a host read an
    iteration); per iteration. Its kernels-line entry, with the main
    path's `launches` (phase 3: the tails that set the condition, one a
    body): `max_abs_err` is the largest difference of the iterations and
    of the predicate it ends with from the plain version's; `ms` and
    `plain_ms` are a whole iteration, the launch that sets the condition
    and, on the card, the node's turn-around (`ms_covers`), and
    `bound_ms` the bytes of that launch."""
    from armon_torch._card import kernel_entry
    from armon_torch.core import graphs as G
    from armon_torch.ops import _build
    saved = dict(G.LAUNCHES), dict(G.MEASURE)
    try:
        run = _Countdown(torch, WHILE_N)
        graphs = G.CycleGraphs("cuda")
        iters = graphs.run(run, 0, 1)
        plain = _Countdown(torch, WHILE_N, plain=True)
        plain_iters = G.while_plain(plain, 0, 1, 0)
        got = iters, int(run.iscal.item())
        want = plain_iters, int(plain.iscal.item())
        err = max(abs(a - b) for a, b in zip(got, want))
        if err or got != (WHILE_N, 0):
            raise AssertionError(f"WHILE of {WHILE_N}: (iterations, "
                                 f"predicate) {got} against {want}")
        (_, loop, _), = graphs.wholes.values()
        exe = loop.exec
        ms = time_ms(lambda i: _build.while_launch(exe, run.iscal.device),
                     k=5, reset=lambda: run.iscal.fill_(WHILE_N)) / WHILE_N
        plain_ms = time_ms(lambda i: G.while_plain(plain, 0, 1, 0), k=2,
                           reset=lambda: plain.iscal.fill_(WHILE_N)) / WHILE_N
        torch.cuda.synchronize()
    finally:
        G.LAUNCHES.update(saved[0])
        G.MEASURE.update(saved[1])
    # An iteration: the launch reads and writes the predicate and the
    # count (16 bytes) and sets the condition.
    entry = kernel_entry(
        "while_cond", "armon_torch/csrc/common.cuh",
        "none: the cond of lax.while_loop, armon_tpu/core/step.py:461-478",
        launches, float(err), ms, plain_ms, bound(16, {"float32": 2}))
    entry["ms_covers"] = ("one WHILE iteration: a one-element countdown "
                          "launch that sets the condition (set_while, as "
                          "the solver's last launch of a body) and the "
                          "node's turn-around")
    return entry


def phase14(torch, rates):
    """The whole-run graph: against the eager loop and window graphs, bit
    for bit; the time a cycle in each form; the WHILE condition's
    kernels-line entry."""
    card = card_line()
    emit({"phase": 14, "card": card, "whole_vs_eager": _p14_agree(torch)})
    emit({"phase": 14, "card": card, "timed": _p14_timed(torch)})
    entry = _p14_while(torch, rates.get("main", {}).get("while_tail", 0))
    emit({"phase": 14, "card": card, "while_cond": entry})
    return [entry]


# ------------------------------------------------ graphs over processes

GP_TIMED_ORDER = (False, None, None, False)  # (b): eager, graphs, graphs, eager
GP_SEDOV_CYCLES = 500                        # (b)'s Sedov 2000^2 over 1x2


def _shard_digests(cfg, mesh, carry):
    """{shard index: [SHA-256 of each field's real window]} of this
    process's shards of a loop's carry."""
    import hashlib
    g = cfg.nghost
    return {str(s.index): [hashlib.sha256(
        a[g:g + s.n_real[1], g:g + s.n_real[0]].contiguous().cpu().numpy()
        .tobytes()).hexdigest() for a in c] for s, c in zip(mesh.local, carry)}


def _gp_case(torch, what, lean, total):
    """(a) one case in this process of a run over processes: the eager
    loop, window graphs and the loop's default form (window graphs over
    NCCL, `core/graphs.whole_reason`), every local shard bit for bit
    (SHA-256 of its real window), the same scalars and host reads, and
    the eager loop's launches; `graphs=True` with the whole-run graph
    raises, naming NCCL. Raises where a check fails; each run's launches
    go into `total`."""
    from armon_torch import SolverException

    def form_run(form, every=None):
        res, counts, st = _run_form(torch, lean, form, every)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        return res, counts, st

    eager, n_eager, _ = form_run("eager")
    sc_e = _outcome(eager)[0]
    want = _shard_digests(lean.cfg, lean.mesh, eager.carry)
    out = {"case": what, "cycles": sc_e[0]}
    for form in ("windows", "whole"):
        res, counts, st = form_run(form)
        sc = _outcome(res)[0]
        if not _same_scalars(sc[:-1], sc_e[:-1]) or \
                _shard_digests(lean.cfg, lean.mesh, res.carry) != want:
            raise AssertionError(f"{what}, {form}: {sc} against eager {sc_e}")
        if counts != n_eager or st["form"] != "windows" or st["runs"] or \
                sc[-1] != sc_e[-1]:
            raise AssertionError(f"{what}, {form} asked: {st}, host reads "
                                 f"{sc[-1]} against {sc_e[-1]}, launches "
                                 f"{counts} against {n_eager}")
    try:
        lean(True, True, None)
    except SolverException as e:
        refusal = str(e)
    else:
        raise AssertionError(f"{what}: graphs=True ran a whole run over NCCL")
    if "NCCL" not in refusal:
        raise AssertionError(f"{what}: graphs=True refused with {refusal!r}")
    out.update({"form": st["form"], "host_reads": sc[-1],
                "scalars": list(sc[:-1]), "replays": st["replays"],
                "capture_ms": st["capture_ms"],
                "launches": {k: v for k, v in counts.items() if v},
                "whole_refused": refusal, "shards": sorted(want),
                "bitwise": True})
    return out


def _gp_driver(torch, base, dtype, total):
    """(a) the per-cycle driver (`silent=1`) over processes through
    `armon()`: with graphs (a one-cycle window graph replayed a cycle)
    against `graphs=False`, bit for bit, the same host reads and
    launches."""
    import contextlib
    import io
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    runs = []
    for graphs in (False, None):
        params = ArmonParameters(**{
            **base, "silent": 1, "test": "Sod_circ", "N": (AGREE_N, AGREE_N),
            "P": SEDOV_P, "data_type": dtype, "maxcycle": GRAPH_CYCLES,
            "return_data": True})
        K.reset_launches()
        G.reset_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            st = armon(params, graphs=graphs)
        torch.cuda.synchronize()
        counts = {**K.LAUNCHES, **K.TAILS}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        runs.append((st.cycles, st.final_time, st.last_dt, st.host_reads,
                     _digests(params, st.data), counts, dict(G.STATS)))
    (e, g) = runs
    if e[:5] != g[:5] or e[5] != g[5] or g[6]["replays"] != g[0] or \
            g[6]["form"] != "windows":
        raise AssertionError(f"per-cycle driver over processes: {g[:4]} "
                             f"{g[6]} against {e[:4]}")
    return {"case": "per-cycle driver, Sod_circ 1000^2 over 1x2, silent=1",
            "dtype": dtype, "cycles": g[0], "host_reads": g[3],
            "form": g[6]["form"], "replays": g[6]["replays"],
            "capture_ms": g[6]["capture_ms"], "scalars": list(g[:3]),
            "shards": sorted(g[4]), "bitwise": True}


def _gp_timed(torch, base, opts, cycles, total):
    """(b) one cell through `armon()` in `GP_TIMED_ORDER` (eager, graphs,
    graphs, eager) after a warm-up run of each: this process's solve
    seconds, capture ms, form and host reads a run."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    for graphs in (False, None):
        armon(ArmonParameters(**base, **opts, maxcycle=16), graphs=graphs)
    runs = []
    for graphs in GP_TIMED_ORDER:
        torch.cuda.synchronize()
        K.reset_launches()
        G.reset_stats()
        st = armon(ArmonParameters(**base, **opts, maxcycle=cycles),
                   graphs=graphs)
        torch.cuda.synchronize()
        for k, n in {**K.LAUNCHES, **K.TAILS}.items():
            total[k] = total.get(k, 0) + n
        runs.append({"graphs": graphs is None, "form": G.STATS["form"],
                     "cycles": st.cycles,
                     "solve_s": st.solve_time,
                     "captures": G.STATS["graphs"],
                     "capture_ms": G.STATS["capture_ms"],
                     "host_reads": st.host_reads})
    return runs


def _gp_worker(job, rank, port, tmp):
    """One process of a phase-15 job: its cases' rows, timed runs and
    launches as one JSON line; the parent compares the processes'."""
    import torch
    from armon_torch.parallel import dist
    spec = MP_JOBS[job]
    base = dict(coordinator_address=f"localhost:{port}",
                num_processes=spec["nprocs"], process_id=rank, silent=5,
                measure_time=False, device="cuda")
    total = {}
    out = {"rank": rank, "agree": [], "timed": {}}
    for dtype in ("float64", "float32"):
        b = dict(base, data_type=dtype, use_fast_math=False,
                 maxcycle=GRAPH_CYCLES)
        sod = dict(test="Sod_circ", N=(AGREE_N, AGREE_N))
        if spec["nprocs"] == 2:
            cases = (
                ("Sod_circ 1000^2 over 2x1 per-sweep", _Lean(
                    b, P=(2, 1), **sod, **PER_SWEEP)),
                ("Sedov 2000^2 over 1x2 pair", _Lean(
                    b, test="Sedov", N=(SEDOV_N, SEDOV_N), P=SEDOV_P, **PAIR)),
                (f"Strang pair over 1x2 resumed at cycle {GRAPH_RESUME_AT}",
                 _Lean(b, GRAPH_RESUME_AT, P=SEDOV_P, axis_splitting="Strang",
                       **sod, **PAIR)))
        else:
            cases = (
                ("Sod_circ 1000^2 over 2x2 per-sweep", _Lean(
                    b, P=(2, 2), **sod)),
                (f"Strang over 2x2 resumed at cycle {GRAPH_RESUME_AT}", _Lean(
                    b, GRAPH_RESUME_AT, P=(2, 2), axis_splitting="Strang",
                    **sod)))
        for what, lean in cases:
            row = _gp_case(torch, what, lean, total)
            row["dtype"] = dtype
            out["agree"].append(row)
        if spec["nprocs"] == 2:
            out["agree"].append(_gp_driver(
                torch, dict(base, use_fast_math=False), dtype, total))
    fast = {k: v for k, v in SMALL_OPTS.items() if k not in ("silent", "device")}
    if spec["nprocs"] == 2:
        out["timed"]["Sedov 2000^2 over 1x2"] = _gp_timed(
            torch, base, dict(fast, test="Sedov", N=(SEDOV_N, SEDOV_N),
                              P=SEDOV_P), GP_SEDOV_CYCLES, total)
    else:
        out["timed"]["Sod 16384^2 over 2x2"] = _gp_timed(
            torch, base, dict(fast, test="Sod", N=(MESH_N, MESH_N), P=MESH_P),
            MESH_CYCLES, total)
    out["launches"] = total
    print(dist.result_line(out), flush=True)
    dist.shutdown()
    return 0


def _gp_check(job, results, rates):
    """The processes of a phase-15 job agree: each case's form, replays,
    scalars and host reads the same on every process, every
    shard covered; the timed runs' lines (the slowest process's solve, a
    run's capture ms its largest), beside phase 12's timed run."""
    rows = []
    for k, row in enumerate(results[0]["agree"]):
        mine = [r["agree"][k] for r in results]
        keys = ("form", "replays", "scalars", "host_reads", "cycles")
        if any({key: m.get(key) for key in keys} !=
               {key: row.get(key) for key in keys} for m in mine):
            raise AssertionError(f"{job} {row['case']}: the processes "
                                 f"disagree: {mine}")
        shards = sorted(s for m in mine for s in m["shards"])
        rows.append(dict({k: v for k, v in row.items() if k != "shards"},
                         shards=len(shards)))
    line = {"job": job, "processes": MP_JOBS[job]["nprocs"],
            "transport": "nccl, a card a process", "graphs_vs_eager": rows}
    timed = {}
    for cell, runs in results[0]["timed"].items():
        per = [r["timed"][cell] for r in results]
        out = []
        for i, run in enumerate(runs):
            ranks = [p[i] for p in per]
            if len({(x["form"], x["cycles"], x["host_reads"])
                    for x in ranks}) != 1:
                raise AssertionError(f"{job} {cell}: processes disagree: {ranks}")
            solve = max(x["solve_s"] for x in ranks)
            out.append({"form": run["form"], "cycles": run["cycles"], "host_reads": run["host_reads"],
                        "cycle_ms": solve / run["cycles"] * 1e3,
                        "cycle_ms_without_capture": max(
                            x["solve_s"] - x["capture_ms"] / 1e3
                            for x in ranks) / run["cycles"] * 1e3,
                        "capture_ms": max(x["capture_ms"] for x in ranks),
                        # the second graphs run replays the first's
                        # windows (the program cache): no capture
                        "captures": max(x["captures"] for x in ranks)})
        eager = [r["cycle_ms"] for r in out if r["form"] == "eager"]
        graphed = [r["cycle_ms"] for r in out if r["form"] != "eager"]
        timed[cell] = {"runs": out, "eager_cycle_ms": eager,
                       "graph_cycle_ms": graphed}
    p12 = rates.get("p12_b4_timed")
    if "Sod 16384^2 over 2x2" in timed:
        timed["Sod 16384^2 over 2x2"]["phase12"] = {
            "cycle_ms": p12["cycle_ms"], "form": p12["form"]} if p12 else \
            "not measured: phase 12 did not run on four cards"
    line["timed"] = timed
    launches = {}
    for r in results:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    line["launches"] = {k: v for k, v in launches.items() if v}
    return line, launches


def phase15(torch, rates):
    """Graphs over NCCL processes (see the module doc); returns phase
    15's launches by kernel."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    total = {}
    if cards < 2:
        emit({"phase": 15, "graphs_over_processes": f"not run: the machine "
              f"has {cards} card(s), and NCCL puts one process on a card"})
        return total
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="armon_p15_")
    try:
        for job in ["g2"] + (["g4"] if cards >= 4 else []):
            t1 = time.perf_counter()
            line, launches = _gp_check(job, _mp_job(torch, job, tmp), rates)
            line["seconds"] = time.perf_counter() - t1
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            emit({"phase": 15, "card": card_line(), **line})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if cards < 4:
        emit({"phase": 15, "four_cards": f"not run: the machine has {cards} "
              f"card(s)"})
    emit({"phase": 15, "seconds": time.perf_counter() - t0})
    return total


# ------------------------------------------------- loops kept across calls

CACHE_CALLS = 5          # phase 16's timed calls, after one warm-up call
# A warm call "stalled" where its host ms outside the graph launch pass
# this: the copies, K3 and the reads take ~2 ms at 8192^2, torch's
# `capture_begin` stalled 13.63-101.67 ms in some captures on an H100
# (`tools/graph_costs.py`).
CACHE_STALL_MS = 10.0
# (a) and (b)'s cells: (name, options over SMALL_OPTS, cycles a call).
CACHE_CELLS = (
    ("Sod 8192^2 per-sweep (the main path)",
     dict(test="Sod", N=(MAIN_N, MAIN_N)), MAIN_CYCLES),
    ("Sod 100^2 multicycle", dict(test="Sod", N=(SOD_N, SOD_N)), 4000),
    ("Sod 100^2 pair", dict(test="Sod", N=(SOD_N, SOD_N), **PAIR), 2000),
    ("Sedov 2000^2 pair", dict(test="Sedov", N=(SEDOV_N, SEDOV_N), **PAIR),
     SEDOV_CYCLES),
)
A8_CYCLES = {MAIN_N: 20, SOD_N: 400}  # (e): cycles a run by grid edge


def _clone_carry(fs):
    return [type(f)(*(a.clone() for a in f)) for f in fs]


def _carry_bits(torch, a, b):
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    return all(_bits_equal(torch, x, y) for f, g in zip(a, b)
               for x, y in zip(f, g))


def _loop_call(torch, loop, fs, local0):
    """One call of a kept lean loop from cycle 0, from zeroed counts:
    (result, host seconds to its end, launch counts, graph statistics)."""
    import numpy as np
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    T = np.dtype(loop.cfg.dtype).type
    torch.cuda.synchronize()
    K.reset_launches()
    G.reset_launches()
    G.reset_stats()
    t0 = time.perf_counter()
    res = loop(fs, T(0.0), 0, T(0.0), local0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, {**K.LAUNCHES, **K.TAILS, **G.LAUNCHES}, dict(G.STATS)


def _copy_ms(torch, run, fs):
    """The device ms of a call's copy in (the caller's five fields into
    the loop's first set, `Tensor.copy_`) and of its copy out (five
    clones of the loop's carry), on the loop's own buffers."""
    def copy_in(i):
        for dst, p, f in zip(run.sets[0], run.p, fs):
            for d, a in zip(dst, f[:4]):
                d.copy_(a)
            p.copy_(f.p)

    def copy_out(i):
        return [a.clone() for c in run.cur for a in c] + \
            [p.clone() for p in run.p]
    return time_ms(copy_in, k=1), time_ms(copy_out, k=1)


def _p16_cell(torch, name, opts, cycles, total):
    """(a), (b): one cell in `bench.py`'s pattern (`bench.py:84-104`):
    `make_jit_loop_lean(params)` built once, one warm-up call, then
    `CACHE_CALLS` timed calls on the same input carry; per call its
    captures, copy-in and copy-out ms, host ms outside the graph launch
    and cells/s; every call bit for bit the first, launches equal, the
    input untouched; a run stopped on its dt gate (a NaN), after which
    K3's ticket is 0 and the next call is the first's again; in f32
    exact, cold, warm and `graphs=False` bit for bit."""
    import numpy as np
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused, make_jit_loop_lean
    from armon_torch.ops.routing import route as route_of
    params = ArmonParameters(**SMALL_OPTS, **opts, maxcycle=cycles)
    fs, local0 = make_init_fused(params)()
    before = _clone_carry(fs)
    loop = make_jit_loop_lean(params)
    if make_jit_loop_lean(params) is not loop:
        raise AssertionError(f"{name}: equal params gave another loop")
    cells = params.N[0] * params.N[1]
    calls, first = [], None
    for i in range(1 + CACHE_CALLS):
        res, secs, counts, st = _loop_call(torch, loop, fs, local0)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        cin, cout = _copy_ms(torch, loop.run, fs)
        sc = _outcome(res)[0]
        if first is None:
            first = res, counts, sc
        elif not _same_scalars(sc, first[2]) or \
                not _carry_bits(torch, res.carry, first[0].carry) or \
                counts != first[1]:
            raise AssertionError(f"{name}: call {i} {sc} {counts} against "
                                 f"the first {first[2]} {first[1]}")
        calls.append({"call": i, "captures": st["graphs"],
                      "capture_ms": st["capture_ms"],
                      "form": st["form"], "copy_in_ms": cin,
                      "copy_out_ms": cout,
                      "host_ms_outside_launch": secs * 1e3 - st["launch_ms"],
                      "launch_ms": st["launch_ms"], "call_ms": secs * 1e3,
                      "cells_per_s": cells * sc[0] / secs})
    if calls[0]["captures"] < 1 or any(c["captures"] for c in calls[1:]):
        raise AssertionError(f"{name}: captures {[c['captures'] for c in calls]}")
    if sc[0] != cycles or not _carry_bits(torch, fs, before):
        raise AssertionError(f"{name}: {sc[0]} cycles, or the input changed")
    timed = [c["call_ms"] for c in calls[1:]]
    # A run stopped on its dt gate, then the clean carry again.
    g = params.nghost
    bad = _clone_carry(fs)
    bad[0].u[g + 5, g + 7] = float("nan")
    failed = _loop_call(torch, loop, bad, local0)[0]
    ticket = getattr(loop.run, "ticket", None)
    ticket = None if ticket is None else int(ticket.item())
    again = _loop_call(torch, loop, fs, local0)
    if failed.ok or ticket not in (None, 0) or again[3]["graphs"] or \
            not _same_scalars(_outcome(again[0])[0], first[2]) or \
            not _carry_bits(torch, again[0].carry, first[0].carry):
        raise AssertionError(f"{name}: after a failed dt gate: ok "
                             f"{failed.ok}, ticket {ticket}, {again[3]}")
    # f32 exact: cold, warm and the eager loop bit for bit.
    exact = ArmonParameters(**{**SMALL_OPTS, "use_fast_math": False}, **opts,
                            maxcycle=cycles)
    xs, x0 = make_init_fused(exact)()
    xloop = make_jit_loop_lean(exact)
    xr = [_loop_call(torch, xloop, xs, x0) for _ in range(2)]
    xe = _loop_call(torch, make_jit_loop_lean(exact, graphs=False), xs, x0)
    if xr[1][3]["graphs"] or xe[3]["form"] != "eager" or not all(
            _same_scalars(_outcome(r[0])[0][:-1], _outcome(xe[0])[0][:-1])
            and _carry_bits(torch, r[0].carry, xe[0].carry) for r in xr):
        raise AssertionError(f"{name}: f32 exact cold / warm / eager differ")
    return {"cell": name, "route": route_of(params.config), "cycles": cycles,
            "calls": calls, "spread": (max(timed) - min(timed)) / min(timed),
            "timed_call_ms": timed,
            "stalled": [c["call"] for c in calls[1:]
                        if c["host_ms_outside_launch"] > CACHE_STALL_MS],
            "ticket_after_failed_gate": ticket,
            "bitwise_calls": True, "bitwise_f32_exact_vs_eager": True}


def _p16_armon_twice(torch):
    """(c) `armon()` twice with one params (the main path, 20 cycles,
    `return_data`): the second captures nothing and gives equal fields."""
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    params = ArmonParameters(**SMALL_OPTS, test="Sod", N=(MAIN_N, MAIN_N),
                             maxcycle=20, return_data=True)
    runs = []
    for _ in range(2):
        G.reset_stats()
        st = armon(params)
        torch.cuda.synchronize()
        runs.append((_outcome(st), dict(G.STATS)))
    ((sc_a, f_a), g_a), ((sc_b, f_b), g_b) = runs
    if g_b["graphs"] or g_a["graphs"] < 1 or not _same_scalars(sc_a, sc_b) \
            or not all(_bits_equal(torch, x, y) for x, y in zip(f_a, f_b)):
        raise AssertionError(f"armon() twice: {sc_b} {g_b} against {sc_a} "
                             f"{g_a}")
    return {"case": "armon() twice, Sod 8192^2, 20 cycles",
            "captures": [g_a["graphs"], g_b["graphs"]],
            "capture_ms": [g_a["capture_ms"], g_b["capture_ms"]],
            "forms": [g_a["form"], g_b["form"]], "bitwise": True}


def _p16_driver(torch, dtype="float32", silents=(5, 0, 1)):
    """(e) the per-cycle driver with its kept one-cycle window graphs at
    `silent` 0 and 1, Sod 8192^2 and 100^2 (f32 fast math; phase 17 (d)
    runs it in f64), a warm-up run then a timed one, beside the lean
    loop's warm run (`silent` 5): us a cycle, host reads a cycle, captures
    in the timed run, K6 `ff_sum`'s launches a cycle (in f32 one a shard
    a cycle and one at init, none in f64 or in the lean run), and no call
    of the plain column loop (`ops/reductions._ff_sum`) on a CUDA tensor."""
    import contextlib
    import io
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.ops import reductions as R
    from armon_torch.ops import sweep as K
    plain = R._ff_sum
    on_card = []

    def spy(x):
        if x.device.type == "cuda":
            on_card.append(tuple(x.shape))
        return plain(x)
    rows = []
    R._ff_sum = spy
    try:
        for n, cycles in A8_CYCLES.items():
            base = dict(SMALL_OPTS, test="Sod", N=(n, n), maxcycle=cycles,
                        data_type=dtype)
            row = {"cell": f"Sod {n}^2 {dtype}", "cycles": cycles}
            for silent in silents:
                out = []
                for _ in range(2):
                    before = K.LAUNCHES["ff_sum"]
                    with contextlib.redirect_stdout(io.StringIO()):
                        G.reset_stats()
                        st = armon(ArmonParameters(**{**base, "silent": silent}))
                    out.append((st, dict(G.STATS),
                                K.LAUNCHES["ff_sum"] - before))
                st, g, ff = out[1]
                key = "lean" if silent == 5 else f"silent_{silent}"
                row[key] = {"cycle_us": st.solve_time / st.cycles * 1e6,
                            "host_reads_per_cycle": st.host_reads / st.cycles,
                            "captures": g["graphs"], "form": g["form"],
                            "ff_sum_per_cycle": ff / st.cycles,
                            "cold_cycle_us": out[0][0].solve_time
                            / out[0][0].cycles * 1e6}
                if g["graphs"]:
                    raise AssertionError(f"(e) Sod {n}^2 silent={silent}: the "
                                         f"warm run captured {g['graphs']}")
                want = st.cycles + 1 if silent <= 1 and dtype == "float32" else 0
                if ff != want:
                    raise AssertionError(f"(e) Sod {n}^2 {dtype} silent="
                                         f"{silent}: {ff} ff_sum launches, "
                                         f"{want} expected")
            rows.append(row)
    finally:
        R._ff_sum = plain
    if on_card:
        raise AssertionError(f"the plain column loop ran on the card: {on_card}")
    return rows


def _kc_worker(job, rank, port, tmp):
    """(d) one process over NCCL: each case's kept lean loop called twice
    on one carry, and its eager loop: captures, form, scalars and the
    digests of this process's shards; the cache after `dist.shutdown`."""
    import torch
    from armon_torch import ArmonParameters
    from armon_torch.core import solver
    from armon_torch.core.solver import (make_init_fused, make_jit_loop_lean,
                                         make_mesh)
    from armon_torch.parallel import dist
    base = dict(coordinator_address=f"localhost:{port}",
                num_processes=MP_JOBS[job]["nprocs"], process_id=rank,
                silent=5, measure_time=False, device="cuda",
                data_type="float32", use_fast_math=False,
                maxcycle=GRAPH_CYCLES)
    total, out = {}, {"rank": rank, "cases": []}
    for what, opts in (
            ("Sod_circ 1000^2 over 2x1 per-sweep",
             dict(test="Sod_circ", N=(AGREE_N, AGREE_N), P=(2, 1),
                  **PER_SWEEP)),
            ("Sedov 2000^2 over 1x2 pair",
             dict(test="Sedov", N=(SEDOV_N, SEDOV_N), P=SEDOV_P, **PAIR))):
        params = ArmonParameters(**base, **opts)
        mesh = make_mesh(params)
        fs, local0 = make_init_fused(params)()
        calls = []
        for loop in (make_jit_loop_lean(params), make_jit_loop_lean(params),
                     make_jit_loop_lean(params, graphs=False)):
            res, secs, counts, st = _loop_call(torch, loop, fs, local0)
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            calls.append({"captures": st["graphs"], "form": st["form"],
                          "replays": st["replays"],
                          "scalars": list(_outcome(res)[0]),
                          "digests": _shard_digests(params.config, mesh,
                                                    res.carry),
                          "ms": secs * 1e3})
        out["cases"].append({"case": what, "calls": calls})
    out["entries"] = len(solver._FN_CACHE)
    dist.shutdown()
    out["entries_after_shutdown"] = len(solver._FN_CACHE)
    out["launches"] = total
    print(dist.result_line(out), flush=True)
    return 0


def _p16_processes(torch):
    """(d) on two or more cards: `_kc_worker` on two NCCL processes; the
    second call captures nothing on any process and every call is bit for
    bit the eager loop's, the same on every process. Returns (line,
    launches)."""
    import json
    import shutil
    import tempfile
    cards = torch.cuda.device_count()
    if cards < 2:
        return {"processes": f"not run: the machine has {cards} card(s), and "
                             f"NCCL puts one process on a card"}, {}
    tmp = tempfile.mkdtemp(prefix="armon_p16_")
    try:
        results = _mp_job(torch, "k2", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows, launches = [], {}
    for k, case in enumerate(results[0]["cases"]):
        mine = [r["cases"][k] for r in results]
        for m in mine:
            cold, warm, eager = m["calls"]
            if cold["captures"] < 1 or warm["captures"] or \
                    eager["form"] != "eager" or \
                    {c["form"] for c in (cold, warm)} != {"windows"} or \
                    not (cold["digests"] == warm["digests"] == eager["digests"])\
                    or cold["scalars"][:-1] != eager["scalars"][:-1] or \
                    warm["scalars"] != cold["scalars"]:
                raise AssertionError(f"(d) {case['case']}: {m}")
        if len({json.dumps(m["calls"][1]["scalars"]) for m in mine}) != 1:
            raise AssertionError(f"(d) {case['case']}: processes disagree")
        rows.append({"case": case["case"],
                     "captures": [[c["captures"] for c in m["calls"][:2]]
                                  for m in mine],
                     "call_ms": [[c["ms"] for c in m["calls"]] for m in mine],
                     "form": case["calls"][0]["form"], "bitwise": True})
    for r in results:
        if r["entries_after_shutdown"]:
            raise AssertionError(f"(d) shutdown left {r['entries_after_shutdown']}"
                                 f" entries")
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return {"processes": 2, "transport": "nccl, a card a process",
            "cases": rows,
            "entries_before_shutdown": [r["entries"] for r in results]}, \
        launches


def phase16(torch):
    """Loops kept across calls (see the module doc): the program cache
    emptied first, so that each cell's first call is cold. Returns phase
    16's launches by kernel."""
    from armon_torch.core.solver import clear_cache
    t0 = time.perf_counter()
    card = card_line()
    clear_cache()
    total = {}
    for name, opts, cycles in CACHE_CELLS:
        emit({"phase": 16, "card": card,
              "kept_loop": _p16_cell(torch, name, opts, cycles, total)})
        clear_cache()
    emit({"phase": 16, "card": card, "armon_twice": _p16_armon_twice(torch)})
    clear_cache()
    line, launches = _p16_processes(torch)
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    emit({"phase": 16, "card": card, **line})
    from armon_torch.ops import sweep as K
    before = {**K.LAUNCHES, **K.TAILS}
    emit({"phase": 16, "card": card, "per_cycle_driver": _p16_driver(torch)})
    for name, n in {**K.LAUNCHES, **K.TAILS}.items():
        total[name] = total.get(name, 0) + n - before[name]
    clear_cache()
    emit({"phase": 16, "seconds": time.perf_counter() - t0})
    return total


# ------------------------------------------- the conservation kernel (K6)

P17_CYCLES = 20
# (a): the lean runs whose final states K6 is held on, (test, edge, the
# fast-math settings).
P17_STATES = (("Sod", MAIN_N, (True,)), ("Sod", SOD_N, (True, False)),
              ("Sedov", SEDOV_N, (True, False)))
P17_SPLIT = ((3, 1), 1000)  # an uneven split on one card (334, 334, 332)
P17_STRIPS = ((1, 5000), (5000, 1), (1, 1))  # real (nx, ny) of random blocks
# The card test's blocks (`tests/test_torch_conservation.py` ODD): block
# (nx, ny) inside the ghosts, real (nx, ny), ghost width, base offset in
# floats; every row stride modulo 4, ghosts 2, 4, 5, rows off K6's 16,
# one row, one column, an unaligned base: both load paths.
P17_ODD = (((1, 1), (1, 1), 4, 0), ((1, 70), (1, 70), 4, 0),
           ((53, 1), (53, 1), 4, 0), ((129, 37), (129, 37), 4, 0),
           ((1000, 334), (1000, 333), 4, 0), ((100, 100), (100, 100), 4, 0),
           ((64, 64), (64, 64), 4, 0), ((130, 45), (130, 45), 2, 0),
           ((101, 33), (101, 33), 5, 0), ((70, 17), (70, 17), 5, 0),
           ((200, 16), (197, 15), 2, 0), ((1000, 1), (1000, 1), 2, 0),
           ((4, 300), (1, 300), 2, 0), ((1, 300), (1, 300), 5, 0),
           ((100, 100), (100, 100), 4, 1), ((1000, 1), (999, 1), 2, 3))
P17_LINES = (("Sod 100^2", dict(test="Sod", N=(SOD_N, SOD_N)), 30),
             ("Sod 1000^2 over 3x1 on one card, exact",
              dict(test="Sod", N=(1000, 1000), use_fast_math=False,
                   **_one_card((3, 1))), 10))
FF_OPS_PER_CELL = 15  # two 2Sums of 7 adds and subtracts, the energy's multiply


def _ff_check(torch, cfg, rho, E, n_real, what, scratch=None):
    """K6 against its plain version on CPU copies of the same tensors, bit
    for bit (a NaN equals any NaN: the card's NaN payload is not the
    CPU's)."""
    import numpy as np
    from armon_torch.ops.reductions import ff_sum, ff_sum_plain
    got = ff_sum(cfg, rho, E, n_real, scratch)
    want = ff_sum_plain(cfg, rho.cpu(), E.cpu(), n_real)
    nan = np.isnan(got)
    if not (np.array_equal(nan, np.isnan(want)) and np.array_equal(
            got[~nan].view(np.uint32), want[~nan].view(np.uint32))):
        raise AssertionError(f"ff_sum, {what}: {got.tolist()} against the "
                             f"plain version's {want.tolist()}")
    return {"case": what, "n_real": list(n_real or cfg.n_local),
            "values": got.tolist(), "bitwise": True}


def _p17_states(torch):
    """(a) K6 on the final states of 20-cycle lean runs, on each shard of
    an uneven split, on one-row and one-column blocks, and on a field
    holding an inf and a NaN (twice on one scratch: the ticket resets).
    Returns the checks and the states (b) times it on."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops.reductions import FfScratch
    checks, states = [], {}
    for test, n, fasts in P17_STATES:
        for fast in fasts:
            params = ArmonParameters(**dict(
                SMALL_OPTS, test=test, N=(n, n), maxcycle=P17_CYCLES,
                use_fast_math=fast, return_data=True))
            st = armon(params).data
            what = f"{test} {n}^2 after {P17_CYCLES} cycles, " + \
                ("fast math" if fast else "exact")
            checks.append(_ff_check(torch, params.config, st.rho, st.E, None,
                                    what))
            if fast:
                states[n] = (params.config, st.rho, st.E)
            del st
    P, n = P17_SPLIT
    cfg, mesh, res, _ = _mesh_mid_state(torch, "Sod", (n, n), P, "float32",
                                        True, cycles=P17_CYCLES)
    for shard, f in zip(mesh.local, res.carry):
        checks.append(_ff_check(torch, cfg, f.rho, f.E, shard.n_real,
                                f"shard {shard.ix},{shard.iy} of Sod {n}^2 "
                                f"over {P[0]}x{P[1]}"))
    del res
    cfg, rho, E = states[SOD_N]
    g = cfg.nghost
    rng = np.random.default_rng(17)
    for nx, ny in P17_STRIPS:
        a, b = (torch.from_numpy(rng.random((ny + 2 * g, nx + 2 * g),
                                            dtype=np.float32)).cuda()
                for _ in range(2))
        checks.append(_ff_check(torch, cfg, a, b, (nx, ny),
                                f"random block of {nx}x{ny} real cells"))
    nx, ny = cfg.n_local
    bad = rho.clone()
    bad[g + 3, g + 7] = float("inf")
    bad[g + ny // 2, g + nx // 5] = float("nan")
    scratch = FfScratch(cfg.n_local[1], rho.device)
    for i in range(2):
        checks.append(_ff_check(torch, cfg, bad, E, None, f"Sod {SOD_N}^2 "
                                f"with an inf and a NaN in rho, call {i + 1}",
                                scratch))
    if int(scratch.ticket.item()) != 0:
        raise AssertionError("ff_sum left its ticket set")
    checks += _p17_odd(torch)
    return checks, states


def _p17_odd(torch):
    """(a) the card test's blocks (`P17_ODD`), positive, mixed-sign and
    with an inf and a NaN, each twice on one scratch, on the load path the
    host picks (`ff_load_path`); fails unless both paths ran."""
    import types
    import numpy as np
    from armon_torch.ops.reductions import FfScratch, ff_load_path
    checks, paths = [], set()
    rng = np.random.default_rng(18)
    for block, real, g, off in P17_ODD:
        shape = (block[1] + 2 * g, block[0] + 2 * g)
        cfg = types.SimpleNamespace(nghost=g, n_local=real)
        scratch = FfScratch(real[1], torch.device("cuda", 0))
        for kind in ("positive", "mixed", "inf_nan"):
            x = rng.random((2,) + shape) * 10.0 ** rng.integers(-3, 4, (2,) + shape)
            if kind != "positive":
                x[0] *= rng.choice([-1.0, 1.0], shape)
            x = x.astype(np.float32)
            if kind == "inf_nan":
                x[0].flat[rng.integers(x[0].size)] = np.inf
                x[0].flat[rng.integers(x[0].size)] = np.nan
            buf = torch.empty((2, x[0].size + off), device="cuda")
            rho, E = (buf[i, off:].view(shape) for i in range(2))
            rho.copy_(torch.from_numpy(x[0]))
            E.copy_(torch.from_numpy(x[1]))
            path = ff_load_path(shape[1], rho.data_ptr(), E.data_ptr())
            paths.add(path)
            for i in range(2):
                c = _ff_check(torch, cfg, rho, E, real,
                              f"{kind} {block[0]}x{block[1]} block, real "
                              f"{real[0]}x{real[1]}, {g} ghosts, base +{off}, "
                              f"{path}, call {i + 1}", scratch)
                if int(scratch.ticket.item()) != 0:
                    raise AssertionError(f"ff_sum left its ticket set: {c}")
                checks.append(c)
    if paths != {"tma", "cp_async"}:
        raise AssertionError(f"(a) took the load paths {sorted(paths)} only")
    return checks


def _p17_times(torch, states):
    """(b) K6 at each state's shape by the shared timer, and on one column
    of as many rows (the second stage nearly alone; stage 1 the
    difference), its bound (the larger of the bytes and the chain of
    nx + ny dependent adds the order keeps), the plain version on the card
    (one pass) and `torch.sum(rho) + torch.sum(rho * E)` over the same
    real cells (a byte-rate yardstick: not the same function)."""
    from armon_torch.ops import _build
    from armon_torch.ops.reductions import (FfScratch, ff_load_path,
                                            ff_sum_plain, real_slice)
    rows = {}
    for n, (cfg, rho, E) in sorted(states.items(), reverse=True):
        nx, ny = cfg.n_local
        sc = FfScratch(ny, rho.device)
        ms = time_ms(lambda i: _build.launch_ff_sum(
            cfg, rho, E, (nx, ny), sc.rows, sc.out, sc.ticket, sc.maps), k=20)
        plain_ms = time_ms(lambda i: ff_sum_plain(cfg, rho, E), k=1, passes=1)
        r = real_slice(cfg)
        rr, er = rho[r], E[r]
        sum_ms = time_ms(lambda i: torch.sum(rr) + torch.sum(rr * er), k=20)
        flat_ms, flat_by = bound(2 * nx * ny * 4 + 16,
                                 {"float32": FF_OPS_PER_CELL * nx * ny})
        adds_ms = chain_ms(nx + ny)
        b_ms, b_by = max((flat_ms, flat_by), (adds_ms, "operations"))
        # Stage 2 nearly alone: the same rows, one column each.
        one = time_ms(lambda i: _build.launch_ff_sum(
            cfg, rho, E, (1, ny), sc.rows, sc.out, sc.ticket, sc.maps), k=20)
        rows[n] = {"N": n, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                   "flat_bound_ms": flat_ms, "chain_ms": adds_ms,
                   "of_bound": b_ms / ms if ms else None,
                   "path": ff_load_path(rho.shape[1], rho.data_ptr(),
                                        E.data_ptr()),
                   "plain_ms_on_the_card": plain_ms,
                   "torch_sum_ms": sum_ms, "one_column_ms": one,
                   "stage1_ms": ms - one}
    return rows


def _p17_section(torch, count):
    """(c) `armon()` of Sod 8192^2 f32 fast math, `check_result`, `silent`
    5: the timer's `conservation_vars` section (the init check; the
    final check runs the same function, untimed), twice: the first call
    builds the conservation function and its scratch, the second finds
    them in the program cache."""
    from armon_torch import ArmonParameters, armon
    out = []
    for i in range(2):
        st, counts = count.path(
            f"(c) call {i + 1}", lambda: armon(ArmonParameters(**dict(
                SMALL_OPTS, test="Sod", N=(MAIN_N, MAIN_N),
                maxcycle=P17_CYCLES, check_result=True))), ("ff_sum",))
        if counts["ff_sum"] != 2:
            raise AssertionError(f"(c): {counts['ff_sum']} ff_sum launches")
        out.append({"conservation_vars_s":
                    st.timer["conservation_vars"]["seconds"],
                    "init_s": st.timer["init"]["seconds"],
                    "ff_sum_launches": counts["ff_sum"]})
    return out, counts["ff_sum"]


def _p17_lines(torch, count):
    """(e) the per-cycle driver's printed lines and the run's initial mass
    and energy with K6 against the same run whose sums take the plain
    version (on CPU copies): equal, character for character."""
    import contextlib
    import io
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import solver
    real = solver.conservation_values

    def on_cpu(cfg, rho, E, n_real=None, scratch=None):
        return real(cfg, rho.cpu(), E.cpu(), n_real)
    out = []
    for what, opts, cycles in P17_LINES:
        got = []
        for plain in (False, True):
            solver.conservation_values = on_cpu if plain else real
            buf = io.StringIO()
            params = ArmonParameters(**dict(SMALL_OPTS, silent=1,
                                            maxcycle=cycles, **opts))
            try:
                with contextlib.redirect_stdout(buf):
                    if plain:
                        count.quiet(lambda: armon(params))
                    else:
                        count.path(what, lambda: armon(params), ("ff_sum",))
            finally:
                solver.conservation_values = real
            lines = [x for x in buf.getvalue().splitlines()
                     if x.startswith("Cycle ")]
            got.append((lines, params.initial_mass, params.initial_energy))
        if got[0] != got[1] or len(got[0][0]) != cycles:
            raise AssertionError(f"(e) {what}: the lines with K6 differ from "
                                 f"the plain version's")
        out.append({"case": what, "lines": len(got[0][0]),
                    "last_line": got[0][0][-1], "bitwise": True})
    return out


def phase17(torch, rates):
    """The f32 conservation sums as K6 `ff_sum` (see the module doc).
    Returns its `kernels` entry and phase 17's launches by kernel."""
    from armon_torch.core.solver import clear_cache
    t0 = time.perf_counter()
    card = card_line()
    count = _Counted(torch)
    checks, states = _p17_states(torch)
    emit({"phase": 17, "card": card, "bitwise": checks})
    times = _p17_times(torch, states)
    emit({"phase": 17, "card": card, "times": times})
    del states
    clear_cache()
    section, ff_c = _p17_section(torch, count)
    emit({"phase": 17, "card": card, "conservation_vars_section": section})
    clear_cache()
    driver, _ = count.path("(d) f64", lambda: _p16_driver(torch, "float64",
                                                          (5, 1)), ())
    emit({"phase": 17, "card": card, "per_cycle_driver_f64": driver})
    clear_cache()
    emit({"phase": 17, "card": card, "lines": _p17_lines(torch, count)})
    clear_cache()
    emit({"phase": 17, "seconds": time.perf_counter() - t0})
    main = times[MAIN_N]
    launches = rates.get("main", {}).get("ff_sum_launches")
    entry = {"name": "ff_sum", "route": "cuda",
             "source": "armon_torch/csrc/reduce.cu",
             "replaces": "armon_tpu/ops/reductions.py:108",
             "launches": ff_c if launches is None else launches,
             "max_abs_err": 0.0, "ms": main["ms"],
             "plain_ms": main["plain_ms_on_the_card"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": None,
             "bound_by_size": {n: "the chain of nx + ny adds" if
                               t["chain_ms"] >= t["flat_bound_ms"] else
                               t["bound_by"] for n, t in times.items()},
             "launches_from": "phase 3" if launches is not None else
             "phase 17 (c)",
             "torch_sum_ms": main["torch_sum_ms"]}
    return entry, count.total


# ------------------------------------------------- the option-space fuzz

# The kernels phase 18 must launch: K1, K2, K3's tail, K4, K5, K6.
P18_KERNELS = ("x_sweep", "y_sweep", "cfl_tail", "cycle", "multicycle",
               "ff_sum")


def phase18(torch):
    """The option-space fuzz on the card (see the module doc). Every case
    runs, a failure is recorded with its traceback and the phase raises at
    its end, naming them all. Returns phase 18's launches by kernel."""
    import tempfile
    import traceback
    from armon_torch import fuzz
    from armon_torch.core.solver import clear_cache
    t0 = time.perf_counter()
    card = card_line()
    count = _Counted(torch)
    hits, failures = set(), []
    for name, seeds in fuzz.CARD_SMOKE.items():
        t1 = time.perf_counter()
        per_seed, launches = {}, {}
        for seed in seeds:
            case = fuzz.plan(name, seed, "card")
            try:
                with tempfile.TemporaryDirectory(prefix="armon_p18_") as tmp:
                    _, n = count.path(f"phase 18 {name} seed {seed}",
                                      lambda: fuzz.check(case, "cuda", tmp),
                                      ())
            except Exception:  # every case runs; the phase fails below
                failures.append((name, seed, traceback.format_exc()))
                print(failures[-1][2], file=sys.stderr, flush=True)
                n = {}
            finally:
                clear_cache()
            got = fuzz.case_branches(case)
            hits |= got
            per_seed[seed] = " ".join(sorted(got))
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
        emit({"phase": 18, "oracle": name, "seconds":
              time.perf_counter() - t1, "launches": launches,
              "branches": per_seed})
    missing = [b for b in fuzz.REQUIRED if b not in hits]
    idle = [k for k in P18_KERNELS if not count.total.get(k)]
    emit({"phase": 18, "card": card, "cases": sum(
        map(len, fuzz.CARD_SMOKE.values())), "failures": [
        f"{n} seed={s}" for n, s, _ in failures], "missing_branches":
        missing, "never_launched": idle, "launches": count.total,
        "seconds": time.perf_counter() - t0})
    if failures or missing or idle:
        raise AssertionError(
            f"phase 18: failures {[(n, s) for n, s, _ in failures]}, "
            f"branches not reached {missing}, kernels never launched {idle}")
    return count.total


# ------------------------------------- examples, entry points, kernel fuzz

# The kernels phase 19 must launch: K1, K2, K3's tail, K4, K5.
P19_KERNELS = ("x_sweep", "y_sweep", "cfl_tail", "cycle", "multicycle")
# The port's example scripts (`examples/`), each run at its defaults (the
# JAX script's sizes) as a subprocess: this script with `--example`.
P19_EXAMPLES = ("torch_sod_profile", "torch_sedov_animation",
                "torch_multichip")
P19_TIMEOUT = 300        # seconds an example's subprocess may take
P19_DRY_SHARDS = 4


def _example_worker(name):
    """Phase 19 (b)'s worker, in the directory the example writes into:
    `main([])` of `examples/<name>.py` with its launch counts set to 0
    just before it and its printed lines kept in memory, then every file
    it wrote read back (slices with numpy, state files and frames with the
    port's native reader); prints one JSON line."""
    import contextlib
    import importlib.util
    import io
    import json
    import re
    import numpy as np
    import torch
    from armon_torch import ArmonParameters
    from armon_torch.io import output
    from armon_torch.ops import sweep as K
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    K.reset_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        stats = module.main([])
    torch.cuda.synchronize()
    launches = {k: n for k, n in {**K.LAUNCHES, **K.TAILS}.items() if n}
    t0 = time.perf_counter()
    files, finite = {}, True
    for root, _, names in os.walk("."):
        for f in sorted(names):
            path = os.path.join(root, f)
            if f.endswith("_slice"):
                with open(path) as fh:
                    rows = np.array([line.split(",") for line in fh
                                     if line.strip()], dtype=np.float64)
                cells = len(rows)
            else:
                # the example's configuration (no device enters it)
                cfg = ArmonParameters(**{**module.DEFAULTS,
                                         "device": "cpu"}).config
                rows = np.stack(list(output.read_state_file(cfg, path)
                                     .values()))
                cells = rows[0].size
            finite &= bool(np.isfinite(rows).all())
            files[os.path.relpath(path, ".")] = cells
    mesh = re.search(r"devices: (\d+) -> mesh (\S+)", text.getvalue())
    print(json.dumps({"example": name, "cycles": stats.cycles,
                      "cells_per_s": stats.giga_cells_per_sec * 1e9,
                      "solve_s": stats.solve_time, "files": files,
                      "finite": finite, "readback_s": time.perf_counter() - t0,
                      "launches": launches,
                      "mesh": mesh.group(0) if mesh else None,
                      "printed_lines": text.getvalue().count("\n")}))
    return 0


class _Example:
    """(b): one example as a subprocess (this script with `--example`) in
    a temporary directory of its own, started at once; `result()` waits
    for it and returns its worker's line with the wall seconds from its
    start, and removes the directory."""

    def __init__(self, name):
        import subprocess
        import tempfile
        self.name = name
        self.tmp = tempfile.TemporaryDirectory(prefix="armon_p19_")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--example",
             name], cwd=self.tmp.name, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        import json
        try:
            out, err = self.proc.communicate(timeout=P19_TIMEOUT)
        except BaseException:
            self.proc.kill()
            self.proc.communicate()
            raise
        finally:
            self.tmp.cleanup()
        wall = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.name} exited {self.proc.returncode}"
                                 f": {err[-3000:]}")
        return {**json.loads(out.strip().splitlines()[-1]), "wall_s": wall}


def phase19(torch):
    """The kernel-math fuzz, the example scripts and the dry run (see the
    module doc). Every part runs; a failure is recorded with its
    traceback and the phase raises at its end, naming them all. Returns
    phase 19's launches by kernel (the examples' counted in their
    workers)."""
    import traceback
    from armon_torch import kernel_fuzz as KF
    from armon_torch.core.solver import clear_cache
    from armon_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    card = card_line()
    count = _Counted(torch)
    failures = []

    def fail(what):
        failures.append((what, traceback.format_exc()))
        print(failures[-1][1], file=sys.stderr, flush=True)

    t1 = time.perf_counter()
    for name, draws, run in KF.card_checks():
        t2 = time.perf_counter()
        try:
            worst, n = count.path(f"phase 19 {name}", lambda: run("cuda"), ())
        except Exception:  # every check runs; the phase fails below
            fail(f"(a) {name}")
            worst, n = None, {}
        emit({"phase": 19, "check": name, "draws": [list(d) for d in draws],
              "max_err": worst, "launches": n,
              "seconds": time.perf_counter() - t2})
    emit({"phase": 19, "part": "(a) kernel-math fuzz",
          "seconds": time.perf_counter() - t1})

    # The Sedov example, the longest (its frames are 350 MB of text written
    # and read back on the host), runs beside the other two, which run one
    # after the other; each line names what ran beside it.
    first = P19_EXAMPLES[1]
    beside = _Example(first)
    for name in P19_EXAMPLES[:1] + P19_EXAMPLES[2:] + (first,):
        try:
            line = beside.result() if name == first else _Example(name).result()
            line["beside"] = None if name == first else first
            if not line["finite"]:
                raise AssertionError(f"{name}: a file read back non-finite")
            for k, v in line["launches"].items():
                count.total[k] = count.total.get(k, 0) + v
            emit({"phase": 19, "card": card, **line})
        except Exception:
            fail(f"(b) {name}")

    try:
        t2 = time.perf_counter()
        dry, n = count.path("phase 19 dryrun",
                            lambda: dryrun_multichip(P19_DRY_SHARDS), ())
        emit({"phase": 19, "dryrun_multichip": dry, "launches": n,
              "seconds": time.perf_counter() - t2})
    except Exception:
        fail("(c) dryrun_multichip")
    finally:
        clear_cache()

    idle = [k for k in P19_KERNELS if not count.total.get(k)]
    emit({"phase": 19, "card": card, "failures": [w for w, _ in failures],
          "never_launched": idle, "launches": count.total,
          "seconds": time.perf_counter() - t0})
    if failures or idle:
        raise AssertionError(f"phase 19: failures {[w for w, _ in failures]}"
                             f", kernels never launched {idle}")
    return count.total


def _phase_timer(n, fn):
    """Phase `n`'s function, printing a line with its wall seconds when it
    returns or raises (the whole script has to finish in the check's time
    limit)."""
    def run(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            emit({"phase_seconds": {"phase": n,
                                    "s": round(time.perf_counter() - t, 1)}})
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                            "19",
                    help="comma-separated phases to run (default: all but "
                         "the crossovers, 5; 17 is the conservation kernel "
                         "K6, 18 the option-space fuzz, 19 the examples, "
                         "the entry points and the kernel-math fuzz)")
    ap.add_argument("--mp-worker", nargs=4, metavar=("JOB", "RANK", "PORT",
                                                     "DIR"),
                    help=argparse.SUPPRESS)  # phases 12 and 15's workers
    ap.add_argument("--example", help=argparse.SUPPRESS)  # phase 19's workers
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    if not os.path.isdir(os.path.join(HERE, "armon_torch")):
        print("chip_smoke: the armon_torch package is not next to this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if args.mp_worker:
        job, rank, port, tmp = args.mp_worker
        worker = _kc_worker if MP_JOBS[job].get("cache") else \
            _gp_worker if MP_JOBS[job].get("graphs") else _mp_worker
        return worker(job, int(rank), int(port), tmp)
    if args.example:
        return _example_worker(args.example)
    # Each phase's kept loops are dropped after it (`core/solver.
    # clear_cache`): what a phase allocates outside the program cache
    # (probes, kernel checks, peak measurements) then has the card to
    # itself.
    from armon_torch.core.solver import clear_cache
    for n in range(20):
        if f"phase{n}" in globals():
            globals()[f"phase{n}"] = _phase_timer(n, globals()[f"phase{n}"])
    t0 = time.perf_counter()
    occupancy = phase0(torch) if 0 in phases else {}
    if 1 in phases:
        phase1(torch)
        clear_cache()
    if 2 in phases:
        phase2(torch)
        clear_cache()
    kernels = phase3(torch) if 3 in phases else []
    clear_cache()
    rates = {"main": kernels.pop()} if kernels else {}
    if 4 in phases:
        k4 = phase4(torch)
        rates["small"] = k4.pop()
        # K4's entry also carries its time at 8200^2 (phase 3) and the
        # resident blocks per SM of its f32 fast-math instance (phase 0).
        k4[0]["ms_8200"] = rates.get("main", {}).get("kernel_ms", {}).get("cycle_8200")
        k4[0]["blocks_per_sm"] = occupancy.get("cycle_float32 fast=True biz=False",
                                               {}).get("blocks_per_sm")
        kernels += k4
        clear_cache()
    if 5 in phases:
        phase5(torch)
        clear_cache()
    if 7 in phases:
        kernels += phase7(torch, rates)
        clear_cache()
    if 8 in phases:
        kernels += phase8(torch)
        clear_cache()
    if 9 in phases:
        rates["op_memory"] = phase9(torch)
        clear_cache()
    if 10 in phases:
        # `launches` stays the count of the entry's own path; phase 10's
        # paths (the per-cycle driver, resumed runs) are reported per path
        # in phase 10's lines and, summed, under a key of their own.
        p10 = phase10(torch)
        for entry in kernels:
            entry["launches_phase10"] = p10.get(entry["name"], 0)
        clear_cache()
    if 11 in phases:
        phase11(torch, rates)
        clear_cache()
    if 13 in phases:
        phase13(torch)
        clear_cache()
    if 14 in phases:
        kernels += phase14(torch, rates)
        clear_cache()
    if 12 in phases:
        # Phase 12's runs over processes, summed over its workers, under
        # a key of their own, as phase 10's are.
        p12 = phase12(torch, rates)
        for entry in kernels:
            entry["launches_phase12"] = p12.get(entry["name"], 0)
        clear_cache()
    if 15 in phases:
        # Phase 15's runs over NCCL processes, summed over its workers.
        p15 = phase15(torch, rates)
        for entry in kernels:
            entry["launches_phase15"] = p15.get(entry["name"], 0)
        clear_cache()
    if 16 in phases:
        # Phase 16's kept loops, (d)'s workers included.
        p16 = phase16(torch)
        for entry in kernels:
            entry["launches_phase16"] = p16.get(entry["name"], 0)
        clear_cache()
    if 17 in phases:
        # K6: its entry, then every entry's launches in phase 17's paths.
        entry, p17 = phase17(torch, rates)
        entry["launches_phase16"] = p16.get("ff_sum", 0) if 16 in phases else 0
        kernels.append(entry)
        for entry in kernels:
            entry["launches_phase17"] = p17.get(entry["name"], 0)
        clear_cache()
    if 18 in phases:
        # The option-space fuzz's cases, each counted as a path.
        p18 = phase18(torch)
        for entry in kernels:
            entry["launches_phase18"] = p18.get(entry["name"], 0)
        clear_cache()
    if 19 in phases:
        # The kernel-math fuzz, the examples (counted in their workers) and
        # the dry run.
        p19 = phase19(torch)
        for entry in kernels:
            entry["launches_phase19"] = p19.get(entry["name"], 0)
        clear_cache()
    if 6 in phases and kernels:
        print(card_line())
        emit({"kernels": kernels})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
