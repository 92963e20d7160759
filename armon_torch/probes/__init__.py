"""Card probes: the measurement scripts of `scripts/` that ran their own
TPU kernels, as entry points of the port with hand-written CUDA kernels.

- `flip` (`scripts/probe_flip.py`): the X mirror fill against a copy;
- `ff` (`scripts/ff_probe.py`): the sweep chain in f32, f64 and
  float-float, speed and accuracy;
- `roofline_io` (`scripts/roofline_io.py`): the sweep's I/O shape (read
  4, write 5 in place) with graded math;
- `roofline` (`scripts/roofline.py`): the operation census of the sweep,
  per-class operation rates, and the floors they give;
- `cycle_variants` (`scripts/perf_probe.py`): K4 with parts taken out.

Each runs on the card by default (``python -m armon_torch.probes.<name>``)
and raises without one unless given ``--device cpu``, where it runs the
kernels' plain PyTorch versions and reports every time as "not measured".
"""

# Launches of each probe kernel on the card, counted by its wrapper where
# it launches, and nowhere else.
LAUNCHES = {}


def count(name):
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches():
    LAUNCHES.clear()
