"""File output, compare-mode files and restart snapshots
(`armon_tpu/io/`): numpy and the native library, no JAX."""

from .output import (
    write_state_file, read_state_file, read_reference_csv,
    compare_states, count_differences, saved_vars_arrays,
)
