"""Process-runtime tuning for the manager.

The port's copy of kueue_tpu/utils/runtime.py's `tune_gc`. The reference
is a Go binary whose concurrent GC never stops the world for more than
fractions of a millisecond; CPython's generational GC, by contrast, runs
a full stop-the-world gen-2 scan of every tracked container each time
the gen-2 counter trips. A control plane holds hundreds of thousands of
long-lived objects (cached Workloads, CQ state, queue heaps), so with
the default thresholds (700, 10, 10) a busy admission cycle allocates
enough temporaries to trigger multiple full collections per cycle, each
one scanning the whole (growing) object store for seconds at scale.

tune_gc() keeps young-generation collection (cheap, catches cycles in
temporaries) but makes full collections ~100x rarer. Library code never
mutates global GC state on import.

The JAX package's `enable_compilation_cache` (XLA's persistent cache of
compiled programs) has no counterpart: the port's kernels are built
once from `solver/csrc` into `solver/_build/` (solver/_build.py), and a
solver on the card has nothing to compile per shape.
"""

from __future__ import annotations

import gc

# (gen0 allocations, gen0-per-gen1, gen1-per-gen2); defaults are (700, 10, 10).
SCHEDULER_GC_THRESHOLDS = (50000, 25, 100)


def tune_gc(thresholds: tuple = SCHEDULER_GC_THRESHOLDS) -> tuple:
    """Apply scheduler-friendly GC thresholds; returns the previous ones."""
    prev = gc.get_threshold()
    gc.set_threshold(*thresholds)
    return prev
