"""Scenario trials: repeated seeded runs + fault injection + statistics.

The proving ground for cluster-scale claims: declarative
:class:`Scenario` specs (traffic x fault x elasticity programs), a
deterministic executor producing frozen :class:`TrialResult` cells, and
a statistics layer (bootstrap CIs, latency percentiles, tolerance-band
gates) that turns N seeded trials into the confidence-interval reports
the paper's methodology calls for.  The reference's
``benchmarks/trial_bench.py`` is the suite of record.

A copy of ``src/repro/trials`` for the PyTorch port (NumPy; the reference
package loads JAX through ``repro.core``).
"""

from .executor import TrialResult, run_cell, run_suite, run_trial  # noqa: F401
from .scenario import (  # noqa: F401
    Scenario,
    elastic_program,
    failure_program,
    load_trace,
    requests_from_trace,
    save_trace,
    standard_suite,
    thermal_program,
    trace_from_requests,
)
from .statistics import (  # noqa: F401
    ToleranceBand,
    bootstrap_ci,
    check_gates,
    ci_nonoverlap,
    compare_cells,
    latency_percentiles,
    summarize_cell,
)
