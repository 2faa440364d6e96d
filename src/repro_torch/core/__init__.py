"""repro_torch.core — the LB4OMP chunk calculus, registry, metrics and the
host kernel-tile planner, ported from ``src/repro/core`` (NumPy, no JAX).

Only what the port has is exported; the simulators, the batch and graph
campaign engines and the auto-selector wait for later slices (ROADMAP.md).
"""

from .schedule import (  # noqa: F401
    LB_SCHEDULE_ENV,
    REGISTRY,
    GraphForm,
    ScheduleSpec,
    TechniqueRegistry,
    TechniqueSpec,
    register_technique,
    resolve,
)
from .techniques import (  # noqa: F401
    TECHNIQUES,
    ADAPTIVE_TECHNIQUES,
    NONADAPTIVE_TECHNIQUES,
    PROFILING_TECHNIQUES,
    PAPER_LB4OMP_SET,
    ChunkGrant,
    Technique,
    make_technique,
)
from .stealing import (  # noqa: F401
    STEAL_TECHNIQUES,
    StealGrant,
)
from .metrics import (  # noqa: F401
    LoopInstanceRecord,
    LoopRecorder,
    cov,
    percent_imbalance,
)
from .planner import Plan, PlannedChunk, plan_schedule, replan  # noqa: F401
from . import torch_sched  # noqa: F401
from .torch_sched import KernelTilePlan, plan_tiles_for_kernel  # noqa: F401
