"""repro_torch.core — the paper's contribution, ported from
``src/repro/core`` without JAX: LB4OMP's dynamic loop self-scheduling
portfolio, measurement features, the shared-queue simulator and the batch
campaign engine (NumPy copies), the closed forms and kernel-tile planner
(``torch_sched``), the torch campaign engine (``graph_sim``, on the card
unless the caller passes ``device="cpu"``) and the auto-selector.
"""

from .schedule import (  # noqa: F401
    LB_SCHEDULE_ENV,
    REGISTRY,
    GraphForm,
    ScheduleSpec,
    TechniqueRegistry,
    TechniqueSpec,
    bind_graph_form,
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
from .workloads import (  # noqa: F401
    frontloaded_like,
    DIST_LOOPS,
    STREAM_LOOPS,
    Workload,
    dist_loop,
    gromacs_like,
    make_workload,
    nab_like,
    sphynx_like,
    stream_loop,
)
from .simulator import (  # noqa: F401
    EXACT_PROFILE,
    NOISY_PROFILE,
    OverheadModel,
    ProfileModel,
    SimResult,
    best_combination,
    profile_workload,
    simulate,
)
from .planner import Plan, PlannedChunk, plan_schedule, replan  # noqa: F401
from .batch_sim import BatchConfig, batch_grid, simulate_batch  # noqa: F401
from . import torch_sched  # noqa: F401
from .torch_sched import KernelTilePlan, plan_tiles_for_kernel  # noqa: F401
from . import graph_sim  # noqa: F401  (binds the campaign graph forms)
from .graph_sim import simulate_batch_graph  # noqa: F401
from .auto import AutoSelector, auto_simulate, registry_candidates  # noqa: F401
