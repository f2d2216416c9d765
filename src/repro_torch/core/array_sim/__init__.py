"""Batched buffer-pool simulator of the port (lane axis explicit).

Re-implements ``repro.core.array_sim`` of the JAX package on PyTorch
tensors: ``compile_workload`` lowers a multi-stream scan workload to a
``SimSpec``, ``make_runner`` steps every (policy x buffer size) lane of a
sweep at once — LRU, PBM, OPT and array-CScan (the cooperative
substrate, ``coop``) in one batched call — with the fixed-``dt`` or the
event-horizon time engine until all streams finish, and
``result_from_state`` / ``run_sweep`` turn the final state into the
paper's metrics (with ``telemetry=True``, also the carried counters of
``repro_torch.obs``); ``validate`` holds a run to the port's event engine
inside the JAX package's error bars.  Eviction, the I/O server's
grant and the wake solve run as hand-written CUDA kernels on the card
(``repro_torch.kernels``) and as their plain PyTorch versions on CPU
tensors.
"""

from .spec import SimSpec, build_spec
from .compiler import compile_workload, referenced_tables
from .convert import (
    carry_from_numpy,
    carry_to_numpy,
    resolve_device,
    spec_to_torch,
    state_from_numpy,
    state_to_numpy,
)
from .dist import close_mesh, init_mesh
from .mesh import Mesh
from .sim import (
    ArrayResult,
    ArraySimConfig,
    SimState,
    init_state,
    make_config,
    make_runner,
    make_step,
    resolve_policies,
    result_from_state,
    run_sweep,
    run_workload_array,
    stack_configs,
)
from .policies import (
    ArrayCScan,
    ArrayLRU,
    ArrayOPT,
    ArrayPBM,
    ArrayPolicy,
    HorizonView,
    StepCtx,
    next_consumption,
    shift_timeline,
    target_buckets,
    time_to_bucket,
)

from .validate import (
    DEFAULT_FRACS,
    ERROR_BARS,
    TPCH_ERROR_BARS,
    cross_validate,
    cross_validate_sweep,
    cross_validate_tpch,
    cross_validate_tpch_sweep,
)

__all__ = [
    "Mesh",
    "close_mesh",
    "init_mesh",
    "ArrayCScan",
    "ArrayLRU",
    "ArrayOPT",
    "ArrayPBM",
    "ArrayPolicy",
    "ArrayResult",
    "DEFAULT_FRACS",
    "ERROR_BARS",
    "ArraySimConfig",
    "HorizonView",
    "SimSpec",
    "SimState",
    "StepCtx",
    "TPCH_ERROR_BARS",
    "build_spec",
    "carry_from_numpy",
    "carry_to_numpy",
    "compile_workload",
    "cross_validate",
    "cross_validate_sweep",
    "cross_validate_tpch",
    "cross_validate_tpch_sweep",
    "init_state",
    "make_config",
    "make_runner",
    "make_step",
    "next_consumption",
    "referenced_tables",
    "resolve_device",
    "resolve_policies",
    "result_from_state",
    "run_sweep",
    "run_workload_array",
    "shift_timeline",
    "spec_to_torch",
    "stack_configs",
    "state_from_numpy",
    "state_to_numpy",
    "target_buckets",
    "time_to_bucket",
]
