"""The paper's contribution in PyTorch: congestion-aware joint partition
placement and routing for partitioned DNN inference over multi-hop edge
networks (counterpart of `repro.core`)."""
from .structs import (  # noqa: F401
    BIG,
    BIG_THRESHOLD,
    Apps,
    CostModel,
    HopBoundCache,
    Network,
    Problem,
    State,
    app_live_mask,
    forwarding_mass,
    hop_bound_cache,
    infer_hop_bound,
    one_hot,
    partition_live_mask,
    stage_live_mask,
    stage_targets,
    with_hop_bound,
)
from .flow import (  # noqa: F401
    SOLVERS,
    loads,
    objective,
    objective_from_loads,
    stage_solve,
    stage_traffic,
    total_absorbed,
)
from .forwarding import forwarding_sweep, forwarding_update  # noqa: F401
from .marginals import cost_to_go, link_marginals, round_eval  # noqa: F401
from .placement import (  # noqa: F401
    blocked_placement_update,
    blocked_sweep_cert,
    placement_update,
    repair_phi,
    repair_placement,
    structured_init,
    zero_load_dp,
)
from .engine import (  # noqa: F401
    EngineCarry,
    EngineTrace,
    engine_solve,
    engine_solve_single,
    placement_churn,
    round_step,
    stack_single,
)
from .alt import (  # noqa: F401
    ALL_METHODS,
    METHOD_KWARGS,
    Result,
    compare_all,
    linearize,
    method_kwargs,
    solve_alt,
    solve_colocated,
    solve_congunaware,
    solve_oneshot,
    validate_solver_kwargs,
)
from .scenarios import (  # noqa: F401
    SCENARIOS,
    build_network,
    gen_apps,
    geant,
    iot,
    mesh,
    random_connected,
    smallworld,
    stage_profile,
)
