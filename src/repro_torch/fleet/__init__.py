"""Fleet engine: batched ALT solving over padded heterogeneous ensembles
(the JAX package's `repro.fleet`, on PyTorch).

pad.py pads instances to a common (V, A, P) envelope with validity masks
and stacks them; solve.py hands the stack to the round engine
(core/engine.py) in chunks and gathers a traced `FleetResult`;
generator.py samples reproducible scenario fleets.
"""
from .pad import (  # noqa: F401
    NU_PAD,
    EmptyFleetError,
    PadInfo,
    fleet_envelope,
    fleet_part_envelope,
    pad_apps,
    pad_batch_to_multiple,
    pad_network,
    pad_problem,
    pad_problem_parts,
    stack_problems,
    unify_hop_bound,
)
from ..obs.roundtrace import FleetTrace  # noqa: F401
from .solve import (  # noqa: F401
    METHODS,
    FleetResult,
    ShardPlan,
    envelope_cap_chunk,
    solve_fleet,
    solve_sequential,
)
from .generator import (  # noqa: F401
    FAMILIES,
    barabasi_albert,
    erdos_renyi,
    eta_grid,
    iot_hierarchy,
    load_grid,
    perturbed_geant,
    sample_fleet,
)
