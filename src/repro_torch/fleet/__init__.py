from .pad import stack_problems, unify_hop_bound  # noqa: F401
