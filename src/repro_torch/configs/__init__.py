from .registry import ARCHS, ZOO, get_config, reduced_config  # noqa: F401
