"""Multi-agent strategies: centralized, and the sequential, line-search and
trust-region Nash strategies."""

from .base import (
    agents_are_homogeneous,
    available_strategy_names,
    canonical_strategy_name,
    collect_solution,
    make_strategy,
    scatter_stacked_results,
    solve,
    stack_agent_specs,
)
from .centralized import CentralizedStrategy
from .hetero import paddable, scatter_padded_results, stack_agent_specs_padded
from .nash import (
    LineSearchNashStrategy,
    SequentialNashStrategy,
    TrustRegionNashStrategy,
    make_coupled_stage,
)

__all__ = [
    "agents_are_homogeneous", "available_strategy_names", "canonical_strategy_name",
    "collect_solution", "make_strategy", "scatter_stacked_results", "solve",
    "stack_agent_specs", "CentralizedStrategy", "SequentialNashStrategy",
    "LineSearchNashStrategy", "TrustRegionNashStrategy", "make_coupled_stage", "paddable",
    "scatter_padded_results", "stack_agent_specs_padded",
]
