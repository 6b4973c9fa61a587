"""Multi-agent strategies (the ``sequential`` Nash strategy is ported so far)."""

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
from .nash import SequentialNashStrategy, make_coupled_stage

__all__ = [
    "agents_are_homogeneous", "available_strategy_names", "canonical_strategy_name",
    "collect_solution", "make_strategy", "scatter_stacked_results", "solve",
    "stack_agent_specs", "SequentialNashStrategy", "make_coupled_stage",
]
