"""Centralized strategy: solve the joint OCP, structure-aware.

Counterpart of ``multi_agent_solver_tpu/strategies/centralized.py``:
compute offsets, build the global OCP, run the (pre-parameterized) solver
on it, and scatter the block rows back into each agent's result.

**Structure-aware dispatch.**  When the agents are homogeneous and there is
no inter-agent coupling, the joint OCP is exactly block-diagonal: its
optimum is the concatenation of the per-agent optima.  The solve then
dispatches to the solver's batched per-agent path (agents as batch lanes:
the fused loop's kernels on the card), which reaches the same optimum in
O(N) work where the joint Riccati recursion costs O((N nx)^3) a stage.
``structure_aware=False`` forces the literal joint solve, whose untagged
joint functions run ``solve(ocp)``'s torch loop.

The reference's bound-merge rule (input bounds dropped unless every agent
has them) cannot diverge under the dispatch: agents where only some have
bounds differ in their statics, are not homogeneous, and take the joint
path.
"""

from __future__ import annotations

from ..multi_agent import MultiAgentProblem
from ..solution import Solution
from ..solvers.base import SolverBase
from .base import (
    agents_are_homogeneous,
    collect_solution,
    register_strategy,
    scatter_stacked_results,
    stack_agent_specs,
)


@register_strategy
class CentralizedStrategy:
    """Holds a solver whose params were set before construction."""

    name = "centralized"

    def __init__(self, solver: SolverBase, structure_aware: bool = True):
        self.solver = solver
        self.structure_aware = structure_aware

    def __call__(self, problem: MultiAgentProblem) -> Solution:
        problem.compute_offsets()
        if (self.structure_aware and problem.inter_agent_cost is None
                and len(problem.blocks) > 1 and agents_are_homogeneous(problem)):
            specs = stack_agent_specs(problem, self.solver.device)
            results = self.solver._solve_batched_fn(specs, self.solver.config)
            scatter_stacked_results(problem, results.states, results.controls, results.cost)
            return collect_solution(problem)

        global_ocp = problem.build_global_ocp()
        self.solver.solve(global_ocp)
        problem.scatter_global_result(global_ocp)
        return collect_solution(problem)
