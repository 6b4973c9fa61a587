"""Example problems (counterparts of ``multi_agent_solver_tpu/examples``)."""
