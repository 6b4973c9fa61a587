// K2 for the LQR (models/lqr.py: Linear<4, 4>, Quadratic<4, 4>,
// QuadraticTerminal<4>, the size of examples/multi_agent_lqr.py): the
// rollout and the select of the fused loop, and the non-fused path's
// batch-first select.  Compiled apart from forward_select.cu, so that nvcc
// builds the two in parallel.
#include "forward_select.cuh"

using Linear44 = mas::Linear<4, 4>;
using Quadratic44 = mas::Quadratic<4, 4>;
MAS_FORWARD_SELECT(linear_4x4__quadratic__quadratic_terminal, Linear44, Quadratic44,
                   mas::QuadraticTerminal<4>, NoConstraint, NoConstraint)
