// K2 and K6's context mode: the select kernel's instantiations without
// constraints.  The kernel, its launcher and the C entry-point macro are in
// forward_select.cuh; the AL instantiations (K6's AL mode) are compiled
// apart in forward_select_al.cu, so that nvcc builds the two in parallel.
#include "forward_select.cuh"

MAS_FORWARD_SELECT(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollowCost,
                   mas::ZeroTerminal, NoConstraint, NoConstraint)
MAS_FORWARD_SELECT(single_track__circular_track__zero, mas::SingleTrack, mas::CircularTrack,
                   mas::ZeroTerminal, NoConstraint, NoConstraint)
using CoupledTrack = mas::Coupled<mas::CircularTrack, mas::GaussianCollision>;
MAS_FORWARD_SELECT(single_track__coupled_circular_track_gaussian_collision__zero,
                   mas::SingleTrack, CoupledTrack, mas::ZeroTerminal, NoConstraint, NoConstraint)
// The cart-pole swing-up (models/cartpole.py): the general cost branch's
// rollout and select, and the non-fused path's batch-first select.
MAS_FORWARD_SELECT(cartpole__cartpole_swing_up__cartpole_swing_up_terminal, mas::Cartpole,
                   mas::CartpoleSwingUp, mas::CartpoleSwingUpTerminal, NoConstraint,
                   NoConstraint)
