// K3's, K3's hoist mode's and K7's entry points for the single track, the
// cart-pole and the LQR; the kernels, launchers and macros are in
// linearize_modes.cuh (the model zoo's are in linearize_zoo.cu).
#include "linearize_modes.cuh"

using LaneFollowCost = mas::DiagQuadratic<4, 2>;
MAS_LINEARIZE(single_track__diag_quadratic, mas::SingleTrack, LaneFollowCost)
MAS_LINEARIZE(single_track__circular_track, mas::SingleTrack, mas::CircularTrack)
using CoupledTrack = mas::Coupled<mas::CircularTrack, mas::GaussianCollision>;
MAS_LINEARIZE(single_track__coupled_circular_track_gaussian_collision, mas::SingleTrack,
              CoupledTrack)
MAS_LINEARIZE_HESSIANS(single_track__diag_quadratic, mas::SingleTrack, LaneFollowCost)
MAS_LINEARIZE_HESSIANS(single_track__circular_track, mas::SingleTrack, mas::CircularTrack)
MAS_LINEARIZE_FLAT(single_track__diag_quadratic, mas::SingleTrack, LaneFollowCost)
MAS_LINEARIZE_FLAT(single_track__circular_track, mas::SingleTrack, mas::CircularTrack)
MAS_LINEARIZE(cartpole__cartpole_swing_up, mas::Cartpole, mas::CartpoleSwingUp)
MAS_LINEARIZE_HESSIANS(cartpole__cartpole_swing_up, mas::Cartpole, mas::CartpoleSwingUp)
MAS_LINEARIZE_FLAT(cartpole__cartpole_swing_up, mas::Cartpole, mas::CartpoleSwingUp)
// The LQR's hoist (models/lqr.py, the size of examples/multi_agent_lqr.py):
// its cost is quadratic and stationary, so the fused loop runs K1, and K3
// only in its hoist mode.
using Linear44 = mas::Linear<4, 4>;
using Quadratic44 = mas::Quadratic<4, 4>;
MAS_LINEARIZE_HESSIANS(linear_4x4__quadratic, Linear44, Quadratic44)
