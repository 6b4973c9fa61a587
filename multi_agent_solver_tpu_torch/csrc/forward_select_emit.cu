// K8: the select kernel's emit mode (forward_select.cuh, EMIT) for the
// main path's lane-follow cost, in both Jacobian modes: the select plus the
// linearization at the accepted trajectory.  No solve path launches it (the
// JAX package measured it slower than a separate linearize launch).  Its own
// translation unit, so that nvcc builds it beside the other modes.
#include "forward_select.cuh"

using LaneFollowCost = mas::DiagQuadratic<4, 2>;
MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollowCost,
                        mas::ZeroTerminal)
