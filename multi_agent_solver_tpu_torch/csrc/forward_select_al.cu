// K6's AL mode: the select kernel's instantiations with constraint rows
// (kernel and launcher in forward_select.cuh).
#include "forward_select.cuh"

// The AL mode (K6) for the lane-follow cost: one inequality row (a speed
// cap), the four state-bound rows of entry.state_bound_specs, one equality
// row (entry.equality_specs), and one equality row with the four
// inequality rows.
using Rows1 = mas::BoundRows<1>;
using Rows4 = mas::BoundRows<4>;
MAS_FORWARD_SELECT(single_track__diag_quadratic__zero__none__bound_rows1, mas::SingleTrack,
                   LaneFollowCost, mas::ZeroTerminal, NoConstraint, Rows1)
MAS_FORWARD_SELECT(single_track__diag_quadratic__zero__none__bound_rows4, mas::SingleTrack,
                   LaneFollowCost, mas::ZeroTerminal, NoConstraint, Rows4)
MAS_FORWARD_SELECT(single_track__diag_quadratic__zero__bound_rows1__none, mas::SingleTrack,
                   LaneFollowCost, mas::ZeroTerminal, Rows1, NoConstraint)
MAS_FORWARD_SELECT(single_track__diag_quadratic__zero__bound_rows1__bound_rows4,
                   mas::SingleTrack, LaneFollowCost, mas::ZeroTerminal, Rows1, Rows4)
