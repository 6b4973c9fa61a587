// K8 with AL multipliers: the select kernel's emit mode (forward_select.cuh)
// for the lane-follow cost with the constraint rows that
// forward_select_al.cu instantiates for K6's AL mode -- one inequality row
// (a speed cap), the four state-bound rows, one equality row, and the
// equality row with the four inequality rows.  forward_emit_one_thread_kernel
// adds the AL terms to each candidate's stage cost in its select; the
// re-roll and the linearization take no AL (the emitted cost is the
// un-augmented stage cost).  Apart from forward_select_emit.cu
// so that nvcc builds the two in parallel.
#include "forward_select.cuh"

using Rows1 = mas::BoundRows<1>;
using Rows4 = mas::BoundRows<4>;
MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero__none__bound_rows1, mas::SingleTrack,
                        LaneFollowCost, mas::ZeroTerminal, NoConstraint, Rows1)
MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero__none__bound_rows4, mas::SingleTrack,
                        LaneFollowCost, mas::ZeroTerminal, NoConstraint, Rows4)
MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero__bound_rows1__none, mas::SingleTrack,
                        LaneFollowCost, mas::ZeroTerminal, Rows1, NoConstraint)
MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero__bound_rows1__bound_rows4,
                        mas::SingleTrack, LaneFollowCost, mas::ZeroTerminal, Rows1, Rows4)
