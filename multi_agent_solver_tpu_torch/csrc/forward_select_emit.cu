// K8: the select kernel's emit mode (forward_select.cuh, the emit mode) for
// the main path's lane-follow cost, in both Jacobian modes: one kernel,
// forward_emit_one_thread_kernel, a thread a problem -- the select with the
// candidates in registers, the re-roll at the kept alpha, and each stage
// linearized by K3's device code (linearize.cuh) as the re-roll reaches
// it.  No solve path launches it (the JAX package
// measured it slower than a separate linearize launch).  Its own
// translation unit, so that nvcc builds it beside the other modes.
#include "forward_select.cuh"

MAS_FORWARD_SELECT_EMIT(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollowCost,
                        mas::ZeroTerminal, NoConstraint, NoConstraint)
