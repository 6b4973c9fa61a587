// K8 with a context: the select kernel's emit mode (forward_select.cuh)
// for the coupled game's stage cost, in both Jacobian modes: the select on
// the group kernel, the re-roll, and K3's context mode at the emitted
// trajectory (the context a constant of the derivatives).  Apart from
// forward_select_emit.cu so that nvcc builds the two in parallel.
#include "forward_select.cuh"

using CoupledTrack = mas::Coupled<mas::CircularTrack, mas::GaussianCollision>;
MAS_FORWARD_SELECT_EMIT(single_track__coupled_circular_track_gaussian_collision__zero,
                        mas::SingleTrack, CoupledTrack, mas::ZeroTerminal, NoConstraint,
                        NoConstraint)
