// K6 in AL and context mode at once: the select kernel's instantiations for
// a constrained agent of a coupled game (kernel and launcher in
// forward_select.cuh).  Each candidate's step is the coupled stage cost --
// the circular track plus the collision pair costs against the context --
// plus the AL terms of the constraint rows at its (x_t, u_t).  Compiled
// apart from forward_select_al.cu so that nvcc builds the two in parallel.
#include "forward_select.cuh"

// The constrained game's speed cap (entry.SPEED_CAP: one inequality row,
// no equality side), and one bound row on each side.
using CoupledTrack = mas::Coupled<mas::CircularTrack, mas::GaussianCollision>;
using Rows1 = mas::BoundRows<1>;
using mas::NoConstraint;
MAS_FORWARD_SELECT(single_track__coupled_circular_track_gaussian_collision__zero__none__bound_rows1,
                   mas::SingleTrack, CoupledTrack, mas::ZeroTerminal, NoConstraint, Rows1)
MAS_FORWARD_SELECT(
    single_track__coupled_circular_track_gaussian_collision__zero__bound_rows1__bound_rows1,
    mas::SingleTrack, CoupledTrack, mas::ZeroTerminal, Rows1, Rows1)
