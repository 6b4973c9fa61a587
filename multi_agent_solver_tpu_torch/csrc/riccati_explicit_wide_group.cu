// K4's group kernel (riccati.cuh: riccati_backward_group_kernel) in the
// explicit-terminal mode at (NX, NU) = (8, 4), clamp and boxqp: the launches
// that riccati_explicit_wide.cu's entry point makes below the group kernel's
// crossover.  Their 81-configuration box QP is as heavy to compile as the
// one-thread kernel's, so they get a source of their own and nvcc builds
// the two in parallel.
#include "riccati.cuh"

MAS_BACKWARD_GROUP(template, mas::GivenValue, 8, 4, true, false);
MAS_BACKWARD_GROUP(template, mas::GivenValue, 8, 4, false, false);
