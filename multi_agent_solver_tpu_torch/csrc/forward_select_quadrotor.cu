// K2 (the rollout and the select) for the quadrotors' hover regulation
// (models/quadrotor.py and models/quadrotor_rotor.py: DiagQuadratic<NX, 4>
// and DiagQuadraticTerminal<NX> at NX = 12 and 16).  Compiled apart from
// forward_select.cu, so that nvcc builds them in parallel.
#include "forward_select.cuh"

using QuadCost = mas::DiagQuadratic<12, 4>;
using QuadTerm = mas::DiagQuadraticTerminal<12>;
MAS_FORWARD_SELECT(quadrotor__diag_quadratic__diag_quadratic_terminal, mas::Quadrotor, QuadCost,
                   QuadTerm, NoConstraint, NoConstraint)
using RotorCost = mas::DiagQuadratic<16, 4>;
using RotorTerm = mas::DiagQuadraticTerminal<16>;
MAS_FORWARD_SELECT(quadrotor_rotor__diag_quadratic__diag_quadratic_terminal, mas::QuadrotorRotor,
                   RotorCost, RotorTerm, NoConstraint, NoConstraint)
