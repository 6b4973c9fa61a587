// K3 for the model zoo: the pendulum swing-up's linearization with
// Hessians (the fused loop's general branch: its stage cost reads the stage
// index, which K3 hands it as the float JAX builds), and the Hessian hoist
// (K3's hoist mode) of the stationary quadratic costs of the rocket
// (DiagQuadratic<3, 1>), the dynamic bicycle (DiagQuadratic<6, 2>) and the
// quadrotors (DiagQuadratic<12, 4>, DiagQuadratic<16, 4>: past
// HESSIAN_FULL_MAX directions, one column a pass).  The macros are
// linearize.cu's; compiled apart from it so that nvcc builds the two in
// parallel.
#include "linearize_modes.cuh"

MAS_LINEARIZE(pendulum__pendulum_swing_up, mas::Pendulum, mas::PendulumSwingUp)
using RocketCost = mas::DiagQuadratic<3, 1>;
MAS_LINEARIZE_HESSIANS(rocket__diag_quadratic, mas::Rocket, RocketCost)
using BicycleCost = mas::DiagQuadratic<6, 2>;
MAS_LINEARIZE_HESSIANS(dynamic_bicycle__diag_quadratic, mas::DynamicBicycle, BicycleCost)
using QuadCost = mas::DiagQuadratic<12, 4>;
MAS_LINEARIZE_HESSIANS(quadrotor__diag_quadratic, mas::Quadrotor, QuadCost)
using RotorCost = mas::DiagQuadratic<16, 4>;
MAS_LINEARIZE_HESSIANS(quadrotor_rotor__diag_quadratic, mas::QuadrotorRotor, RotorCost)
