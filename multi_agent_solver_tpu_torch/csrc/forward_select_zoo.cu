// K2 (the rollout and the select) for the model zoo: the pendulum swing-up
// (Pendulum, PendulumSwingUp -- a stage cost that reads the stage index --,
// PendulumSwingUpTerminal), the rocket (Rocket, DiagQuadratic<3, 1>,
// RocketTerminal) and the dynamic bicycle's lane change (DynamicBicycle,
// DiagQuadratic<6, 2>, ZeroTerminal): the fused loop's rollout and select,
// and the non-fused path's batch-first ones.  The quadrotors' are in
// forward_select_quadrotor.cu.  Compiled apart from forward_select.cu, so
// that nvcc builds them in parallel.
#include "forward_select.cuh"

MAS_FORWARD_SELECT(pendulum__pendulum_swing_up__pendulum_swing_up_terminal, mas::Pendulum,
                   mas::PendulumSwingUp, mas::PendulumSwingUpTerminal, NoConstraint,
                   NoConstraint)
using RocketCost = mas::DiagQuadratic<3, 1>;
MAS_FORWARD_SELECT(rocket__diag_quadratic__rocket_terminal, mas::Rocket, RocketCost,
                   mas::RocketTerminal, NoConstraint, NoConstraint)
using BicycleCost = mas::DiagQuadratic<6, 2>;
MAS_FORWARD_SELECT(dynamic_bicycle__diag_quadratic__zero, mas::DynamicBicycle, BicycleCost,
                   mas::ZeroTerminal, NoConstraint, NoConstraint)
