"""K9: the first-generation all-alpha forward pass, and the router's check
of which problems the lane kernels take.

Port of ``multi_agent_solver_tpu/ops/forward_pallas.py``:

* :func:`spec_supports_lane_forward` -- the JAX router's check of the same
  name: do the select and linearize kernels take the problem's functions,
  its constraints and its context?  (``solvers/ilqr.py::route``);
* :func:`forward_pass_pallas` -- ``forward_pass_pallas`` (kernel
  ``_forward_lanes``): every candidate alpha of every problem rolled out
  with ``u = clamp(u_ref + alpha k + K (x - x_ref))`` and RK4 (the clamp
  only when the spec has input bounds), each candidate's stage costs at
  the integer stage index summed with the terminal cost.  ``xs [B, T+1,
  nx]``, ``us [B, T, nu]``, ``k [B, T, nu]``, ``K [B, T, nu, nx]`` of any
  float dtype and ``alphas [A]`` in; float32 ``xs_cand [B, A, T+1, nx]``
  (``x_0`` first), ``us_cand [B, A, T, nu]`` and ``costs [B, A]`` out;
* :func:`rollout_pallas` -- ``rollout_pallas``: the plain rollout through
  the same kernel, alpha 0, zero gains, no clamp: ``xs [B, T+1, nx]``,
  ``costs [B]``.

The CUDA kernel (``csrc/forward_pass.cu``) runs a block of 32 neighbouring
problems by the candidates (up to 32 a block; a thread runs one candidate,
or two where their count is even), so the candidates of a problem read its
reference together and device memory serves it once, where the TPU kernel
replicated every per-problem array across the candidates.
No solve path calls it, as in the JAX package (the select kernel, K2,
replaced it); its launches are counted on ``STATS``.  For CPU tensors the
functions run the plain version, for CUDA tensors the kernel, whose
instantiation is named by the spec's device-function tags (an untagged
callable raises ``NotImplementedError``).
"""

from __future__ import annotations

import torch

from ..integrators import integrate_rk4
from ..types import Tensor, device_fn_of
from ._build import KernelStats, check_tensor, launch, problem_symbol, stage_major, step_constants

STATS = KernelStats()

# The JAX router refuses a per-stage context of more than 512 floats a stage
# (ops/forward_pallas.py:76-83 of the JAX package: a context tile of
# elems x 1024 lanes x 4 bytes must stay within 2 MiB of the TPU's VMEM);
# such a solve takes its non-fused path.  The port's router is JAX's, so it
# keeps the bound, although nothing on the H100 needs it.
MAX_CONTEXT_FLOATS = 2 * 1024 * 1024 // (1024 * 4)
# At most this many rows a constraint side (the JAX router's bound).
MAX_CONSTRAINT_ROWS = 8


def constraints_batched(specs) -> bool:
    """Do the constraint callables give ``[..., m]`` (or a constant ``[m]``)
    on batched values ``x [2, nx]``, ``u [2, nu]``?  The counterpart of the
    JAX router's ``_lane_constraints_traceable``."""
    x = torch.zeros((2, specs.state_dim), dtype=torch.float32,
                    device=specs.initial_state.device)
    u = torch.zeros((2, specs.control_dim), dtype=torch.float32, device=x.device)
    for fn, m in ((specs.equality_constraints, specs.eq_dim),
                  (specs.inequality_constraints, specs.ineq_dim)):
        if m == 0:
            continue
        try:
            shape = tuple(fn(x, u).shape)
        except Exception:
            return False
        if shape not in ((2, m), (m,)):
            return False
    return True


def kernels_take(specs, device: torch.device) -> bool:
    """Do the select and linearize kernels take the problem's dynamics and
    costs (the JAX router's ``_lane_cost_traceable`` and the lane tracing of
    :func:`spec_supports_lane_forward`)?  On the CPU any torch callable (the
    plain versions run it); on the card callables with a ``DeviceFn`` tag."""
    if device.type == "cpu":
        return True
    return all(device_fn_of(f) is not None
               for f in (specs.dynamics, specs.stage_cost, specs.terminal_cost))


def spec_supports_lane_forward(specs, device: torch.device) -> bool:
    """The JAX router's ``spec_supports_lane_forward`` on ``device``'s terms:
    the kernels take the problem; each constraint side has at most
    :data:`MAX_CONSTRAINT_ROWS` rows, gives ``[..., m]`` on batched values
    and, on the card, carries a tag; and a context of the batched specs
    (``[B, T, ...]``) holds at most :data:`MAX_CONTEXT_FLOATS` floats a
    stage."""
    for fn, m in ((specs.equality_constraints, specs.eq_dim),
                  (specs.inequality_constraints, specs.ineq_dim)):
        if m > 0 and (m > MAX_CONSTRAINT_ROWS
                      or (device.type != "cpu" and device_fn_of(fn) is None)):
            return False
    if specs.context is not None:
        elems = 1
        for d in specs.context.shape[2:]:
            elems *= int(d)
        if elems > MAX_CONTEXT_FLOATS:
            return False
    return constraints_batched(specs) and kernels_take(specs, device)


def forward_pass_plain(spec, xs: Tensor, us: Tensor, k: Tensor, K: Tensor, alphas):
    """Plain PyTorch version of K9, in the kernel's layout: ``xs [T, nx, B]``
    (x_0..x_{T-1}), ``us [T, nu, B]``, ``k [T, nu, B]``, ``K [T, nu, nx, B]``
    float32 and the candidates ``alphas`` (floats) in; ``xs_out [T, nx, A,
    B]`` (x_1..x_T), ``us_out [T, nu, A, B]``, ``cost [A, B]`` out.  The
    TPU kernel's order of operations: ``u_ref + alpha k + sum_j K_ij dx_j``,
    clamped, the stage cost at the integer stage index added to the sum,
    then the RK4 step; the terminal cost last."""
    STATS.plain_calls += 1
    T, nx, B = xs.shape
    nu = us.shape[1]
    A = len(alphas)
    alpha = torch.tensor(alphas, dtype=torch.float32, device=xs.device)[:, None]   # [A, 1]
    bounds = None
    if spec.has_input_bounds:
        bounds = tuple(b.to(torch.float32).expand(B, nu).T for b in
                       (spec.input_lower_bounds, spec.input_upper_bounds))        # [nu, B]
    x = xs[0].T.expand(A, B, nx)
    xs_out = torch.empty((T, nx, A, B), dtype=torch.float32, device=xs.device)
    us_out = torch.empty((T, nu, A, B), dtype=torch.float32, device=xs.device)
    cost = torch.zeros((A, B), dtype=torch.float32, device=xs.device)
    for t in range(T):
        dx = x - xs[t].T
        rows = []
        for i in range(nu):
            u_i = us[t, i] + alpha * k[t, i] + sum(K[t, i, j] * dx[..., j] for j in range(nx))
            if bounds is not None:
                u_i = torch.minimum(torch.maximum(u_i, bounds[0][i]), bounds[1][i])
            rows.append(u_i)
        u = torch.stack(rows, -1)                                                  # [A, B, nu]
        cost = cost + spec.stage_cost(x, u, t)
        x = integrate_rk4(x, u, spec.dt, spec.dynamics)
        xs_out[t] = x.permute(2, 0, 1)
        us_out[t] = u.permute(2, 0, 1)
    return xs_out, us_out, cost + spec.terminal_cost(x)


def launch_forward_pass(spec, xs: Tensor, us: Tensor, k: Tensor, K: Tensor, alphas):
    """The CUDA launch of K9 (the plain version's layout and outputs)."""
    T, nx, B = xs.shape
    nu = us.shape[1]
    A = len(alphas)
    dev = xs.device
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)),
                           (k, "k", (T, nu, B)), (K, "K", (T, nu, nx, B))):
        check_tensor(t, name, shape, dev)
    lb = ub = None
    if spec.has_input_bounds:
        lb, ub = (b.to(device=dev, dtype=torch.float32).expand(B, nu).T.contiguous()
                  for b in (spec.input_lower_bounds, spec.input_upper_bounds))
    symbol, params = problem_symbol("forward_pass", nx, nu, spec.dynamics, spec.stage_cost,
                                    spec.terminal_cost)
    xs_out = torch.empty((T, nx, A, B), dtype=torch.float32, device=dev)
    us_out = torch.empty((T, nu, A, B), dtype=torch.float32, device=dev)
    cost = torch.empty((A, B), dtype=torch.float32, device=dev)
    # The candidates go to the kernel by value: nothing is copied to the card
    # before the launch, so a CUDA graph can capture the call.
    with torch.cuda.device(dev):
        launch(symbol, xs, us, k, K, lb, ub, tuple(alphas), xs_out, us_out, cost, T, B, *params,
               step_constants(spec.dt), A)
    STATS.launches += 1
    return xs_out, us_out, cost


def forward_pass(spec, xs: Tensor, us: Tensor, k: Tensor, K: Tensor, alphas):
    """K9 in the kernel's layout: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    alphas = tuple(float(a) for a in alphas)
    if not alphas:
        raise ValueError("forward_pass needs at least one alpha")
    if xs.device.type == "cpu":
        return forward_pass_plain(spec, xs, us, k, K, alphas)
    return launch_forward_pass(spec, xs, us, k, K, alphas)


def forward_pass_pallas(spec, xs: Tensor, us: Tensor, k: Tensor, K: Tensor, alphas,
                        forward=None):
    """The JAX package's ``forward_pass_pallas`` on batch-first tensors:
    every candidate's trajectory ``[B, A, T+1, nx]`` (``x_0`` first),
    controls ``[B, A, T, nu]`` and total cost ``[B, A]``, float32.
    ``forward`` is the K9 function in the kernel's layout (None:
    :func:`forward_pass`; :func:`forward_pass_plain` runs the plain version
    on any device)."""
    forward = forward_pass if forward is None else forward
    alphas = tuple(float(a) for a in torch.as_tensor(alphas).reshape(-1).tolist())
    B, Tp1, nx = xs.shape
    A = len(alphas)
    xs_out, us_out, cost = forward(spec, stage_major(xs[:, :-1]), stage_major(us),
                                   stage_major(k), stage_major(K), alphas)
    x0 = xs[:, None, :1].to(torch.float32).expand(B, A, 1, nx)
    xs_cand = torch.cat([x0, xs_out.permute(3, 2, 0, 1)], 2)
    return xs_cand, us_out.permute(3, 2, 0, 1).contiguous(), cost.T.contiguous()


def rollout_pallas(spec, x0: Tensor, us: Tensor, forward=None):
    """The JAX package's ``rollout_pallas``: ``us [B, T, nu]`` applied raw
    from ``x0 [B, nx]`` (alpha 0, zero gains, the bounds dropped: plain
    rollouts never clamp) through the same kernel; ``xs [B, T+1, nx]`` and
    ``costs [B]``, float32."""
    B, T, nu = us.shape
    nx = x0.shape[-1]
    unbounded = spec.replace(input_lower_bounds=None, input_upper_bounds=None)
    xs_ref = x0[:, None, :].expand(B, T + 1, nx)
    zeros_k = us.new_zeros((B, T, nu), dtype=torch.float32)
    zeros_K = us.new_zeros((B, T, nu, nx), dtype=torch.float32)
    xs_cand, _, costs = forward_pass_pallas(unbounded, xs_ref, us, zeros_k, zeros_K, (0.0,),
                                            forward)
    return xs_cand[:, 0], costs[:, 0]
