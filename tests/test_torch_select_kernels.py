"""The main path's redesigned kernels' mappings, on the CPU.

Two kernels of the port change only how work and outputs map onto lanes
(``csrc/forward_select.cuh::forward_select_lanes_kernel`` with its re-roll
launch, ``csrc/linearize.cu::linearize_flat_kernel``).  Neither runs here:
the kernels themselves are held only on the card, where ``chip_smoke.py``
(phases 3, 8, 12 and 19) holds them to their plain versions and
``kernel_times.py`` to the parent commit's kernels by a digest of their
outputs.  These tests hold Python transcriptions of the mappings against
the references:

* K2's lane select packs the A lanes of a problem side by side, 32 // A
  problems to a warp, and picks a problem's winner from a warp ballot
  shifted by the group's offset.  The transcription must cover every
  (problem, candidate) once and give ``ops/forward_select.py::_score``'s
  serial winner, merit and alpha at A = 1, 3, 10 and 16 on totals with
  NaNs, infinities, ties and frozen problems, and -- K6's AL select runs on
  the same kernel -- at A = 3 and 10 on AL totals (the state-bound rows and
  an equality row, random multipliers), against the AL ``_score`` itself.
* The plain select at the reference's 10-rung ladder (the ladder of the
  non-fused routes and the circular sweep, which the lane kernel runs
  there) meets the JAX package's ``forward_select_pallas_tiled`` in
  interpret mode, as ``tests/test_torch_kernels.py`` holds it at the
  bench's 3-rung ladder, with the same tolerance (rtol = atol = 1e-5).
* K7 stages a warp's 32 lanes' outputs in shared memory at a lane stride
  of ``N | 1`` and writes each array's span; the transcription must
  reproduce the direct ``[B T, ...]`` layout and each lane's row of ``xs``,
  with a tail warp and warps past the end.
"""

import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.solvers.ilqr import _alpha_ladder_floats as j_ladder

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.solvers.ilqr import _alpha_ladder_floats
from tests.test_torch_game_kernels import _score_of
from tests.test_torch_kernels import B, NU, NX, T, TOL, _inputs, _lanes, _unlanes

torch.set_num_threads(1)

SELECT_LANES_BLOCK = 128     # csrc/forward_select.cuh
LIN_BLOCK = 128              # csrc/linearize.cu


def lane_select(totals, merit, live, alphas):
    """forward_select_lanes_kernel's mapping and selection, thread by
    thread: lane g A + a of a warp runs candidate a of the warp's problem g;
    bit g A + a of the warp's ballot is that candidate's ``total < merit``
    on a live problem; the lowest of the problem's A bits wins, and the
    group's lane 0 writes the merit, the accept flag and the kept alpha.
    Returns ``(best, sel, found)`` and how often each (problem, candidate)
    ran."""
    A, nb = totals.shape
    per_warp = 32 // A
    warps = -(-nb // per_warp)
    grid = -(-warps * 32 // SELECT_LANES_BLOCK)
    best = np.full(nb, np.nan, np.float32)
    sel = np.full(nb, np.nan, np.float32)
    found = np.zeros(nb, bool)
    runs = np.zeros((A, nb), int)
    for warp in range(grid * SELECT_LANES_BLOCK // 32):
        lanes = []
        for lane in range(32):
            g, a = lane // A, lane % A
            b = warp * per_warp + g
            mine = g < per_warp and b < nb
            if mine:
                runs[a, b] += 1
            lanes.append((g, a, b, mine))
        ballot = 0
        for lane, (g, a, b, mine) in enumerate(lanes):
            if mine and live[b] and totals[a, b] < merit[b]:
                ballot |= 1 << lane
        for lane, (g, a, b, mine) in enumerate(lanes):
            if not mine or a != 0:
                continue
            wins = (ballot >> (g * A)) & ((1 << A) - 1)
            win = (wins & -wins).bit_length() - 1 if wins else 0
            best[b] = totals[win, b] if wins else merit[b]   # the shuffle from lane g A + win
            found[b] = wins != 0
            sel[b] = alphas[win]
    return best, sel, found, runs


def _al_case(A, nb):
    """AL select inputs at T = 3 (lane-follow problems, the state-bound
    configuration's four inequality rows and an equality row, multipliers
    U(-2, 2) / U(0, 3) and rho 10^U(0, 3)): each candidate's total ``[A,
    nb]`` (``_score`` at that alpha alone, merit +inf), merits 0.1% above a
    random rung's total (three of them +inf, -inf and NaN; two problems with
    a NaN x_0), the live mask, the ladder, and the AL ``_score``'s own
    ``(best, sel, found)`` over the whole ladder."""
    from multi_agent_solver_tpu_torch.ocp import bound_rows
    Tl = 3
    rng = np.random.RandomState(900 + A)
    spec = entry.state_bound_specs(1, device="cpu", horizon=Tl)
    spec = spec.replace(equality_constraints=bound_rows(("u", 0, 0.1, "lower")), eq_dim=1)
    alphas = (entry.BENCH_CONFIG.alpha_ladder if A == 3
              else _alpha_ladder_floats(entry.BENCH_CONFIG.alpha_min))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    xs = t(np.repeat(entry.bench_x0(nb).T[None], Tl, 0))
    xs[0, 0, :2] = float("nan")
    us = t(np.stack([rng.uniform(-0.7, 0.7, (Tl, nb)), rng.uniform(-1, 1, (Tl, nb))], 1))
    k = t(rng.uniform(-1.5, 1.5, (Tl, NU, nb)))
    K = t(rng.uniform(-0.5, 0.5, (Tl, NU, NX, nb)))
    lbT = t(np.broadcast_to([-0.7, -1.0], (nb, NU)))
    al = (t(rng.uniform(-2, 2, (Tl, 1, nb))), t(rng.uniform(0, 3, (Tl, spec.ineq_dim, nb))),
          t(10.0 ** rng.uniform(0, 3, nb)), 1e-6)
    score = lambda merit, live, ladder: k2._score(spec, xs, us, k, K, merit, live, lbT, -lbT,
                                                  ladder, None, *al)
    inf, everyone = torch.full((nb,), float("inf")), torch.ones(nb, dtype=torch.bool)
    totals = np.stack([score(inf, everyone, (a,))[1].numpy() for a in alphas])
    merit = (totals[rng.randint(0, A, nb), np.arange(nb)] * 1.001).astype(np.float32)
    merit[2:5] = (np.inf, -np.inf, np.nan)
    live = rng.uniform(size=nb) < 0.9
    _, best, sel, found = score(t(merit), torch.as_tensor(live), alphas)
    return totals, merit, live, alphas, (best.numpy(), sel.numpy(), found.numpy())


@pytest.mark.parametrize("A, al", [pytest.param(A, False, id=str(A)) for A in (1, 3, 10, 16)]
                         + [pytest.param(A, True, id=f"{A}-al") for A in (3, 10)])
def test_lane_select_matches_serial_winner(A, al):
    rng = np.random.RandomState(800 + A)
    nb = 700                      # not a multiple of any warp's problem count
    if al:
        totals, merit, live, alphas, want = _al_case(A, nb)
        # Every rung wins somewhere.
        assert (np.argmax(totals < merit, 0)[want[2]] == np.arange(A)[:, None]).any(1).all()
    else:
        values = np.array([1.0, 2.0, 2.5, 3.0, np.nan, np.inf, -np.inf], np.float32)
        # Few distinct values: ties between candidates and with the merit.
        totals = rng.choice(values, (A, nb)).astype(np.float32)
        totals[:, : nb // 4] = rng.uniform(0, 4, (A, nb // 4)).astype(np.float32)
        merit = rng.choice(values[:5], nb).astype(np.float32)
        live = rng.uniform(size=nb) < 0.8
        alphas = tuple(float(a) for a in 0.5 ** np.arange(A))
    want_best, want_sel, want_found = _score_of(totals, merit, live, alphas)
    if al:
        # The serial winner on the totals is the AL select's own.
        np.testing.assert_array_equal(want_found, want[2])
        np.testing.assert_array_equal(want_best, want[0])
        np.testing.assert_array_equal(want_sel[want_found], want[1][want_found])
    best, sel, found, runs = lane_select(totals, merit, live, alphas)
    assert (runs == 1).all()
    assert 0 < want_found.sum() < nb
    np.testing.assert_array_equal(found, want_found)
    np.testing.assert_array_equal(best, want_best)
    # The re-roll reads the kept alpha of accepted problems only.
    np.testing.assert_array_equal(sel[found], want_sel[found])


def test_forward_select_reference_ladder_matches_pallas():
    """Stage-out mode at the reference's 10-rung ladder, with bounds and
    frozen problems: trajectories, merit, accept flags and x_T agree."""
    from tests.problems import single_track_lane_ocp
    jspec = single_track_lane_ocp(horizon_steps=T).spec()
    tspec = entry.single_track_spec(horizon=T, device="cpu")
    ladder = _alpha_ladder_floats(entry.BENCH_CONFIG.alpha_min)
    assert len(ladder) == 10 and ladder == j_ladder(entry.BENCH_CONFIG.alpha_min)
    x, u = _inputs(15)
    rng = np.random.RandomState(16)
    xT = _inputs(17)[0][0]
    k = rng.uniform(-1.5, 1.5, (T, NU, B)).astype(np.float32)
    K = rng.uniform(-0.5, 0.5, (T, NU, NX, B)).astype(np.float32)
    active = rng.uniform(size=B) < 0.8
    lb = np.broadcast_to(np.array([[-0.7], [-1.0]], np.float32), (NU, B)).copy()
    ub = -lb
    t = lambda a: torch.as_tensor(a)
    score = lambda merit, alphas: k2._score(tspec, t(x), t(u), t(k), t(K), t(merit), t(active),
                                            t(lb.T), t(ub.T), alphas, None, None, None, None, 0.0)
    # Each problem's merit 0.1% above the total of a random rung, so that
    # every rung wins somewhere; problems with a total within 1e-5 of their
    # merit, where XLA's and PyTorch's last ulps could part, are frozen.
    inf = np.full(B, np.inf, np.float32)
    totals = np.stack([score(inf, (a,))[1].numpy() for a in ladder])
    merit = (totals[rng.randint(0, len(ladder), B), np.arange(B)] * 1.001).astype(np.float32)
    active &= ~(np.abs(totals - merit) <= 1e-5 * np.abs(merit)).any(0)
    xs_w, us_w, merit_w, accept_w, xT_w = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(K), _lanes(merit), _lanes(lb),
        _lanes(ub), ladder, True, active_l=_lanes(active.astype(np.float32)),
        xT_l=_lanes(xT), time_unroll=2,
    )
    bufs = [torch.as_tensor(a.copy()) for a in (x, u, xT)]
    merit_g, accept_g = k2.forward_select_plain(
        tspec, *bufs, torch.as_tensor(k), torch.as_tensor(K), torch.as_tensor(merit),
        torch.as_tensor(active), torch.as_tensor(lb), torch.as_tensor(ub), ladder)
    accept_want = _unlanes(accept_w) > 0.5
    assert 0 < accept_want.sum() < B
    np.testing.assert_array_equal(accept_g.numpy(), accept_want)
    np.testing.assert_allclose(merit_g.numpy(), _unlanes(merit_w), **TOL)
    for g, w in zip(bufs, (xs_w, us_w, xT_w)):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)
    # Some accepted problems took a rung below the bench ladder's last.
    _, _, sel, found = score(merit, ladder)
    assert int((found & (sel < 0.125)).sum()) > 0


def k7_staged(values, xs, T):
    """linearize_flat_kernel's staging, warp by warp: each warp reads its
    rows of ``xs [B, T + 1, NX]`` into ``x_in`` and each lane takes row
    ``l + l // T - r0``; each lane stages its N floats of an array at
    ``lane (N | 1) + k``, and the warp writes element ``i`` of its span from
    ``(i // N) (N | 1) + i % N``.  ``values [B T, N]`` are the lanes'
    outputs; returns ``(out [B T N], x [B T, NX])`` as the kernel lays them
    out."""
    n, N = values.shape
    nx = xs.shape[-1]
    flat_xs = xs.reshape(-1)
    out = np.full(n * N, np.nan, np.float32)
    x = np.full((n, nx), np.nan, np.float32)
    S = N | 1
    grid = -(-n // LIN_BLOCK)
    for block in range(grid):
        for warp in range(LIN_BLOCK // 32):
            l0 = block * LIN_BLOCK + warp * 32
            if l0 >= n:
                continue                         # the whole warp leaves
            lanes = min(32, n - l0)
            last = l0 + lanes - 1
            r0 = l0 + l0 // T
            rows = last + last // T - r0 + 1
            assert rows <= 64                    # the warp's x_in holds 2 x 32 rows
            x_in = flat_xs[r0 * nx: (r0 + rows) * nx]
            staged = np.full(32 * S, np.nan, np.float32)
            for lane in range(lanes):
                l = l0 + lane
                row = l + l // T - r0
                x[l] = x_in[row * nx: (row + 1) * nx]
                staged[lane * S: lane * S + N] = values[l]
            for lane in range(32):
                for i in range(lane, lanes * N, 32):
                    out[l0 * N + i] = staged[(i // N) * S + i % N]
    return out, x


@pytest.mark.parametrize("Bp, Tp", [(8, 80), (37, 7), (5, 3), (3, 1)])
def test_k7_staging_reproduces_the_direct_layout(Bp, Tp):
    rng = np.random.RandomState(Bp * 100 + Tp)
    xs = rng.uniform(-1, 1, (Bp, Tp + 1, NX)).astype(np.float32)
    for N in (NX * NX, NX * NU, NX, NU, NU * NU, NU * NX):
        values = rng.uniform(-1, 1, (Bp * Tp, N)).astype(np.float32)
        out, x = k7_staged(values, xs, Tp)
        np.testing.assert_array_equal(out, values.reshape(-1))
        np.testing.assert_array_equal(x, xs[:, :Tp].reshape(-1, NX))
