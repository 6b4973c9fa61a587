"""The arithmetic of the coupled game's lane-group kernels, on the CPU.

Two kernels of the port spread one problem over a group of lanes
(``csrc/forward_select.cuh::forward_select_group_kernel``,
``csrc/linearize.cu::linearize_group_kernel``).  Neither runs here, so
these tests hold what their mapping changes against the references:

* K6's context select picks its winner by a ballot: the lowest lane (the
  lowest candidate index, the largest alpha) whose total beats the merit on
  a live problem.  A Python mirror of that bit-mask rule must give the
  serial loop's winner, merit and alpha (``ops/forward_select.py::_score``)
  on random totals with NaNs, infinities, ties and frozen problems.  Each
  candidate's arithmetic is the one-thread kernel's, so nothing else moves.
  This holds a transcription of the rule, not the kernel: that the CUDA
  kernel's ballot picks this winner shows only on the card, where
  ``chip_smoke.py`` (phases 13 and 22) holds its outputs to the plain
  version's.
* K3's context mode sums the neighbours' pair costs in another order: lane
  ``l`` of ``G`` sums neighbours ``l, l + G, ...`` in index order, then a
  fixed xor tree (offsets ``G/2 ... 1``) sums the lanes, and the base cost's
  derivatives are added last.  A torch helper sums float32 per-neighbour
  derivatives in that order, at G = 1, 8 and 32, and the result must meet the
  JAX package's ``linearize_pallas_tiled`` (interpret mode) with the
  context at K = 8 and 63 within tests/test_torch_coupled.py's tolerance
  (rtol 1e-5, atol 1e-4; pair costs up to 25, Hessian entries ~10).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from multi_agent_solver_tpu.examples import multi_agent_single_track as j_circ
from multi_agent_solver_tpu.ocp import with_context_cost as j_with_context_cost
from multi_agent_solver_tpu.ops.linearize_pallas import linearize_pallas_tiled
from multi_agent_solver_tpu.strategies.nash import make_coupled_stage as j_coupled_stage

from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as t_circ
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3

torch.set_num_threads(1)

B, T, NX, NU = 1024, 4, 4, 2
TOL = dict(rtol=1e-5, atol=1e-4)
COUPLING = 25.0


def group_select(totals, merit, live, alphas):
    """The group kernel's rule: bit a of a problem's mask is ``total_a <
    merit`` on a live problem; the lowest set bit wins.  Returns ``(best,
    sel, found)`` as ``_score`` does."""
    A, nb = totals.shape
    best, sel = merit.copy(), np.zeros(nb, np.float32)
    found = np.zeros(nb, bool)
    for b in range(nb):
        wins = sum(1 << a for a in range(A) if live[b] and totals[a, b] < merit[b])
        if wins:
            win = (wins & -wins).bit_length() - 1
            best[b], sel[b], found[b] = totals[win, b], alphas[win], True
    return best, sel, found


def _score_of(totals, merit, live, alphas):
    """``_score`` driven to the given totals: T = 1, zero gains apart from
    k = 1, so candidate a's control is exactly alphas[a], and a stage cost
    that looks its total up by that control (zero dynamics and terminal
    cost)."""
    A, nb = totals.shape
    table = torch.as_tensor(totals)
    levels = torch.tensor(alphas, dtype=torch.float32)
    cols = torch.arange(nb)

    def stage_cost(x, u, t):
        a = (u[:, :1] == levels).to(torch.int64).argmax(-1)
        return table[a, cols]

    spec = types.SimpleNamespace(stage_cost=stage_cost, dt=0.1,
                                 dynamics=lambda x, u: torch.zeros_like(x),
                                 terminal_cost=lambda x: torch.zeros(x.shape[0]))
    xs = torch.zeros((1, 1, nb))
    us = torch.zeros((1, 1, nb))
    k = torch.ones((1, 1, nb))
    K = torch.zeros((1, 1, 1, nb))
    _, best, sel, found = k2._score(spec, xs, us, k, K, torch.as_tensor(merit),
                                    torch.as_tensor(live), None, None, alphas, None, None, None,
                                    None, 0.0)
    return best.numpy(), sel.numpy(), found.numpy()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("A", [1, 3, 10, 16])
def test_group_selection_rule_matches_serial_winner(A, seed):
    rng = np.random.RandomState(100 * A + seed)
    nb = 512
    values = np.array([1.0, 2.0, 2.5, 3.0, np.nan, np.inf, -np.inf], np.float32)
    # Few distinct values: ties between candidates and with the merit.
    totals = rng.choice(values, (A, nb)).astype(np.float32)
    totals[:, : nb // 4] = rng.uniform(0, 4, (A, nb // 4)).astype(np.float32)
    merit = rng.choice(values[:5], nb).astype(np.float32)
    live = rng.uniform(size=nb) < 0.8
    alphas = tuple(float(a) for a in 0.5 ** np.arange(A))
    want = _score_of(totals, merit, live, alphas)
    got = group_select(totals, merit, live, alphas)
    assert 0 < want[2].sum() < nb
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def _inputs(seed, K):
    """States around the track, controls in the box, and K neighbours per
    (stage, problem) within a few metres, where the collision cost bites."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, (T, B))
    r = 20.0 + rng.uniform(-1, 1, (T, B))
    x = np.stack([r * np.cos(th), r * np.sin(th), th + 1.57, rng.uniform(3, 6, (T, B))], 1)
    u = rng.uniform(-0.5, 0.5, (T, NU, B))
    ctx = x[:, None] + np.concatenate(
        [rng.normal(0, 2.0, (T, K, 2, B)), rng.normal(0, 0.5, (T, K, 2, B))], 2)
    return x.astype(np.float32), u.astype(np.float32), ctx.astype(np.float32)


def group_order_sum(parts, G):
    """``parts [K, ...]`` summed as the group kernel sums them: lane l adds
    parts l, l + G, ... in order from 0, then the xor tree over the lanes."""
    K = parts.shape[0]
    lanes = torch.zeros((G,) + parts.shape[1:], dtype=parts.dtype)
    for k in range(K):
        lanes[k % G] = lanes[k % G] + parts[k]
    idx = torch.arange(G)
    off = G // 2
    while off:
        lanes = lanes + lanes[idx ^ off]
        off //= 2
    return lanes[0]


def pair_derivatives(x, ctx_b):
    """Float32 gradient ``[K, T, B, nx]`` and Hessian ``[K, T, B, nx, nx]`` in
    x of each neighbour's pair cost at ``x [T, B, nx]`` with ``ctx_b [T, B,
    K, C]``: jvp, and jvp over jvp with the upper triangle mirrored, as
    ``linearize.cost_hessians`` takes them (the pair cost reads no u)."""
    pair = t_circ.make_collision_cost(COUPLING)
    f = lambda a: pair(a[..., None, :], ctx_b, None)
    e = lambda j: torch.zeros_like(x).index_fill_(-1, torch.tensor([j]), 1.0)
    grad = lambda a, i: jvp(f, (a,), (e(i),))[1]
    gx = torch.stack([grad(x, i) for i in range(NX)], -1)
    h = [[None] * NX for _ in range(NX)]
    for i in range(NX):
        for j in range(i, NX):
            h[i][j] = h[j][i] = jvp(lambda a: grad(a, i), (x,), (e(j),))[1]
    hxx = torch.stack([torch.stack(row, -1) for row in h], -2)
    return gx.movedim(2, 0), hxx.movedim(2, 0)


def linearize_group_order(tspec, x, u, ctx, G):
    """K3's context outputs with the neighbour sum in the group kernel's
    order: A, B and the base cost's derivatives from the plain
    linearization of the base spec, plus the per-neighbour pair
    derivatives summed by :func:`group_order_sum` (their u-derivatives are
    zero)."""
    xs, us = torch.as_tensor(x), torch.as_tensor(u)
    A, Bm, lx, lu, lxx, luu, lux = k3.linearize_plain(tspec, xs, us, True)
    gx, hxx = pair_derivatives(xs.permute(0, 2, 1), torch.as_tensor(ctx).permute(0, 3, 1, 2))
    sx, sxx = group_order_sum(gx, G), group_order_sum(hxx, G)       # [T, B, ...]
    return A, Bm, lx + sx.permute(0, 2, 1), lu, lxx + sxx.permute(0, 2, 3, 1), luu, lux


@functools.lru_cache(maxsize=None)
def _pallas_context_linearization(K):
    """Inputs with K neighbours and the JAX kernel's outputs on them (one
    interpret-mode call for each K, shared by the lane counts)."""
    jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
    jcoupled = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                         j_circ.make_collision_cost(COUPLING)))
    x, u, ctx = _inputs(10 + K, K)
    want = linearize_pallas_tiled(jcoupled, _lanes(x), _lanes(u), True, True, ctx_l=_lanes(ctx),
                                  hessians=True)
    return x, u, ctx, want


# The lane counts the kernel takes (csrc/linearize.cu::group_lanes): 32 at
# the 64-car game's K = 63, 8 at the 256-car game's K = 8 (and at K = 63
# for launches of 1,025-4,096 problem-stages), one lane a problem-stage
# from 4,097 (the 1,024-car game).
@pytest.mark.parametrize("K, G", [(63, 32), (63, 8), (63, 1), (8, 8), (8, 1)])
def test_linearize_context_group_order_matches_pallas(K, G):
    tspec = t_circ.create_single_track_circular_ocp(0.0, device="cpu").spec()
    x, u, ctx, want = _pallas_context_linearization(K)
    got = linearize_group_order(tspec, x, u, ctx, G)
    assert len(got) == len(want) == 7
    for name, g, w in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux"), got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), err_msg=name, **TOL)
    # The pair costs move the gradient: the comparison bites on them.
    base_lx = k3.linearize_plain(tspec, torch.as_tensor(x), torch.as_tensor(u), False)[2]
    assert float((got[2] - base_lx).abs().max()) > 1.0
