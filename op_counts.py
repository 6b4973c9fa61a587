"""Float32 operations a stage of K1 (the fused linearize-and-Riccati kernel,
csrc/riccati.cuh: riccati_fusedlin_kernel) needs, for chip_smoke.py's
bounds (OPS_K1_STAGE, OPS_K1_CONT, OPS_K1_SOLVE).

The script traces the csrc arithmetic of one stage on symbols: the
single-track model's dual RK4 step (csrc/problems.cuh, SingleTrack,
rk4_step, stage_derivatives_live; csrc/dual.cuh), the diagonal quadratic
cost's gradient (cost_gradient) and the stage core at nx = 4, nu = 2
(stage_core, one Sylvester test, the 2 x 2 Gauss-Jordan solve).  It counts
the operations whose results reach the stage's outputs (A, B, lx, lu into
k, K and the new v_x, v_xx), each once however often the code writes it,
and leaves out what the function does not need:

- a product by a structural zero or one, a sum with a structural zero: the
  dual seeds, the tangents that stay zero, the columns of A that K1 writes
  as constants (e_j in the discrete mode, 0 in the continuous one), the
  cost's diagonal Hessians (lux = 0);
- a value no output reads (f's X and Y rates, the step's value, the cost);
- the mirrored half of the symmetric v_xx update.

A transcendental (sin, cos, tan) counts as one operation, a comparison as
one, so the counts are a floor.  Prints one JSON line.

    python3 op_counts.py
"""

from __future__ import annotations

import json

NX, NU = 4, 2
ZERO, ONE = ("const", 0.0), ("const", 1.0)
COMMUTATIVE = {"add", "mul"}


def node(op, *args):
    if op in COMMUTATIVE:
        args = tuple(sorted(args, key=repr))
    return (op, *args)


def sym(name):
    return ("in", name)


def add(a, b):
    return b if a == ZERO else a if b == ZERO else node("add", a, b)


def neg(a):
    return ZERO if a == ZERO else node("neg", a)


def sub(a, b):
    return a if b == ZERO else neg(b) if a == ZERO else node("sub", a, b)


def mul(a, b):
    if ZERO in (a, b):
        return ZERO
    return b if a == ONE else a if b == ONE else node("mul", a, b)


def div(a, b):
    return ZERO if a == ZERO else node("div", a, b)


class Dual:
    """csrc/dual.cuh's rules on symbols."""

    def __init__(self, v, d):
        self.v, self.d = v, list(d)

    @staticmethod
    def seed(v, k, n):
        return Dual(v, [ONE if i == k else ZERO for i in range(n)])

    def __add__(self, o):
        return Dual(add(self.v, o.v), map(add, self.d, o.d))

    def __mul__(self, o):
        return Dual(mul(self.v, o.v),
                    [add(mul(a, o.v), mul(self.v, b)) for a, b in zip(self.d, o.d)])

    def scale(self, c):
        return Dual(mul(c, self.v), [mul(c, a) for a in self.d])

    def over(self, c):
        return Dual(div(self.v, c), [div(a, c) for a in self.d])

    def minus(self, c):
        return Dual(sub(self.v, c), self.d)

    def tan(self):
        t = node("tan", self.v)
        sec2 = add(ONE, mul(t, t))
        return Dual(t, [mul(a, sec2) for a in self.d])

    def sincos(self):
        s, c = node("sin", self.v), node("cos", self.v)
        return (Dual(s, [mul(a, c) for a in self.d]), Dual(c, [neg(mul(a, s)) for a in self.d]))


def single_track(x, tan_delta, a):
    s, c = x[2].sincos()
    return [x[3] * c, x[3] * s, (x[3] * tan_delta).over(sym("L")), a]


def rk4(x, tan_delta, a):
    f = lambda y: single_track(y, tan_delta, a)
    two, half, full, sixth = ("const", 2.0), sym("half"), sym("full"), sym("sixth")
    k1 = f(x)
    k2 = f([x[i] + k1[i].scale(half) for i in range(NX)])
    k3 = f([x[i] + k2[i].scale(half) for i in range(NX)])
    k4 = f([x[i] + k3[i].scale(full) for i in range(NX)])
    return [x[i] + (k1[i] + k2[i].scale(two) + k3[i].scale(two) + k4[i]).scale(sixth)
            for i in range(NX)]


def cost_gradient():
    z = [Dual.seed(sym(f"z{i}"), i, NX + NU) for i in range(NX + NU)]
    w = [sym(f"w{i}") for i in range(NX + NU)]
    c = None
    for i in range(NX + NU):
        e = z[i].minus(sym(f"r{i}"))
        term = (e * e).scale(w[i])
        c = term if c is None else c + term
    return c.d[:NX], c.d[NX:]


def linearization(discrete):
    """A, B (the dynamics in the tangents of psi, v, delta, a), lx, lu."""
    live = {2: 0, 3: 1}
    n = len(live) + NU
    x = [Dual.seed(sym(f"x{i}"), live[i], n) if i in live else Dual(sym(f"x{i}"), [ZERO] * n)
         for i in range(NX)]
    u = [Dual.seed(sym(f"u{j}"), len(live) + j, n) for j in range(NU)]
    tan_delta = u[0].tan()
    nxt = rk4(x, tan_delta, u[1]) if discrete else single_track(x, tan_delta, u[1])
    A = [[nxt[i].d[live[j]] if j in live else ONE if discrete and i == j else ZERO
          for j in range(NX)] for i in range(NX)]
    B = [[nxt[i].d[len(live) + j] for j in range(NU)] for i in range(NX)]
    lx, lu = cost_gradient()
    return A, B, lx, lu


def dot(a, b):
    s = mul(a[0], b[0])
    for p, q in zip(a[1:], b[1:]):
        s = add(s, mul(p, q))
    return s


def col(m, j):
    return [row[j] for row in m]


def stage(A, B, lx, lu):
    """stage_core's outputs, and the inputs and outputs of its gain solve."""
    lxx = [[sym(f"lxx{i}") if i == j else ZERO for j in range(NX)] for i in range(NX)]
    luu = [[sym(f"luu{i}") if i == j else ZERO for j in range(NU)] for i in range(NU)]
    vx = [sym(f"vx{i}") for i in range(NX)]
    vxx = [[sym(f"vxx{min(i, j)}{max(i, j)}") for j in range(NX)] for i in range(NX)]
    q_x = [add(lx[j], dot(col(A, j), vx)) for j in range(NX)]
    q_u = [add(lu[j], dot(col(B, j), vx)) for j in range(NU)]
    vA = [[dot(vxx[i], col(A, j)) for j in range(NX)] for i in range(NX)]
    vB = [[dot(vxx[i], col(B, j)) for j in range(NU)] for i in range(NX)]
    q_xx = [[add(lxx[i][j], dot(col(A, i), col(vA, j))) for j in range(NX)] for i in range(NX)]
    q_ux = [[dot(col(B, i), col(vA, j)) for j in range(NX)] for i in range(NU)]
    q_uu = [[add(luu[i][j], dot(col(B, i), col(vB, j))) for j in range(NU)] for i in range(NU)]
    # The ladder's first rung: Sylvester's test of q_uu + level.
    q = [[add(q_uu[i][j], sym("level") if i == j else ZERO) for j in range(NU)] for i in range(NU)]
    sylvester = [node("gt", q[0][0], ZERO),
                 node("gt", sub(mul(q[0][0], q[1][1]), mul(q[0][1], q[1][0])), ZERO)]
    # [k | K] = -(q_uu + best)^-1 [q_u | q_ux] by Gauss-Jordan.
    M = [[add(q_uu[i][j], sym("best") if i == j else ZERO) for j in range(NU)] for i in range(NU)]
    X = [[q_u[i], *q_ux[i]] for i in range(NU)]
    for c in range(NU):
        inv = div(ONE, M[c][c])
        M[c] = [M[c][j] if j < c else mul(M[c][j], inv) for j in range(NU)]
        X[c] = [mul(v, inv) for v in X[c]]
        for r in range(NU):
            if r != c:
                f = M[r][c]
                M[r] = [M[r][j] if j < c else sub(M[r][j], mul(f, M[c][j])) for j in range(NU)]
                X[r] = [sub(X[r][j], mul(f, X[c][j])) for j in range(NX + 1)]
    k = [neg(X[i][0]) for i in range(NU)]
    K = [[neg(X[i][1 + j]) for j in range(NX)] for i in range(NU)]
    # Value recursion with the unregularized q_uu.
    q_uu_k = [dot(q_uu[i], k) for i in range(NU)]
    vx_new = [add(add(add(q_x[j], dot(col(K, j), q_u)), dot(col(q_ux, j), k)),
                  dot(col(K, j), q_uu_k)) for j in range(NX)]
    KQ = [[dot(col(K, i), col(q_ux, j)) for j in range(NX)] for i in range(NX)]
    nv = [[add(add(add(q_xx[i][j], KQ[i][j]), KQ[j][i]),
               dot(col(K, i), [dot(q_uu[u], col(K, j)) for u in range(NU)]))
           for j in range(NX)] for i in range(NX)]
    vxx_new = [mul(("const", 0.5), add(nv[i][j], nv[j][i]))
               for i in range(NX) for j in range(i, NX)]
    gains = k + [v for row in K for v in row]
    solve_in = [v for row in q_uu for v in row] + q_u + [v for row in q_ux for v in row]
    return sylvester + gains + vx_new + vxx_new, solve_in, gains


def count(outputs):
    seen = set()
    stack = list(outputs)
    while stack:
        n = stack.pop()
        if n[0] not in ("in", "const") and n not in seen:
            seen.add(n)
            stack.extend(n[1:])
    return len(seen)


def main():
    counts = {}
    for name, discrete in (("OPS_K1_STAGE", True), ("OPS_K1_CONT", False)):
        A, B, lx, lu = linearization(discrete)
        outputs, solve_in, gains = stage(A, B, lx, lu)
        counts[name] = count(outputs)
        counts[name + "_linearization"] = count([v for row in A + B for v in row] + lx + lu)
        if discrete:
            # The clamp gain solve that K5's box QP replaces under boxqp.
            counts["OPS_K1_SOLVE"] = count(gains) - count(solve_in)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
