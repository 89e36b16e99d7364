"""Seeded numpy inputs for `cluster_edges`: the cases the port's CPU tests
hold against JAX and its `gpu` tests hold K4 against the twin with. No
JAX or torch here: `case(name, N, C)` returns float32 x, y, theta (N, C),
a bool mask (N, C) and the keyword arguments; `f32_ulps` and
`K4_JAX_ULPS` are the tolerance the twin and K4 are held to against
JAX's outputs."""

import numpy as np

CASES = ("clumps", "clumps_oriented", "all_masked_rows", "big_component",
         "distance_ties", "nonfinite_masked", "long_chains", "signed_zeros")


def _clumps(g, N, C, spread=0.6):
    """Rows of C slots scattered around one point, dense enough that
    components exceed a cap of 10."""
    x = g.uniform(0, 50, (N, 1)) + g.normal(0, spread, (N, C))
    y = g.uniform(0, 50, (N, 1)) + g.normal(0, spread, (N, C))
    th = g.uniform(-1, 1, (N, C))
    return x, y, th, g.random((N, C)) > 0.2


def _lattice_row(g, C):
    """A 5 x 5 lattice of spacing 0.25 about a dyadic centre, in shuffled
    slots: its centroid is exact, so members tie in their distance to it
    (4 at 0.5, 8 at 0.559, ...); the other slots lie far apart."""
    off = np.array([-0.5, -0.25, 0.0, 0.25, 0.5])
    ox, oy = (a.ravel() for a in np.meshgrid(off, off))
    cx, cy = g.integers(2, 40, 2) + 0.5
    x = np.concatenate([cx + ox, 100 + 3.0 * np.arange(C - 25)])
    y = np.concatenate([cy + oy, 100 + 3.0 * np.arange(C - 25)])
    p = g.permutation(C)
    return x[p], y[p]


def _chain_row(g, C):
    """One chain of 9-24 slots about 0.9 px apart (gaps 0.85-0.95, so no
    two members tie in their distance to a centroid) along a random
    direction, in shuffled slots; the other slots lie far apart, about
    half of them masked. The chain is a path of the distance graph, and
    the label rounds end before they reach its far end."""
    L = int(g.integers(9, 25))
    a = g.uniform(0, np.pi)
    s = np.concatenate([[0.0], np.cumsum(g.uniform(0.85, 0.95, L - 1))])
    x0, y0 = g.uniform(0, 50, 2)
    x = np.concatenate([x0 + s * np.cos(a), 100 + 3.0 * np.arange(C - L)])
    y = np.concatenate([y0 + s * np.sin(a), 100 + 3.0 * np.arange(C - L)])
    mask = np.concatenate([np.ones(L, bool), g.random(C - L) > 0.5])
    p = g.permutation(C)
    return x[p], y[p], mask[p]


def _signed_zeros(g, N, C):
    """Clumps at negative x, y and theta, and in shuffled slots a group of
    4 members at x = y = theta = -0.0. Then, by row: (0) nothing else; (1)
    a masked slot holds +0.0 in x, y and theta; (2) the group's x
    alternate 0.0 and -0.0; (3) an active slot of a clump holds theta
    +0.0. Where every term of a sum is -0 the twin's sum is -0, else +0."""
    x, y, th, mask = _clumps(g, N, C)
    x, y, th = -np.abs(x) - 10, -np.abs(y) - 10, -np.abs(th) - 0.01
    for i in range(N):
        z, other = np.split(g.permutation(C), [4])
        x[i, z] = y[i, z] = th[i, z] = -0.0
        mask[i, z] = True
        kind = i % 4
        if kind == 1:
            mask[i, other[0]] = False
            x[i, other[0]] = y[i, other[0]] = th[i, other[0]] = 0.0
        elif kind == 2:
            x[i, z[::2]] = 0.0
        elif kind == 3:
            mask[i, other[0]] = True
            th[i, other[0]] = 0.0
    return x, y, th, mask


def case(name, N, C, seed=0):
    g = np.random.default_rng(seed)
    kw = dict(dist_thresh=1.0, orient_thresh_deg=20.0, by_orientation=False,
              gauss_sigma=2.0, max_cluster_size=10)
    if name in ("clumps", "clumps_oriented"):
        x, y, th, mask = _clumps(g, N, C)
        kw["by_orientation"] = name == "clumps_oriented"
    elif name == "all_masked_rows":
        x, y, th, mask = _clumps(g, N, C)
        mask[::3] = False
    elif name == "big_component":
        # every slot within 0.2 of its row's centre: one component of up to
        # C members, cut to the cap
        x, y, th, mask = _clumps(g, N, C, spread=0.2)
        mask = g.random((N, C)) > 0.05
    elif name == "distance_ties":
        if C < 25:
            raise ValueError("the lattice needs 25 slots a row")
        rows = [_lattice_row(g, C) for _ in range(N)]
        x = np.stack([r[0] for r in rows])
        y = np.stack([r[1] for r in rows])
        th = np.zeros((N, C))
        mask = np.ones((N, C), bool)
        mask[1::2, g.integers(0, C)] = False
    elif name == "nonfinite_masked":
        x, y, th, mask = _clumps(g, N, C)
        bad = ~mask & (np.arange(N)[:, None] % 2 == 0)
        vals = np.array([np.nan, np.inf, -np.inf])[g.integers(0, 3, (N, C))]
        x = np.where(bad, vals, x)
        y = np.where(bad & (g.random((N, C)) > 0.5), np.nan, y)
        th = np.where(bad & (g.random((N, C)) > 0.5), np.inf, th)
        kw["by_orientation"] = True
    elif name == "long_chains":
        if C < 24:
            raise ValueError("a chain takes up to 24 slots a row")
        rows = [_chain_row(g, C) for _ in range(N)]
        x, y, mask = (np.stack([r[k] for r in rows]) if rows
                      else np.zeros((0, C)) for k in range(3))
        th = g.uniform(-1, 1, (N, C))
    elif name == "signed_zeros":
        x, y, th, mask = _signed_zeros(g, N, C)
        kw["by_orientation"] = True
    else:
        raise ValueError(f"no clustering case {name!r}")
    f32 = np.float32
    return (x.astype(f32), y.astype(f32), th.astype(f32),
            np.asarray(mask, bool), kw)


# K4 against the JAX package's outputs: x, y and theta within this many
# float32 ulps of max(|a|, |b|, 1). The twin (and K4) adds in ascending
# slot order, XLA's dots in their own order, and the card's expf may
# differ from the CPU's vectorised exp in the last bit; the twin on the
# CPU is within 7 of JAX on every case.
K4_JAX_ULPS = 16


def f32_ulps(a, b):
    """The largest difference of two float32 arrays in ulps of
    max(|a|, |b|, 1) (0 where both are NaN), and the entries that are NaN
    in one only."""
    u, v = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b))
    nan = np.isnan(u) | np.isnan(v)
    mag = np.maximum(np.maximum(np.abs(np.where(nan, 0, u)),
                                np.abs(np.where(nan, 0, v))), 1.0)
    with np.errstate(invalid="ignore"):
        d = np.where(nan | (u == v), 0.0, np.abs(u - v)
                     / np.exp2(np.floor(np.log2(mag)) - 23))
    return (float(d.max()) if d.size else 0.0,
            int((np.isnan(u) != np.isnan(v)).sum()))
