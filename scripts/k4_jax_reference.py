#!/usr/bin/env python
"""Write the JAX package's `cluster_edges` on every case of
`tests/cluster_cases.py` (64 rows of 32 slots, each case at its index as
seed) to `tests/data/k4_jax_reference.npz`: x, y, theta (float32), mask,
label (int32) and members, one array a case and output, so that a machine
without JAX can hold K4's output on the card against them
(`tests/test_torch_cuda.py`).

    JAX_PLATFORMS=cpu python scripts/k4_jax_reference.py

`tests/test_torch_ops.py` recomputes every array with JAX and requires the
file to equal them bit for bit (a NaN equal to a NaN), so it cannot go
stale.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tests import cluster_cases as CC  # noqa: E402

PATH = os.path.join(REPO, "tests", "data", "k4_jax_reference.npz")
N_ROWS, SLOTS = 64, 32
FIELDS = ("x", "y", "theta", "mask", "label", "members")


def inputs(name):
    """Case `name` at 64 rows of 32 slots: x, y, theta, mask, kwargs."""
    return CC.case(name, N_ROWS, SLOTS, seed=CC.CASES.index(name))


def jax_outputs(name):
    """{field: array} of JAX's `cluster_edges` on case `name`."""
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.ops import clustering as JCL

    x, y, th, mask, kw = inputs(name)
    out = JCL.cluster_edges(*(jnp.asarray(a) for a in (x, y, th, mask)), **kw)
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def key(name, field):
    return f"{name}__{field}"


def main():
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    arrays = {}
    for name in CC.CASES:
        for f, a in jax_outputs(name).items():
            arrays[key(name, f)] = a
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH}: {len(CC.CASES)} cases of {N_ROWS} x {SLOTS} slots")


if __name__ == "__main__":
    main()
