#!/usr/bin/env python
"""Write the JAX package's edge descriptors on every case of
`tests/descriptor_cases.py` (64 edges, seed 0) to
`tests/data/k5_jax_reference.npz`, as bf16 bit patterns (uint16, one
array a case), so that a machine without JAX can hold K5's output on the
card against them (`tests/test_torch_cuda.py`).

    JAX_PLATFORMS=cpu python scripts/k5_jax_reference.py

`tests/test_torch_descriptors.py` recomputes every array with JAX and
requires the file to equal them bit for bit, so it cannot go stale.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tests import descriptor_cases as DC  # noqa: E402

PATH = os.path.join(REPO, "tests", "data", "k5_jax_reference.npz")
N_EDGES = 64


def jax_bits(name):
    """`edge_descriptors_tiled` on case `name` at 64 edges: (64, 256)
    uint16, the bf16 bit patterns."""
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.ops import descriptors as JD

    maps, edges, kw = DC.case(name, N_EDGES)
    out = JD.edge_descriptors_tiled(*(jnp.asarray(a) for a in maps + edges),
                                    **kw)
    return np.asarray(out.view(jnp.uint16))


def main():
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **{name: jax_bits(name) for name in DC.CASES})
    print(f"wrote {PATH}: {len(DC.CASES)} cases of ({N_EDGES}, 256) bf16")


if __name__ == "__main__":
    main()
