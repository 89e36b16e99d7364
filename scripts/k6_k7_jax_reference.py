#!/usr/bin/env python
"""Write the JAX package's dense gates and edge patches on every case of
`tests/gate_cases.py` to `tests/data/k6_k7_jax_reference.npz`, so that a
machine without JAX can hold K6's and K7's outputs on the card against
them (`tests/test_torch_cuda.py`):
  - `stereo/<case>/dist` and `stereo/<case>/ncc` (N, C): JAX's
    `min_cross_distance_dot` and `ncc4` on every slot of the stereo case
    (the flat case's pairs are the same slots);
  - `temporal/<case>` (4, M, C): left / right NCC and left / right
    descriptor distance on every slot of the temporal case, the CF
    patches rounded to bf16 as JAX's temporal cascade rounds them;
  - `patches/<case>/pat` (B, 2 P^2) and `patches/<case>/ok` (B, 2):
    `edge_patches_tiled` on the patch case.

    JAX_PLATFORMS=cpu python scripts/k6_k7_jax_reference.py

`tests/test_torch_gates.py` recomputes every array with JAX and requires
the file to equal them bit for bit, so it cannot go stale.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tests import gate_cases as GC  # noqa: E402

PATH = os.path.join(REPO, "tests", "data", "k6_k7_jax_reference.npz")


def _ncc4(JP, a, a_ok, b, b_ok):
    pp = GC.PP
    return JP.ncc4(a[..., :pp], a[..., pp:], a_ok[..., 0], a_ok[..., 1],
                   b[..., :pp], b[..., pp:], b_ok[..., 0], b_ok[..., 1])


def stereo(name):
    """(dist, ncc) (N, C) float32 of JAX on every slot of the case."""
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.ops import descriptors as JD
    from edge_based_visual_odometry_tpu.ops import patches as JP

    s = {k: jnp.asarray(v) for k, v in GC.stereo_case(name).items()}
    j = s["cand"]
    dist = JD.min_cross_distance_dot(s["l_desc"].astype(jnp.bfloat16),
                                     s["r_desc"][j].astype(jnp.bfloat16))
    ncc = _ncc4(JP, s["l_pat"][:, None], s["l_ok"][:, None],
                s["r_pat"][j], s["r_ok"][j])
    return np.asarray(dist), np.asarray(ncc)


def temporal(name):
    """(4, M, C) float32 of JAX on every slot of the case."""
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.ops import descriptors as JD
    from edge_based_visual_odometry_tpu.ops import patches as JP

    t = {k: jnp.asarray(v) for k, v in GC.temporal_case(name).items()}
    j = t["cf_idx"]
    two = 2 * GC.PP
    cp = t["cf_pat"].astype(jnp.bfloat16).astype(jnp.float32)[j]
    cok = t["cf_ok"][j]
    cd = t["cf_desc"].astype(jnp.bfloat16)[j]
    out = [_ncc4(JP, t["kf_pat_l"][:, None], t["kf_ok_l"][:, None],
                 cp[..., :two], cok[..., :2]),
           _ncc4(JP, t["kf_pat_r"][:, None], t["kf_ok_r"][:, None],
                 cp[..., two:], cok[..., 2:]),
           JD.min_cross_distance_dot(t["kf_desc_l"].astype(jnp.bfloat16),
                                     cd[..., :256]),
           JD.min_cross_distance_dot(t["kf_desc_r"].astype(jnp.bfloat16),
                                     cd[..., 256:])]
    return np.stack([np.asarray(o) for o in out])


def patches(name):
    """(pat (B, 2 P^2) float32, ok (B, 2) bool) of `edge_patches_tiled`."""
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.ops import patches as JP

    img, edges = GC.patch_case(name)
    pp, pm, okp, okm = JP.edge_patches_tiled(
        jnp.asarray(img), *(jnp.asarray(a) for a in edges), GC.P, GC.SHIFT)
    return (np.concatenate([np.asarray(pp), np.asarray(pm)], 1),
            np.stack([np.asarray(okp), np.asarray(okm)], 1))


def arrays():
    out = {}
    for name in GC.GATE_CASES:
        out[f"stereo/{name}/dist"], out[f"stereo/{name}/ncc"] = stereo(name)
        out[f"temporal/{name}"] = temporal(name)
    for name in GC.PATCH_CASES:
        out[f"patches/{name}/pat"], out[f"patches/{name}/ok"] = patches(name)
    return out


def main():
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    out = arrays()
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays")


if __name__ == "__main__":
    main()
