"""Offline analysis & visualization suite.

Python/matplotlib equivalent of the reference's MATLAB analysis layer
(reference test/*.m, 23 scripts): edge overlays, stereo-match montages and
GT triage, temporal quad (KF<->CF) overlays, filter/ambiguity distribution
histograms, and trajectory plots. All functions consume the text dump
formats written by `utils/debug_io.py` / `utils/metrics.py` (which mirror
the reference's io.h writers), so the suite works on any `main_vo_torch.py`
or `main_vo.py` output directory (`--save_viz` renders one).

Run as a CLI: `python -m edge_based_visual_odometry_tpu_torch.viz <cmd> ...`.
"""

from edge_based_visual_odometry_tpu_torch.viz.plots import (  # noqa: F401
    dump_ncc_debug,
    load_ambiguity_distribution,
    load_disparities,
    load_filter_distribution,
    load_finalized_pairs,
    load_quads,
    load_toed_edges,
    load_trajectory_tum,
    plot_ambiguity_distribution,
    plot_edges_on_image,
    plot_filter_distribution,
    plot_match_triage,
    plot_quads,
    plot_stereo_pairs,
    plot_trajectory,
)
