"""CLI for the offline analysis suite.

Usage (against a main_vo_torch.py or main_vo.py output directory):

  python -m edge_based_visual_odometry_tpu_torch.viz edges EDGES.txt out.png [--image IMG]
  python -m edge_based_visual_odometry_tpu_torch.viz pairs PAIRS.txt out.png \
      [--left IMG --right IMG] [--links 100]
  python -m edge_based_visual_odometry_tpu_torch.viz triage DISP.txt out.png [--image IMG]
  python -m edge_based_visual_odometry_tpu_torch.viz quads QUADS.txt out.png \
      [--kf IMG --cf IMG]
  python -m edge_based_visual_odometry_tpu_torch.viz dist DIST.txt out.png
  python -m edge_based_visual_odometry_tpu_torch.viz ambiguity AMB.txt out.png
  python -m edge_based_visual_odometry_tpu_torch.viz trajectory EST.tum out.png \
      [--gt GT.tum] [--plane xz]
  python -m edge_based_visual_odometry_tpu_torch.viz all OUTPUT_DIR VIZ_DIR

`all` sweeps an output directory and renders every dump it recognizes
(the batch mode the reference drives by editing paths in each .m script).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from edge_based_visual_odometry_tpu_torch.viz import plots as P


def _render_all(out_dir: str, viz_dir: str) -> int:
    os.makedirs(viz_dir, exist_ok=True)
    n = 0

    def dst(src: str) -> str:
        return os.path.join(
            viz_dir, os.path.splitext(os.path.basename(src))[0] + ".png")

    for f in sorted(glob.glob(os.path.join(out_dir, "toed_edges_*.txt"))):
        P.plot_edges_on_image(dst(f), P.load_toed_edges(f),
                              title=os.path.basename(f))
        n += 1
    for f in sorted(glob.glob(
            os.path.join(out_dir, "finalized_stereo_edge_pairs_frame_*.txt"))):
        P.plot_stereo_pairs(dst(f), P.load_finalized_pairs(f))
        n += 1
    for f in sorted(glob.glob(os.path.join(out_dir, "disparities_frame_*.txt"))):
        P.plot_match_triage(dst(f), P.load_disparities(f))
        n += 1
    for f in sorted(glob.glob(os.path.join(out_dir, "quads_frame_*.txt"))):
        P.plot_quads(dst(f), P.load_quads(f))
        n += 1
    for f in sorted(glob.glob(os.path.join(out_dir, "ambiguity_*_frame_*.txt"))):
        stage = re.sub(r"^ambiguity_(.*)_frame_\d+\.txt$", r"\1",
                       os.path.basename(f))
        P.plot_ambiguity_distribution(dst(f), P.load_ambiguity_distribution(f),
                                      stage_name=stage)
        n += 1
    for f in sorted(glob.glob(os.path.join(out_dir, "*_frame_*.txt"))):
        base = os.path.basename(f)
        if base.startswith(("toed_edges", "finalized_stereo", "disparities",
                            "quads", "ambiguity",
                            # io.h eval-cluster dumps: per-cluster rows,
                            # not filter distributions - would misparse
                            # into meaningless histograms
                            "photo_refine_data", "matching_edge_clusters",
                            "false_negative_edge_clusters")):
            continue
        try:
            dist = P.load_filter_distribution(f)
        except Exception:
            continue
        P.plot_filter_distribution(dst(f), dist,
                                   filter_name=re.sub(r"_frame_\d+\.txt$", "",
                                                      base))
        n += 1
    for f in sorted(glob.glob(os.path.join(out_dir, "trajectory*.txt")) +
                    glob.glob(os.path.join(out_dir, "*.tum"))):
        P.plot_trajectory(dst(f), P.load_trajectory_tum(f))
        n += 1
    print(f"rendered {n} figures to {viz_dir}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="edge_based_visual_odometry_tpu_torch.viz")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, *extra):
        p = sub.add_parser(name)
        p.add_argument("input")
        p.add_argument("output")
        for flag, kw in extra:
            p.add_argument(flag, **kw)
        return p

    add("edges", ("--image", dict(default=None)))
    add("pairs", ("--left", dict(default=None)), ("--right", dict(default=None)),
        ("--links", dict(type=int, default=100)))
    add("triage", ("--image", dict(default=None)),
        ("--tp_tol", dict(type=float, default=1.0)),
        ("--inacc_tol", dict(type=float, default=2.0)))
    add("quads", ("--kf", dict(default=None)), ("--cf", dict(default=None)))
    add("dist")
    add("ambiguity")
    add("trajectory", ("--gt", dict(default=None)),
        ("--plane", dict(default="xz", choices=["xz", "xy", "yz"])))
    add("all")

    args = ap.parse_args(argv)
    if args.cmd == "edges":
        P.plot_edges_on_image(args.output, P.load_toed_edges(args.input),
                              image=args.image)
    elif args.cmd == "pairs":
        P.plot_stereo_pairs(args.output, P.load_finalized_pairs(args.input),
                            left_image=args.left, right_image=args.right,
                            n_links=args.links)
    elif args.cmd == "triage":
        counts = P.plot_match_triage(args.output, P.load_disparities(args.input),
                                     left_image=args.image, tp_tol=args.tp_tol,
                                     inacc_tol=args.inacc_tol)
        print(counts)
    elif args.cmd == "quads":
        P.plot_quads(args.output, P.load_quads(args.input),
                     kf_image=args.kf, cf_image=args.cf)
    elif args.cmd == "dist":
        P.plot_filter_distribution(args.output,
                                   P.load_filter_distribution(args.input),
                                   filter_name=os.path.basename(args.input))
    elif args.cmd == "ambiguity":
        P.plot_ambiguity_distribution(
            args.output, P.load_ambiguity_distribution(args.input),
            stage_name=os.path.basename(args.input))
    elif args.cmd == "trajectory":
        gt = P.load_trajectory_tum(args.gt) if args.gt else None
        P.plot_trajectory(args.output, P.load_trajectory_tum(args.input),
                          gt=gt, plane=args.plane)
    elif args.cmd == "all":
        _render_all(args.input, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
