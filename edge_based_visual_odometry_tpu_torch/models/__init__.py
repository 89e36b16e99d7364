"""Frame-level models: stereo cascade, temporal quads, pose, pipeline."""
