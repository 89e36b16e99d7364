"""Dataset iterators: KITTI / EuRoC / ETH3D-stereo / ETH3D-SLAM.

Numpy-only copy of `edge_based_visual_odometry_tpu/io/datasets.py` (it reads
the port's own `pfm` and `native_loader`; image decoders are imported
inside the branch that needs them). Host-side Python re-design of the reference's iterator stack
(src/Stereo_Iterator.cpp, dispatched from Dataset::load_dataset,
src/Dataset.cpp:158-206). Layout conventions mirror the reference exactly:

  KITTI       <dataset_dir>/<sequence>/image_{0,1}/NNNNNN.png, GT poses as
              12-number row-major [R|t] lines (ref :84-184)
  EuRoC       <seq>/mav0/cam{0,1}/data/<ts>.png driven by cam0/data.csv,
              GT from state_groundtruth_estimate0/data.csv with the
              body->camera transform chain (ref :18-78, :484-558)
  ETH3D_stereo <seq>/stereo_pairs/<pair>/im{0,1}.png + images.txt COLMAP
              GT + GT disparity PFMs + occlusion masks (ref :189-301;
              Dataset.cpp:208-316)
  ETH3D_slam  <seq>/rgb.txt (right) + rgb2/ (left) TUM lists +
              groundtruth.txt with nearest-timestamp alignment
              (ref :307-478)
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from edge_based_visual_odometry_tpu_torch.io.pfm import read_pfm


def _imread_gray(path: str) -> Optional[np.ndarray]:
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            return None
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image
        if not os.path.exists(path):
            return None
        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


@dataclasses.dataclass
class StereoSample:
    """Host-side frame record (reference StereoFrame,
    include/Stereo_Iterator.h:71-95, pre-device parts)."""

    left: np.ndarray
    right: np.ndarray
    timestamp: float
    gt_R: Optional[np.ndarray] = None          # CAM->WORLD, every format
    gt_t: Optional[np.ndarray] = None          # (the CLI inverts once)    
    left_disparity: Optional[np.ndarray] = None
    right_disparity: Optional[np.ndarray] = None
    left_occlusion: Optional[np.ndarray] = None
    right_occlusion: Optional[np.ndarray] = None
    # absolute position in the dataset's FILE list (decode failures make
    # this differ from the processed-frame count; checkpoint resume keys
    # on it so skipped bad files cannot desync the restart point)
    file_idx: int = -1


def _quat_to_R(qw, qx, qy, qz):
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _iter_path_pairs(pairs: List[Tuple[str, str]],
                     metas: List[StereoSample],
                     image_hw: Optional[Tuple[int, int]] = None,
                     prefetch: bool = True,
                     start: int = 0) -> Iterator[StereoSample]:
    """Decode (left, right) path pairs into the pre-built StereoSample
    shells. With `image_hw` and the native loader available, decode runs
    on background C++ threads ahead of consumption (io/native/loader.cpp)
    so host I/O overlaps device compute - the reference's
    producer/consumer split (Stereo_Iterator.cpp:58-80). Falls back to
    synchronous cv2/PIL decode otherwise. Decode failures skip the frame
    either way (reference behavior, Stereo_Iterator.cpp:74).

    `start`: checkpoint-resume offset in FILE-LIST positions - the first
    `start` samples are yielded METADATA-ONLY (timestamps/GT, left/right
    = None, no image decode): the consumer skips them anyway, and
    decoding thousands of pre-resume PNGs wastes minutes of startup
    I/O."""
    for i, s in enumerate(metas):
        s.file_idx = i
    if start:
        for s in metas[:start]:
            yield s
        pairs = pairs[start:]
        metas = metas[start:]
    if prefetch and image_hw is not None:
        yielded = 0
        try:
            from edge_based_visual_odometry_tpu_torch.io import native_loader as NL
            if NL.native_available():
                loader = NL.PrefetchLoader(pairs, image_hw[0], image_hw[1])
                try:
                    for idx, left, right in loader:
                        # yield a COPY carrying the images; the long-lived
                        # metas list stays imageless, else a full sequence
                        # accumulates every decoded frame in host RAM
                        # (~17 GB over a 4500-frame KITTI run)
                        yield dataclasses.replace(metas[idx], left=left,
                                                  right=right)
                        yielded += 1
                finally:
                    loader.close()
                if yielded or not pairs:
                    return
                # Every native decode failed - typically the rig resolution
                # in the YAML differs from the actual image dims (the
                # native decoder enforces the rig size; cv2/PIL don't).
                # Don't finish a silent empty run: fall back to sync decode.
                import sys
                print(f"warning: native loader decoded 0 of {len(pairs)} "
                      "pairs (image dims != rig resolution?); falling back "
                      "to synchronous decode", file=sys.stderr)
        except Exception:
            # Fall back to synchronous decode ONLY if nothing was yielded
            # yet: restarting from pair 0 after a mid-iteration failure
            # would deliver duplicate frames to the VO loop.
            if yielded:
                raise
    n_bad = 0
    for (lp, rp), s in zip(pairs, metas):
        left = _imread_gray(lp)
        right = _imread_gray(rp)
        if left is None or right is None:
            n_bad += 1
            if n_bad <= 3:
                import sys
                print(f"warning: failed to decode stereo pair "
                      f"({lp}, {rp}); skipping", file=sys.stderr)
            continue
        # copy for the same reason as the prefetch path above
        yield dataclasses.replace(s, left=left, right=right)


def iter_kitti(sequence_path: str, gt_path: str = "",
               image_hw: Optional[Tuple[int, int]] = None,
               prefetch: bool = True,
               start: int = 0) -> Iterator[StereoSample]:
    """KITTI odometry grayscale pairs (ref :84-184)."""
    left_dir = os.path.join(sequence_path, "image_0")
    n = len([f for f in os.listdir(left_dir) if f.endswith(".png")])
    gt_lines: List[str] = []
    if gt_path and os.path.exists(gt_path):
        with open(gt_path) as f:
            gt_lines = [ln for ln in f.read().splitlines() if ln.strip()]
    pairs, metas = [], []
    for i in range(n):
        fn = f"{i:06d}.png"
        pairs.append((os.path.join(sequence_path, "image_0", fn),
                      os.path.join(sequence_path, "image_1", fn)))
        s = StereoSample(left=None, right=None, timestamp=float(i))
        if i < len(gt_lines):
            v = [float(x) for x in gt_lines[i].split()]
            if len(v) >= 12:
                s.gt_R = np.array([[v[0], v[1], v[2]],
                                   [v[4], v[5], v[6]],
                                   [v[8], v[9], v[10]]])
                s.gt_t = np.array([v[3], v[7], v[11]])
        metas.append(s)
    return _iter_path_pairs(pairs, metas, image_hw, prefetch, start)


def _load_euroc_gt(gt_csv: str, R_f2b: np.ndarray, t_f2b: np.ndarray):
    """Preload GT poses with the body->world * frame->body chain
    (ref :484-558, :565-627). Returns sorted (ts, R, t) list of
    world_from_camera transforms."""
    poses = []
    with open(gt_csv) as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if len(row) < 8:
                continue
            try:
                ts = float(row[0])
                t_b = np.array([float(row[1]), float(row[2]), float(row[3])])
                R_b = _quat_to_R(float(row[4]), float(row[5]),
                                 float(row[6]), float(row[7]))
            except ValueError:
                continue
            R = R_b @ R_f2b
            t = R_b @ t_f2b + t_b
            poses.append((ts, R, t))
    poses.sort(key=lambda p: p[0])
    return poses


def _nearest_pose(poses, ts: float, times=None):
    """Nearest-timestamp GT lookup (ref :594-627). Callers looping over
    frames should pass `times` = [p[0] for p in poses] computed ONCE:
    rebuilding it per call makes GT alignment O(n_frames * n_gt_rows)
    (~70M list ops on EuRoC's 200 Hz ground truth)."""
    if not poses:
        return None
    if times is None:
        times = [p[0] for p in poses]
    import bisect
    i = bisect.bisect_left(times, ts)
    if i >= len(poses):
        i = len(poses) - 1
    elif i > 0 and abs(times[i - 1] - ts) < abs(times[i] - ts):
        i -= 1
    return poses[i]


def iter_euroc(seq_path: str, R_frame2body: Optional[np.ndarray] = None,
               t_frame2body: Optional[np.ndarray] = None,
               image_hw: Optional[Tuple[int, int]] = None,
               prefetch: bool = True,
               start: int = 0) -> Iterator[StereoSample]:
    """EuRoC MAV format with GT alignment (ref :18-78, :633-665)."""
    base = os.path.join(seq_path, "mav0")
    csv_path = os.path.join(base, "cam0", "data.csv")
    gt_csv = os.path.join(base, "state_groundtruth_estimate0", "data.csv")
    R_f2b = np.eye(3) if R_frame2body is None else np.asarray(R_frame2body)
    t_f2b = np.zeros(3) if t_frame2body is None else np.asarray(t_frame2body)
    poses = _load_euroc_gt(gt_csv, R_f2b, t_f2b) if os.path.exists(gt_csv) else []
    gt_times = [p[0] for p in poses]

    pairs, metas = [], []
    with open(csv_path) as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if not row:
                continue
            ts_str = row[0].strip()
            pairs.append((os.path.join(base, "cam0", "data", ts_str + ".png"),
                          os.path.join(base, "cam1", "data", ts_str + ".png")))
            s = StereoSample(left=None, right=None, timestamp=float(ts_str))
            p = _nearest_pose(poses, float(ts_str), gt_times)
            if p is not None:
                s.gt_R, s.gt_t = p[1], p[2]
            metas.append(s)
    return _iter_path_pairs(pairs, metas, image_hw, prefetch, start)


def iter_eth3d_stereo(seq_path: str,
                      start: int = 0) -> Iterator[StereoSample]:
    """ETH3D two-view folders with GT disparity PFMs + occlusion masks
    (ref :189-301; disparity loading Dataset.cpp:208-316). The first
    `start` samples are metadata-only (checkpoint resume; see
    _iter_path_pairs)."""
    pairs_path = os.path.join(seq_path, "stereo_pairs")
    folders = sorted(
        os.path.join(pairs_path, d) for d in os.listdir(pairs_path)
        if os.path.isdir(os.path.join(pairs_path, d)))
    for k, folder in enumerate(folders):
        skip_decode = k < start
        if skip_decode:
            left = right = None
        else:
            left = _imread_gray(os.path.join(folder, "im0.png"))
            right = _imread_gray(os.path.join(folder, "im1.png"))
            if left is None or right is None:
                continue
        s = StereoSample(left=left, right=right, timestamp=float(k),
                          file_idx=k)
        for attr, name in (("left_disparity", "disp0GT.pfm"),
                           ("right_disparity", "disp1GT.pfm")):
            p = os.path.join(folder, name)
            if not skip_decode and os.path.exists(p):
                setattr(s, attr, read_pfm(p))
        # Non-occlusion masks: 255 = visible in both views
        # (LoadETH3DOcclusionMasks, Dataset.cpp:226 - mask{0,1}nocc.png)
        for attr, name in (("left_occlusion", "mask0nocc.png"),
                           ("right_occlusion", "mask1nocc.png")):
            p = os.path.join(folder, name)
            if not skip_decode and os.path.exists(p):
                setattr(s, attr, _imread_gray(p))
        # COLMAP-style images.txt GT for im0 (ref :245-301). COLMAP
        # stores WORLD->CAM (x_cam = R x_world + t); StereoSample.gt_* is
        # cam->world like every other iterator (KITTI poses, EuRoC body
        # chain, TUM), so invert here. Getting this backwards silently
        # halves the temporal-cascade recall vs the reference binary
        # (caught by tests/test_ref_binary_e2e.py).
        images_txt = os.path.join(folder, "images.txt")
        if os.path.exists(images_txt):
            with open(images_txt) as f:
                for line in f:
                    tok = line.split()
                    if len(tok) >= 10 and tok[9] == "im0.png":
                        R_w2c = _quat_to_R(float(tok[1]), float(tok[2]),
                                           float(tok[3]), float(tok[4]))
                        t_w2c = np.array([float(tok[5]), float(tok[6]),
                                          float(tok[7])])
                        s.gt_R = R_w2c.T
                        s.gt_t = -R_w2c.T @ t_w2c
                        break
        yield s


def iter_eth3d_slam(seq_path: str,
                    image_hw: Optional[Tuple[int, int]] = None,
                    prefetch: bool = True,
                    start: int = 0) -> Iterator[StereoSample]:
    """ETH3D SLAM format: rgb.txt lists the RIGHT camera (rgb/), rgb2/ is
    the LEFT camera (ref :441-443); TUM groundtruth.txt aligned by nearest
    timestamp (ref :353-420)."""
    image_list = []
    with open(os.path.join(seq_path, "rgb.txt")) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) >= 2:
                image_list.append((float(tok[0]), tok[1]))
    poses = []
    gt_file = os.path.join(seq_path, "groundtruth.txt")
    if os.path.exists(gt_file):
        with open(gt_file) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                tok = [float(x) for x in line.split()]
                if len(tok) >= 8:
                    R = _quat_to_R(tok[7], tok[4], tok[5], tok[6])
                    poses.append((tok[0], R, np.array(tok[1:4])))
        poses.sort(key=lambda p: p[0])
    gt_times = [p[0] for p in poses]
    pairs, metas = [], []
    for ts, filename in image_list:
        pairs.append((os.path.join(seq_path, "rgb2", filename[4:]),
                      os.path.join(seq_path, filename)))
        s = StereoSample(left=None, right=None, timestamp=ts)
        p = _nearest_pose(poses, ts, gt_times)
        if p is not None:
            s.gt_R, s.gt_t = p[1], p[2]
        metas.append(s)
    return _iter_path_pairs(pairs, metas, image_hw, prefetch, start)


def make_iterator(dataset_type: str, dataset_dir: str, sequence_name: str,
                  gt_file_path: str = "",
                  R_frame2body: Optional[np.ndarray] = None,
                  t_frame2body: Optional[np.ndarray] = None,
                  image_hw: Optional[Tuple[int, int]] = None,
                  prefetch: bool = True,
                  start: int = 0) -> Iterator[StereoSample]:
    """Factory mirroring Dataset::load_dataset (src/Dataset.cpp:158-206).

    `image_hw`: (height, width) of the rig's images; enables the native
    prefetching decoder (background C++ threads) for the PNG-pair formats
    when the shared library builds. `prefetch=False` forces synchronous
    decode. ETH3D_stereo always decodes synchronously (PFM disparities +
    masks accompany each pair)."""
    seq = os.path.join(dataset_dir, sequence_name)
    if dataset_type == "KITTI":
        gt_file = ""
        if gt_file_path:
            seq_id = sequence_name.rsplit("/", 1)[-1]
            gt_file = os.path.join(dataset_dir, gt_file_path, seq_id + ".txt")
        return iter_kitti(seq, gt_file, image_hw, prefetch, start)
    if dataset_type == "EuRoC":
        return iter_euroc(seq, R_frame2body, t_frame2body, image_hw,
                          prefetch, start)
    if dataset_type == "ETH3D_stereo":
        return iter_eth3d_stereo(seq, start)
    if dataset_type == "ETH3D_slam":
        return iter_eth3d_slam(seq, image_hw, prefetch, start)
    raise ValueError(f"unknown dataset_type {dataset_type!r}")
