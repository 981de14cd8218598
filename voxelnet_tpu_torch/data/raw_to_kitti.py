"""Synthesize a KITTI *detection*-format dataset from a KITTI *raw* drive:
the port's copy of `voxelnet_tpu/data/raw_to_kitti.py`, writing the same
label and calib text byte for byte.

The reference repo ships a raw drive (data/2011_09_26_drive_0001: velodyne
frames + tracklet_labels.xml + calib) but trains on the KITTI detection
split. This tool converts the raw drive's tracklet annotations into
detection-format `label_2` / `calib` / `velodyne` / `image_2` trees so
training and AP evaluation run end-to-end on real LiDAR without the
detection split.

Conversion per frame:
  * velodyne `.bin` and cam-2 `.png` are copied/symlinked with `%06d` tags.
  * calib: detection 7-line format from the raw drive's
    calib_cam_to_cam.txt (P_rect_02, R_rect_00) + calib_velo_to_cam.txt.
  * labels: each tracklet pose is a lidar-frame box (bottom-center x,y,z,
    size h,w,l, yaw rz) -> camera coords via the drive calib; 2D bbox from
    projecting the 8 corners, clipped to the image; truncation = clipped
    area fraction; occlusion from the tracklet state; alpha = ry -
    arctan2(x_cam, z_cam).

    python -m voxelnet_tpu_torch.data.raw_to_kitti \
        --raw-root data/2011_09_26 --drive 0001 \
        --out-dir kitti_from_raw --val-every 4
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from voxelnet_tpu_torch.utils import geometry, tracklets

# raw-tracklet occlusion code -> KITTI object occluded field
_OCC_MAP = {tracklets.OCC_VISIBLE: 0, tracklets.OCC_PARTLY: 1,
            tracklets.OCC_FULLY: 2, tracklets.OCC_UNSET: 2}


def load_raw_calib(raw_root: str):
    """Read the drive's calib pair -> (P2 (3,4), R0 (3,3), Tr (3,4))."""
    cam = {}
    with open(os.path.join(raw_root, "calib_cam_to_cam.txt")) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                cam[k.strip()] = v.split()
    P2 = np.array(cam["P_rect_02"], np.float64).reshape(3, 4)
    R0 = np.array(cam["R_rect_00"], np.float64).reshape(3, 3)

    velo = {}
    with open(os.path.join(raw_root, "calib_velo_to_cam.txt")) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                velo[k.strip()] = v.split()
    R = np.array(velo["R"], np.float64).reshape(3, 3)
    T = np.array(velo["T"], np.float64).reshape(3, 1)
    Tr = np.concatenate([R, T], axis=1)
    return P2, R0, Tr


def detection_calib_text(P2, R0, Tr) -> str:
    """Emit the 7-line KITTI detection calib format `utils.kitti.load_calib`
    expects (P0..P3, R0_rect, Tr_velo_to_cam, Tr_imu_to_velo)."""
    def row(name, mat):
        return name + ": " + " ".join(f"{v:.12e}" for v in
                                      np.asarray(mat).ravel())

    eye34 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    return "\n".join([
        row("P0", P2), row("P1", P2), row("P2", P2), row("P3", P2),
        row("R0_rect", R0), row("Tr_velo_to_cam", Tr),
        row("Tr_imu_to_velo", eye34),
    ]) + "\n"


def tracklet_label_lines(frame_tracklets, P2, R0, Tr,
                         img_w: int, img_h: int) -> list[str]:
    """One frame's tracklet poses -> KITTI 15-field label lines.

    frame_tracklets: list of (object_type, size (h,w,l), trans (3,),
    yaw_rz, occlusion_code). Objects whose projection misses the image
    entirely are dropped (they are invisible to the cam-2 labeler).
    """
    T44 = np.eye(4)
    T44[:3, :] = Tr
    R44 = np.eye(4)
    R44[:3, :3] = R0

    lines = []
    for obj_type, size, trans, rz, occ in frame_tracklets:
        h, w, l = (float(v) for v in size)
        lidar_box = np.array([[trans[0], trans[1], trans[2], h, w, l, rz]])
        cam_box = geometry.lidar_to_camera_boxes(lidar_box, T44, R44)[0]
        x, y, z = cam_box[:3]
        ry = cam_box[6]
        # KITTI label convention: y is the box BOTTOM in camera coords
        # (+y points down); lidar_to_camera_boxes converts the lidar
        # bottom-center, which is what the label stores.
        if z <= 0.5:          # behind / at the camera plane
            continue
        corners = geometry.center_to_corner_box3d(
            lidar_box, coordinate="lidar")[0]           # (8, 3) lidar
        cam_pts = geometry.lidar_to_camera_points(corners, T44, R44)
        depths = cam_pts[:, 2]
        if (depths <= 0.1).any():                       # clips camera plane
            continue
        uv = (P2[:3, :3] @ cam_pts.T + P2[:3, 3:4]).T
        uv = uv[:, :2] / uv[:, 2:3]
        x1, y1 = uv[:, 0].min(), uv[:, 1].min()
        x2, y2 = uv[:, 0].max(), uv[:, 1].max()
        cx1, cy1 = max(x1, 0.0), max(y1, 0.0)
        cx2, cy2 = min(x2, float(img_w)), min(y2, float(img_h))
        if cx2 <= cx1 or cy2 <= cy1:                    # fully outside
            continue
        area = (x2 - x1) * (y2 - y1)
        clipped = (cx2 - cx1) * (cy2 - cy1)
        trunc = float(np.clip(1.0 - clipped / max(area, 1e-9), 0.0, 1.0))
        # KITTI alpha spans [-pi, pi]; folding into [-pi/2, pi/2) (the
        # detector's yaw convention) would erase heading and corrupt AOS
        alpha = float((ry - np.arctan2(x, z) + np.pi) % (2 * np.pi) - np.pi)
        fields = [trunc, float(_OCC_MAP.get(int(occ), 2)), alpha,
                  cx1, cy1, cx2, cy2, h, w, l,
                  float(x), float(y), float(z), float(ry)]
        body = " ".join(f"{v:.4f}" if isinstance(v, float) else f"{v:.0f}"
                        for v in fields)
        # occluded must be an int field
        parts = body.split()
        parts[1] = str(int(float(parts[1])))
        lines.append(f"{obj_type} " + " ".join(parts) + "\n")
    return lines


def convert_drive(raw_root: str, drive: str, out_dir: str,
                  val_every: int = 4, symlink: bool = True,
                  img_w: int = 1242, img_h: int = 375,
                  split_mode: str = "block",
                  val_frac: float = 0.25) -> dict:
    """Convert one synchronized raw drive into training/validation splits.

    split_mode='block' (default): the LAST ceil(val_frac * n) frames form
    a contiguous validation block. A drive is one continuous scene, so an
    interleaved split puts val frames seconds away from train frames of
    the same instant — AP then partly measures scene memorization. The
    contiguous tail is the least-leaky split a single drive allows.

    split_mode='interleave': every `val_every`-th frame -> validation
    (both splits cover the whole drive; maximally leaky — kept for
    comparison runs against the round-2 numbers).

    Returns per-split frame counts.
    """
    date = os.path.basename(os.path.normpath(raw_root))
    sync = os.path.join(raw_root, f"{date}_drive_{drive}_sync")
    velo_dir = os.path.join(sync, "velodyne_points", "data")
    img_dir = os.path.join(sync, "image_02", "data")
    frames = sorted(f[:-4] for f in os.listdir(velo_dir)
                    if f.endswith(".bin"))

    P2, R0, Tr = load_raw_calib(raw_root)
    calib_txt = detection_calib_text(P2, R0, Tr)
    xml_path = os.path.join(sync, "tracklet_labels.xml")
    if not os.path.exists(xml_path):
        xml_path = os.path.join(raw_root, "tracklet_labels.xml")
    tracks = tracklets.parse_xml(xml_path)
    per_frame: dict[int, list] = {}
    for t in tracks:
        for trans, rot, state, occ, trunc, _a, _b, frame in t:
            per_frame.setdefault(frame, []).append(
                (t.object_type, t.size, trans, float(rot[2]), int(occ[0])))

    if split_mode not in ("block", "interleave"):
        raise ValueError(f"unknown split_mode {split_mode!r}")
    n_val = int(np.ceil(len(frames) * val_frac)) \
        if split_mode == "block" else 0
    val_start = len(frames) - n_val

    counts = {"training": 0, "validation": 0, "objects": 0}
    place = os.symlink if symlink else shutil.copy2
    for i, frame in enumerate(frames):
        if split_mode == "block":
            split = "validation" if i >= val_start else "training"
        else:
            split = "validation" if (i % val_every) == (val_every - 1) \
                else "training"
        tag = f"{i:06d}"
        root = os.path.join(out_dir, split)
        for sub in ("velodyne", "image_2", "label_2", "calib"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        dst_bin = os.path.join(root, "velodyne", tag + ".bin")
        if not os.path.exists(dst_bin):
            place(os.path.abspath(os.path.join(velo_dir, frame + ".bin")),
                  dst_bin)
        src_png = os.path.join(img_dir, frame + ".png")
        dst_png = os.path.join(root, "image_2", tag + ".png")
        if os.path.exists(src_png) and not os.path.exists(dst_png):
            place(os.path.abspath(src_png), dst_png)
        with open(os.path.join(root, "calib", tag + ".txt"), "w") as f:
            f.write(calib_txt)
        lines = tracklet_label_lines(
            per_frame.get(int(frame), []), P2, R0, Tr, img_w, img_h)
        with open(os.path.join(root, "label_2", tag + ".txt"), "w") as f:
            f.writelines(lines)
        counts[split] += 1
        counts["objects"] += len(lines)
    return counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--raw-root", required=True,
                   help="date dir, e.g. .../data/2011_09_26")
    p.add_argument("--drive", default="0001")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--split-mode", default="block",
                   choices=("block", "interleave"),
                   help="block: contiguous val tail (least scene leakage);"
                        " interleave: every Nth frame -> val")
    p.add_argument("--val-frac", type=float, default=0.25,
                   help="block mode: fraction of frames in the val tail")
    p.add_argument("--val-every", type=int, default=4,
                   help="interleave mode: every Nth frame -> validation")
    p.add_argument("--copy", action="store_true",
                   help="copy instead of symlink")
    args = p.parse_args(argv)
    counts = convert_drive(args.raw_root, args.drive, args.out_dir,
                           val_every=args.val_every,
                           symlink=not args.copy,
                           split_mode=args.split_mode,
                           val_frac=args.val_frac)
    print(counts)


if __name__ == "__main__":
    main()
