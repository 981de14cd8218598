"""KITTI *raw* drive tooling: frame statistics plots and clip export; the
port's copy of `voxelnet_tpu/utils/raw_drive.py`.

Capability parity with the reference's standalone viz scripts
(utils/visualize.py:1-196, utils/create_clip_pcl.py, utils/
create_clip_3d_boxes.py): load a raw drive (without the pykitti
dependency — plain file readers), plot camera views + 3D point cloud with
tracklet boxes, and export point-cloud / box-overlay clips. Camera images
are read by `utils/image_io.py` and the box overlays drawn by
`utils/raster.py`, so only the video clip needs cv2 (its VideoWriter);
matplotlib and cv2 are imported lazily, as in the JAX package.

    python -m voxelnet_tpu_torch.utils.raw_drive stats --drive-dir data/2011_09_26 \
        --date 2011_09_26 --drive 0001 --frame 10 --out frame10.png
    python -m voxelnet_tpu_torch.utils.raw_drive clip-pcl ... --out clip.gif
    python -m voxelnet_tpu_torch.utils.raw_drive clip-boxes ... --out clip.mp4
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from voxelnet_tpu_torch.utils import image_io, raster
from voxelnet_tpu_torch.utils.tracklets import parse_xml, tracklets_per_frame

# tracklet box edges: bottom face, top face, vertical struts
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]

_TYPE_COLORS = {
    "Car": "#fb8072", "Van": "#80b1d3", "Truck": "#fdb462",
    "Pedestrian": "#b3de69", "Cyclist": "#bc80bd", "Tram": "#8dd3c7",
    "Misc": "#d9d9d9",
}


class RawDrive:
    """Loader for one synced+rectified KITTI raw drive."""

    def __init__(self, base_dir: str, date: str, drive: str):
        self.dir = os.path.join(base_dir, date,
                                f"{date}_drive_{drive}_sync")
        if not os.path.isdir(self.dir):
            raise FileNotFoundError(self.dir)
        self.velo_files = sorted(
            glob.glob(os.path.join(self.dir, "velodyne_points/data/*.bin")))
        self.cam_files = {
            cam: sorted(glob.glob(
                os.path.join(self.dir, f"image_{cam:02d}/data/*.png")))
            for cam in range(4)
        }

    def __len__(self):
        return len(self.velo_files)

    def velo(self, frame: int) -> np.ndarray:
        return np.fromfile(self.velo_files[frame],
                           np.float32).reshape(-1, 4)

    def image(self, frame: int, cam: int = 2):
        """Camera `cam`'s image of `frame`, RGB uint8 (H, W, 3)."""
        return raster.bgr_to_rgb(
            image_io.read_png_bgr(self.cam_files[cam][frame]))

    def tracklets(self):
        path = os.path.join(self.dir, "tracklet_labels.xml")
        boxes, types = tracklets_per_frame(parse_xml(path), len(self))
        return boxes, types


def _draw_box_3d(ax, corners, color, axes=(0, 1, 2)):
    for i, j in _EDGES:
        ax.plot(*[(corners[i, a], corners[j, a]) for a in axes],
                color=color, lw=0.8)


def display_frame_statistics(drive: RawDrive, frame: int, out_path: str,
                             points_step: int = 5):
    """4-camera grid + 3D scatter + 3 plane projections with boxes
    (reference utils/visualize.py `display_frame_statistics`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    boxes, types = drive.tracklets()
    velo = drive.velo(frame)[::points_step]

    fig = plt.figure(figsize=(15, 12))
    for cam in range(4):
        ax = fig.add_subplot(4, 2, cam + 1)
        ax.imshow(drive.image(frame, cam))
        ax.set_title(f"cam {cam}")
        ax.axis("off")

    ax3d = fig.add_subplot(4, 2, (5, 6), projection="3d")
    ax3d.scatter(velo[:, 0], velo[:, 1], velo[:, 2], s=0.1, c="#888888")
    for corners, typ in zip(boxes[frame], types[frame]):
        _draw_box_3d(ax3d, corners, _TYPE_COLORS.get(typ, "#000000"))
    ax3d.set_title("3D point cloud")

    for k, (a, b, name) in enumerate(
            [(0, 1, "XY (BEV)"), (0, 2, "XZ"), (1, 2, "YZ")]):
        ax = fig.add_subplot(4, 3, 10 + k)
        ax.scatter(velo[:, a], velo[:, b], s=0.05, c="#888888")
        for corners, typ in zip(boxes[frame], types[frame]):
            _draw_box_3d(ax, corners, _TYPE_COLORS.get(typ, "#000000"),
                         axes=(a, b))
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def create_clip_pcl(drive: RawDrive, out_path: str, max_frames: int = 50,
                    points_step: int = 8):
    """Animated BEV point-cloud clip (reference utils/create_clip_pcl.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    frames = min(len(drive), max_frames)

    def update(i):
        ax.clear()
        velo = drive.velo(i)[::points_step]
        ax.scatter(velo[:, 0], velo[:, 1], s=0.05, c=velo[:, 3],
                   cmap="viridis")
        ax.set_xlim(-80, 80)
        ax.set_ylim(-80, 80)
        ax.set_title(f"frame {i}")
        return []

    anim = animation.FuncAnimation(fig, update, frames=frames, blit=False)
    anim.save(out_path, writer="pillow", fps=10)
    plt.close(fig)
    return out_path


def create_clip_boxes(drive: RawDrive, out_path: str, max_frames: int = 50,
                      fps: int = 10):
    """Cam-2 clip with projected tracklet boxes
    (reference utils/create_clip_3d_boxes.py, without moviepy). The
    frames are encoded by cv2's VideoWriter, the one use of cv2 in the
    port."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "create_clip_boxes encodes its video with cv2.VideoWriter, and "
            "cv2 does not import here; the stats figure and the GIF clip "
            "need only matplotlib") from e

    boxes, types = drive.tracklets()
    # raw-drive calib lives per date dir
    date_dir = os.path.dirname(drive.dir)
    calib_v2c = os.path.join(date_dir, "calib_velo_to_cam.txt")
    calib_c2c = os.path.join(date_dir, "calib_cam_to_cam.txt")

    def read_kv(path):
        out = {}
        with open(path) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    try:
                        out[k.strip()] = np.array(
                            [float(x) for x in v.split()])
                    except ValueError:
                        pass
        return out

    v2c = read_kv(calib_v2c)
    c2c = read_kv(calib_c2c)
    Tr = np.eye(4)
    Tr[:3, :3] = v2c["R"].reshape(3, 3)
    Tr[:3, 3] = v2c["T"]
    R = np.eye(4)
    R[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    P2 = c2c["P_rect_02"].reshape(3, 4)

    frames = min(len(drive), max_frames)
    first = drive.image(0)
    h, w = first.shape[:2]
    fourcc = {"avi": "MJPG", "mkv": "X264"}.get(
        out_path.rsplit(".", 1)[-1].lower(), "mp4v")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*fourcc),
                             fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(
            f"cv2.VideoWriter could not open {out_path!r} (codec {fourcc});"
            " use .mp4/.avi/.mkv")
    for i in range(frames):
        img = raster.bgr_to_rgb(drive.image(i))      # RGB -> BGR
        for corners, typ in zip(boxes[i], types[i]):
            hom = np.concatenate([corners, np.ones((8, 1))], 1)
            cam = (R @ Tr @ hom.T)
            uvd = (P2 @ cam).T
            if (uvd[:, 2] <= 0.5).any():
                continue
            uv = (uvd[:, :2] / uvd[:, 2:3]).astype(int)
            for a, b in _EDGES:
                raster.line(img, tuple(uv[a]), tuple(uv[b]), (0, 255, 255))
        writer.write(img)
    writer.release()
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=("stats", "clip-pcl", "clip-boxes"))
    p.add_argument("--drive-dir", required=True,
                   help="base dir containing <date>/ subdirs")
    p.add_argument("--date", required=True)
    p.add_argument("--drive", required=True)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--max-frames", type=int, default=50)
    args = p.parse_args(argv)

    drive = RawDrive(args.drive_dir, args.date, args.drive)
    if args.command == "stats":
        out = display_frame_statistics(drive, args.frame, args.out)
    elif args.command == "clip-pcl":
        out = create_clip_pcl(drive, args.out, args.max_frames)
    else:
        out = create_clip_boxes(drive, args.out, args.max_frames)
    print(out)


if __name__ == "__main__":
    main()
