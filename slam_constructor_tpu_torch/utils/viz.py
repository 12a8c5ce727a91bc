"""Map and trajectory images (port of ``slam_constructor_tpu.utils.viz``):
offline artifacts in place of the reference's live rviz topics. They take
tensors (on any device) or numpy arrays."""

from __future__ import annotations

import numpy as np

from .trajectory import as_numpy


def render_map_rgb(occupancy, trajectory=None, origin=None, scale: float = 0.1,
                   gt=None) -> np.ndarray:
    """Occupancy plane (and trajectories) -> uint8 RGB image [H, W, 3]:
    free white, occupied black, the estimate red, ground truth green. Row 0
    is the map's bottom (the file writers flip it)."""
    occ = as_numpy(occupancy)
    img = np.clip((1.0 - occ) * 255, 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, axis=-1)

    def draw(traj, color):
        if traj is None or origin is None:
            return
        t = as_numpy(traj)
        o = as_numpy(origin)
        col = np.floor((t[:, 0] - o[0]) / scale).astype(int)
        row = np.floor((t[:, 1] - o[1]) / scale).astype(int)
        ok = (row >= 0) & (row < occ.shape[0]) & (col >= 0) & (col < occ.shape[1])
        rgb[row[ok], col[ok]] = color

    draw(gt, (0, 200, 0))
    draw(trajectory, (220, 0, 0))
    return rgb


def save_ppm(path: str, rgb) -> None:
    """A PPM file, which needs no library (row 0 at the bottom)."""
    img = as_numpy(rgb)[::-1]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.astype(np.uint8).tobytes())


def save_png(path: str, rgb) -> bool:
    """A PNG through matplotlib where it is installed; else a ``.ppm`` of
    the same name beside it. Returns whether the PNG was written."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, as_numpy(rgb)[::-1])
        return True
    except Exception:
        save_ppm(path.rsplit(".", 1)[0] + ".ppm", rgb)
        return False


def save_map_yaml(path: str, pgm_name: str, origin, scale: float) -> None:
    """ROS map_server YAML beside a PGM map."""
    o = as_numpy(origin)
    with open(path, "w") as f:
        f.write(
            f"image: {pgm_name}\nresolution: {scale}\n"
            f"origin: [{float(o[0])}, {float(o[1])}, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.25\n"
        )
