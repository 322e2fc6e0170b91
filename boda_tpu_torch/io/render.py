"""Point-cloud rendering: the os-render analog, file-backed.

The port's copy of boda_tpu/io/render.py (host numpy; no device work).

Reference parity: os-render.cc (`add-img-pts`, :80-...) rendered lidar
point clouds through OSMesa GL (orbit camera, ground grid, z-buffered
point splats) into per-block images. A headless host has no GL stack (the same
environment constraint that made disp_util PNG-backed), so this is a
numpy renderer with the same capability surface: orbit camera
(theta/phi/r around the origin — the reference's cam_rot convention),
perspective projection, z-buffered point splats colored by height, and
an XY ground grid. The rendered RGB image is attached to the block as
the `as_img` named subblock (the reference's as_img field), or replaces
the block nda with `replace=1` so `img-sink` can write PNGs directly.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from .data_stream import DataBlock, DataStream


def _heat(v: np.ndarray) -> np.ndarray:
    """[0,1] → RGB u8 (blue→cyan→yellow→red ramp)."""
    v = np.clip(v, 0.0, 1.0)
    r = np.clip(2.0 * v - 0.5, 0, 1)
    g = 1.0 - np.abs(2.0 * v - 1.0) * 0.7
    b = np.clip(1.0 - 2.0 * v, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


@register(DataStream, "add-img-pts",
          help="render point-cloud blocks to images (os-render analog)")
class AddImgPts(DataStream):
    disp_sz = Attr(list[int], default="600 300", help="image W H")
    cam_theta = Attr(float, default=30.0, help="orbit elevation, degrees")
    cam_phi = Attr(float, default=180.0, help="orbit azimuth, degrees")
    cam_r = Attr(float, default=40.0, help="orbit radius (world units)")
    fov_y = Attr(float, default=45.0, help="vertical field of view, degrees")
    pt_sz = Attr(int, default=2, help="point splat size in pixels")
    grid_cells = Attr(int, default=10)
    grid_cell_sz = Attr(float, default=10.0)
    z_color_range = Attr(list[float], default="-3 5",
                         help="height range mapped onto the color ramp")
    replace = Attr(bool, default=False,
                   help="1: output the image AS the block nda (feeds "
                        "img-sink); 0: attach as the as_img subblock")

    def _camera(self):
        th = np.deg2rad(self.cam_theta)
        ph = np.deg2rad(self.cam_phi)
        eye = np.array([np.cos(th) * np.sin(ph), np.cos(th) * np.cos(ph),
                        np.sin(th)]) * self.cam_r
        fwd = -eye / np.linalg.norm(eye)          # look at the origin
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up0)
        nr = np.linalg.norm(right)
        if nr < 1e-6:                             # looking straight down
            right = np.array([1.0, 0.0, 0.0])
            nr = 1.0
        right /= nr
        up = np.cross(right, fwd)
        return eye, right, up, fwd

    def _grid_pts(self):
        n, s = self.grid_cells, self.grid_cell_sz
        ext = n * s / 2.0
        line = np.linspace(-ext, ext, n * 8)
        pts = []
        for i in range(n + 1):
            c = -ext + i * s
            pts.append(np.stack([line, np.full_like(line, c),
                                 np.zeros_like(line)], -1))
            pts.append(np.stack([np.full_like(line, c), line,
                                 np.zeros_like(line)], -1))
        return np.concatenate(pts, 0)

    def _render(self, pts: np.ndarray) -> np.ndarray:
        W, H = int(self.disp_sz[0]), int(self.disp_sz[1])
        img = np.zeros((H, W, 3), np.uint8)
        zbuf = np.full((H, W), np.inf, np.float32)
        eye, right, up, fwd = self._camera()
        f = 1.0 / np.tan(np.deg2rad(self.fov_y) / 2.0)
        aspect = W / H
        zr0, zr1 = float(self.z_color_range[0]), float(self.z_color_range[1])

        def splat(world, colors):
            rel = world - eye[None, :]
            cz = rel @ fwd
            keep = cz > 0.1
            rel, cz, colors = rel[keep], cz[keep], colors[keep]
            sx = (rel @ right) / cz * f / aspect
            sy = (rel @ up) / cz * f
            px = ((sx + 1) * 0.5 * W).astype(np.int64)
            py = ((1 - (sy + 1) * 0.5) * H).astype(np.int64)
            ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            px, py, cz, colors = px[ok], py[ok], cz[ok], colors[ok]
            order = np.argsort(-cz)  # far→near: near splats overwrite
            px, py, cz, colors = px[order], py[order], cz[order], colors[order]
            r = self.pt_sz // 2
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    qx = np.clip(px + dx, 0, W - 1)
                    qy = np.clip(py + dy, 0, H - 1)
                    upd = cz < zbuf[qy, qx] + 1e-3
                    img[qy[upd], qx[upd]] = colors[upd]
                    np.minimum.at(zbuf, (qy[upd], qx[upd]), cz[upd])

        grid = self._grid_pts()
        splat(grid, np.full((len(grid), 3), 70, np.uint8))
        cols = _heat((pts[:, 2] - zr0) / max(zr1 - zr0, 1e-6))
        splat(pts, cols)
        return img

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid() or db.nda is None:
            return db
        v = np.asarray(db.nda.v)
        if v.ndim != 3 or v.shape[-1] != 3:
            raise RtErr("add-img-pts: expected (…, 3) float point-cloud "
                        "blocks (velo-pcdm-to-xyz output); got dims "
                        f"{db.nda.dims.pretty()}")
        pts = v.reshape(-1, 3).astype(np.float64)
        pts = pts[np.abs(pts).sum(1) > 1e-9]  # drop zero-distance returns
        img = self._render(pts)
        dims = Dims([("y", img.shape[0]), ("x", img.shape[1]), ("chan", 3)],
                    tn="uint8_t")
        out = db.clone()
        if self.replace:
            out.nda = NDA(dims, img)
            out.meta = "image"
        else:
            sb = DataBlock(nda=NDA(dims, img), tag="as_img", meta="image")
            out.set_sdb(sb)
        return out

    def get_pos_info_str(self) -> str:
        return "add-img-pts"
