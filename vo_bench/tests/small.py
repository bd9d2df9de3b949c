"""A cell cut to a size that the CPU runs in seconds, for the tests: the
image, the ORB pyramid and the scene shrink; every path stays."""

from __future__ import annotations

from vo_bench.bench import find_cell


def small(name: str):
    cell = find_cell(name)
    vo = cell.config["vo_config"]
    vo["camera"].update(width=320, height=120, cx=160.0, cy=60.0)
    vo["orb"].update(max_keypoints=128, n_levels=3, grid_rows=2, grid_cols=4)
    scene = cell.traffic["scene"]
    scene["period_frames"] = 128
    scene["mover"].update(size_px=40, x=150, y0=4, vy_px=8)
    cell.traffic["profile_iterations"] = 3
    return cell
