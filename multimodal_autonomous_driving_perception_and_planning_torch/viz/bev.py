"""Bird's-eye-view compositor (host raster I/O).

Visual parity with src/visualization/bev_renderer.py:29-363: same geometry
(600x600 px, 10 px/m, x in (-30, 30), y in (-10, 50)), palette, image->BEV
agent mapping (world_y = 50 - cy*0.1, world_x = (cx-320)*0.03), and layer
order (grid, candidates, plan, agents, ego, legend).  Host-side by design:
rendering is raster I/O consuming device outputs asynchronously
(SURVEY.md section 7 host/device split).

A copy of the JAX package's viz/bev.py on the port's host records; cv2
is imported inside each function, so that the port imports on a machine
without it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import BEVConfig
from ..host import HostTrack, HostTrajectory, HostVehicleState

_BG = (40, 40, 40)
_ROAD = (60, 60, 60)
_LANE = (200, 200, 200)
_EGO = (0, 200, 255)
_AGENT_COLORS = (
    (0, 255, 0),
    (255, 0, 0),
    (0, 0, 255),
    (255, 255, 0),
    (255, 0, 255),
    (0, 255, 255),
)


class BEVRenderer:
    def __init__(self, cfg: BEVConfig = BEVConfig()):
        self.cfg = cfg
        self.x_scale = cfg.width / (cfg.x_range[1] - cfg.x_range[0])
        self.y_scale = cfg.height / (cfg.y_range[1] - cfg.y_range[0])

    # -- coordinate transforms -------------------------------------------
    def world_to_pixel(self, x: float, y: float) -> Tuple[int, int]:
        c = self.cfg
        return (
            int((x - c.x_range[0]) * self.x_scale),
            int(c.height - (y - c.y_range[0]) * self.y_scale),
        )

    def pixel_to_world(self, px: int, py: int) -> Tuple[float, float]:
        c = self.cfg
        return (
            px / self.x_scale + c.x_range[0],
            (c.height - py) / self.y_scale + c.y_range[0],
        )

    def image_to_world(self, cx: float, cy: float) -> Tuple[float, float]:
        """Monocular image->BEV heuristic (bev_renderer.py:205-208)."""
        return (cx - 320.0) * 0.03, 50.0 - cy * 0.1

    # -- layers -----------------------------------------------------------
    def create_base_image(self) -> np.ndarray:
        import cv2

        c = self.cfg
        img = np.full((c.height, c.width, 3), _BG, np.uint8)
        rl = self.world_to_pixel(-7, c.y_range[0])[0]
        rr = self.world_to_pixel(7, c.y_range[0])[0]
        cv2.rectangle(img, (rl, 0), (rr, c.height), _ROAD, -1)
        for lane_x in (-3.5, 0.0, 3.5):
            px = self.world_to_pixel(lane_x, 0)[0]
            if lane_x == 0:
                for y in range(0, c.height, 30):
                    cv2.line(img, (px, y), (px, min(y + 15, c.height)), (0, 200, 200), 2)
            else:
                for y in range(0, c.height, 40):
                    cv2.line(img, (px, y), (px, min(y + 20, c.height)), _LANE, 2)
        for edge_x in (-7, 7):
            px = self.world_to_pixel(edge_x, 0)[0]
            cv2.line(img, (px, 0), (px, c.height), (255, 255, 255), 2)
        return img

    def draw_vehicle(
        self,
        img: np.ndarray,
        x: float,
        y: float,
        heading: float,
        color,
        length: float = 4.5,
        width: float = 2.0,
        label: Optional[str] = None,
    ) -> None:
        import cv2

        ch, sh = np.cos(heading), np.sin(heading)
        hl, hw = length / 2, width / 2
        corners = np.array(
            [
                (x + hl * ch - hw * sh, y + hl * sh + hw * ch),
                (x + hl * ch + hw * sh, y + hl * sh - hw * ch),
                (x - hl * ch + hw * sh, y - hl * sh - hw * ch),
                (x - hl * ch - hw * sh, y - hl * sh + hw * ch),
            ]
        )
        pts = np.array([self.world_to_pixel(cx, cy) for cx, cy in corners], np.int32)
        cv2.fillPoly(img, [pts], color)
        cv2.polylines(img, [pts], True, (255, 255, 255), 1)
        cp = self.world_to_pixel(x, y)
        fp = self.world_to_pixel(x + hl * ch, y + hl * sh)
        cv2.arrowedLine(img, cp, fp, (255, 255, 255), 2, tipLength=0.5)
        if label:
            cv2.putText(
                img,
                label,
                (cp[0] - 20, cp[1] - 15),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.4,
                (255, 255, 255),
                1,
            )

    def draw_agents(
        self, img: np.ndarray, tracks: Sequence[HostTrack], draw_trajectories=True
    ) -> None:
        import cv2

        for track in tracks:
            color = _AGENT_COLORS[track.track_id % len(_AGENT_COLORS)]
            wx, wy = self.image_to_world(*track.center)
            self.draw_vehicle(
                img, wx, wy, 0.0, color, length=3.0, width=1.5,
                label=f"ID:{track.track_id}",
            )
            traj = track.trajectory
            if draw_trajectories and len(traj) > 1:
                for j in range(1, len(traj)):
                    p0 = self.world_to_pixel(*self.image_to_world(*traj[j - 1]))
                    p1 = self.world_to_pixel(*self.image_to_world(*traj[j]))
                    thickness = max(1, int(2 * j / len(traj)))
                    cv2.line(img, p0, p1, color, thickness)

    def draw_trajectory(
        self,
        img: np.ndarray,
        traj: Optional[HostTrajectory],
        color=(0, 255, 0),
        thickness: int = 2,
        draw_waypoints: bool = True,
    ) -> None:
        import cv2

        if traj is None or len(traj.positions) < 2:
            return
        pts = np.array(
            [self.world_to_pixel(p[0], p[1]) for p in traj.positions], np.int32
        ).reshape((-1, 1, 2))
        cv2.polylines(img, [pts], False, color, thickness)
        if draw_waypoints:
            for p in traj.positions[::3]:
                cv2.circle(img, self.world_to_pixel(p[0], p[1]), 3, color, -1)

    def draw_uncertainty_ellipse(
        self, img: np.ndarray, x: float, y: float, uncertainty: float,
        color=(0, 255, 255),
    ) -> None:
        import cv2

        px, py = self.world_to_pixel(x, y)
        r = int(uncertainty * self.cfg.scale)
        if r > 0:
            cv2.ellipse(img, (px, py), (r, r), 0, 0, 360, color, 1)

    def _draw_grid(self, img: np.ndarray) -> None:
        import cv2

        c = self.cfg
        for x in range(-30, 31, 10):
            px = self.world_to_pixel(x, 0)[0]
            cv2.line(img, (px, 0), (px, c.height), (50, 50, 50), 1)
            cv2.putText(img, f"{x}m", (px, c.height - 5),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.3, (100, 100, 100), 1)
        for y in range(-10, 51, 10):
            py = self.world_to_pixel(0, y)[1]
            cv2.line(img, (0, py), (c.width, py), (50, 50, 50), 1)
            cv2.putText(img, f"{y}m", (5, py),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.3, (100, 100, 100), 1)

    def _draw_legend(self, img: np.ndarray) -> None:
        import cv2

        y = 20
        for label, color in (("EGO", _EGO), ("Planned", (0, 255, 0)), ("Agents", _AGENT_COLORS[0])):
            cv2.rectangle(img, (10, y - 10), (25, y + 5), color, -1)
            cv2.putText(img, label, (30, y),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
            y += 20

    # -- full scene --------------------------------------------------------
    def render(
        self,
        ego_state: Optional[HostVehicleState] = None,
        tracks: Optional[Sequence[HostTrack]] = None,
        planned_trajectory: Optional[HostTrajectory] = None,
        candidate_trajectories: Optional[List[HostTrajectory]] = None,
        show_grid: bool = False,
    ) -> np.ndarray:
        img = self.create_base_image()
        if show_grid:
            self._draw_grid(img)
        if candidate_trajectories:
            for traj in candidate_trajectories:
                if traj is not planned_trajectory:
                    self.draw_trajectory(img, traj, (80, 80, 80), 1, False)
        if planned_trajectory is not None:
            self.draw_trajectory(img, planned_trajectory, (0, 255, 0), 3, True)
        if tracks:
            self.draw_agents(img, tracks)
        if ego_state is not None:
            self.draw_vehicle(
                img, ego_state.x, ego_state.y, ego_state.heading, _EGO, label="EGO"
            )
            self.draw_uncertainty_ellipse(
                img, ego_state.x, ego_state.y, ego_state.pos_uncertainty
            )
        self._draw_legend(img)
        return img
