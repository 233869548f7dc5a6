"""Top-down map rasterisation and drawing (port of
``habitat_tpu/utils/visualizations/maps.py``; reference
habitat/utils/visualizations/maps.py).

The occupancy source is the scene's navgrid. The JAX package draws the agent
trace and marker with OpenCV (``cv2.line``, ``cv2.fillPoly``); the port
draws them in numpy with OpenCV's integer rules for 8-connected lines
(LineIterator: left to right, Bresenham error term, lines clipped to the
image first; the same pixels as ``cv2.line``) and for filled polygons
(edges drawn as lines, then a scanline fill on 16.16 fixed-point edge
walks; the same pixels as ``cv2.fillPoly`` inside the image, see
``fill_poly``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MAP_INVALID_POINT = 0
MAP_VALID_POINT = 1
MAP_BORDER_INDICATOR = 2
MAP_SOURCE_POINT_INDICATOR = 4
MAP_TARGET_POINT_INDICATOR = 6
MAP_SHORTEST_PATH_COLOR = 7
MAP_VIEW_POINT_INDICATOR = 8
MAP_TARGET_BOUNDING_BOX = 9

TOP_DOWN_MAP_COLORS = np.full((256, 3), 150, dtype=np.uint8)
TOP_DOWN_MAP_COLORS[MAP_INVALID_POINT] = [255, 255, 255]
TOP_DOWN_MAP_COLORS[MAP_VALID_POINT] = [150, 150, 150]
TOP_DOWN_MAP_COLORS[MAP_BORDER_INDICATOR] = [50, 50, 50]
TOP_DOWN_MAP_COLORS[MAP_SOURCE_POINT_INDICATOR] = [0, 0, 200]
TOP_DOWN_MAP_COLORS[MAP_TARGET_POINT_INDICATOR] = [200, 0, 0]
TOP_DOWN_MAP_COLORS[MAP_SHORTEST_PATH_COLOR] = [0, 200, 0]
TOP_DOWN_MAP_COLORS[MAP_VIEW_POINT_INDICATOR] = [245, 150, 150]
TOP_DOWN_MAP_COLORS[MAP_TARGET_BOUNDING_BOX] = [0, 175, 0]

XY_SHIFT = 16  # fixed-point bits of the polygon fill's edge walk


def get_topdown_map(scene, draw_border: bool = True) -> np.ndarray:
    """(NX, NZ) uint8 map of a scene's navgrid: valid / invalid cells, the
    valid cells next to an invalid one marked as border."""
    occ = scene.nav_occ
    top_down_map = np.where(occ, MAP_VALID_POINT, MAP_INVALID_POINT).astype(np.uint8)
    if draw_border:
        from scipy import ndimage

        top_down_map[occ & ~ndimage.binary_erosion(occ)] = MAP_BORDER_INDICATOR
    return top_down_map


def get_topdown_map_from_sim(sim, draw_border: bool = True, **kw) -> np.ndarray:
    """``get_topdown_map`` of a ``TpuSim``'s scene (the reference samples the
    navmesh instead, maps.py:326)."""
    return get_topdown_map(sim._scene, draw_border=draw_border)


def to_grid(realworld_x: float, realworld_y: float, grid_resolution: Tuple[int, int], lower_bound,
            upper_bound) -> Tuple[int, int]:
    """World xz -> grid cell of a map spanning [lower_bound, upper_bound]
    (reference maps.py:186)."""
    grid_size = (
        (upper_bound[0] - lower_bound[0]) / grid_resolution[0],
        (upper_bound[1] - lower_bound[1]) / grid_resolution[1],
    )
    grid_x = int((realworld_x - lower_bound[0]) / grid_size[0])
    grid_y = int((realworld_y - lower_bound[1]) / grid_size[1])
    return grid_x, grid_y


def from_grid(grid_x: int, grid_y: int, grid_resolution: Tuple[int, int], lower_bound,
              upper_bound) -> Tuple[float, float]:
    """Grid cell -> world xz of its corner (reference maps.py:217)."""
    grid_size = (
        (upper_bound[0] - lower_bound[0]) / grid_resolution[0],
        (upper_bound[1] - lower_bound[1]) / grid_resolution[1],
    )
    realworld_x = lower_bound[0] + grid_x * grid_size[0]
    realworld_y = lower_bound[1] + grid_y * grid_size[1]
    return realworld_x, realworld_y


def colorize_topdown_map(top_down_map: np.ndarray, fog_of_war_mask: Optional[np.ndarray] = None,
                         fog_of_war_desat_amount: float = 0.5) -> np.ndarray:
    """(NX, NZ, 3) uint8 colors of a map; valid cells still under fog are
    darkened by ``fog_of_war_desat_amount`` (reference maps.py:347)."""
    _map = TOP_DOWN_MAP_COLORS[top_down_map]
    if fog_of_war_mask is not None:
        desat_values = np.array([[fog_of_war_desat_amount], [1.0]])
        desat_mask = top_down_map != MAP_INVALID_POINT
        _map[desat_mask] = (_map * desat_values[fog_of_war_mask.astype(np.int64)]).astype(np.uint8)[desat_mask]
    return _map


# -- OpenCV's integer drawing rules, in numpy --------------------------------


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: (inside, x1, y1, x2, y2), the segment clipped to
    [0, width) x [0, height) (its endpoints moved even when it misses)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(width: int, height: int, x1: int, y1: int, x2: int, y2: int) -> List[Tuple[int, int]]:
    """The (x, y) pixels OpenCV's 8-connected LineIterator visits from
    (x1, y1) to (x2, y2), left to right, on a width x height image."""
    if not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height and 0 <= y2 < height):
        inside, x1, y1, x2, y2 = _clip_line(width, height, x1, y1, x2, y2)
        if not inside:
            return []
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    out, x, y = [], x1, y1
    for _ in range(dx + 1):
        out.append((x, y))
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:
            y += step_y
            x += step_x if diag else 0
        else:
            x += step_x
            y += step_y if diag else 0
    return out


def draw_line(image: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.line(image, pt1, pt2, color, 1)``: (x, y) points, 8-connected."""
    h, w = image.shape[:2]
    for x, y in _line_pixels(w, h, int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])):
        image[y, x] = color


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def fill_poly(image: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(image, [pts], color)`` for one contour of integer
    (x, y) points: its edges drawn as 8-connected lines, then a scanline
    fill (OpenCV's FillEdgeCollection) between the edges' 16.16 fixed-point
    walks, of the pixels from the ceiling of the left walk to the floor of
    the right one. An edge that leaves the image walks from its clipped
    segment's start, extended back to its own first row (OpenCV's "correct
    starting point for clipped lines"). This gives OpenCV 5.0's pixels on
    every contour inside the image; on contours that leave it, a few
    differ."""
    h, w = image.shape[:2]
    pts = [(int(p[0]), int(p[1])) for p in pts]
    edges: List[_Edge] = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        draw_line(image, (x0, y0), (x1, y1), color)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
            if t0y != t1y:
                c0x, c0y, c1x, c1y = t0x, t0y, t1x, t1y
        if y0 != y1:
            num, den = (c1x - c0x) << XY_SHIFT, c1y - c0y
            dx = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)  # C division
            if y0 < y1:
                edges.append(_Edge(y0, y1, (c0x << XY_SHIFT) + (y0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, (c1x << XY_SHIFT) + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1
    _fill_edges(image, edges, color)


def _fill_edges(image: np.ndarray, edges: List[_Edge], color) -> None:
    """OpenCV's FillEdgeCollection (8-connected, no anti-aliasing): the
    active-edge list walked scanline by scanline, the pixels between paired
    edges filled, the list bubble-sorted by x after each scanline."""
    h, w = image.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx)) + [_Edge(y0=2**31 - 1)]
    head = _Edge()
    i, e = 0, edges[0]
    for y in range(e.y0, min(y_max, h)):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                # the edge ends above this scanline
                prelast.next = last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                # an edge starts on this scanline
                prelast.next, e.next, prelast = e, last, e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    lo, hi = sorted((keep_prelast.x, prelast.x))
                    xa, xb = (lo + (1 << XY_SHIFT) - 1) >> XY_SHIFT, hi >> XY_SHIFT
                    if xa < w and xb >= 0:
                        image[y, max(xa, 0):min(xb, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last, last_exchange = head, head.next, None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next, last.next, te.next = te, te.next, last
                    prelast = te
                    if last_exchange is None:
                        last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break


def draw_path(top_down_map: np.ndarray, path_points: Sequence[Tuple[int, int]],
              color: int = MAP_SHORTEST_PATH_COLOR) -> None:
    """Consecutive (row, col) cells joined by 1-pixel 8-connected lines
    (the tracker's trace; reference maps.py:378 at thickness 1)."""
    for prev_pt, next_pt in zip(path_points[:-1], path_points[1:]):
        draw_line(top_down_map, prev_pt[::-1], next_pt[::-1], color)


def draw_agent(image: np.ndarray, agent_center_coord: Tuple[int, int], agent_rotation: float,
               agent_radius_px: int = 5) -> np.ndarray:
    """A filled triangle at the agent's (row, col), its tip along the
    heading (0 faces -z, up the rows)."""
    cy, cx = agent_center_coord
    r = max(agent_radius_px, 3)
    a = agent_rotation
    tip = (int(cx - r * np.sin(a) * 1.8), int(cy - r * np.cos(a) * 1.8))
    left = (int(cx - r * np.sin(a + 2.5)), int(cy - r * np.cos(a + 2.5)))
    right = (int(cx - r * np.sin(a - 2.5)), int(cy - r * np.cos(a - 2.5)))
    fill_poly(image, [tip, left, right], (0, 0, 255) if image.ndim == 3 else 5)
    return image


class TopDownMapTracker:
    """One episode's top-down map with the agent trace and the fog of war
    (the host side of the TopDownMap measure)."""

    def __init__(self, scene, draw_shortest_path: bool = True, fog_of_war: bool = True):
        self.scene = scene
        self.base_map = get_topdown_map(scene)
        self.fog_enabled = fog_of_war
        self.reset()

    def reset(self, goal_positions: Optional[np.ndarray] = None):
        self.map = self.base_map.copy()
        self.fog_mask = np.zeros_like(self.map)
        self.trace: List[Tuple[int, int]] = []
        if goal_positions is not None:
            for g in np.atleast_2d(goal_positions):
                self._stamp(self.scene.world_to_cell(np.asarray(g)[[0, 2]]), MAP_TARGET_POINT_INDICATOR)

    def _stamp(self, cell, value, size: int = 2):
        i, k = int(cell[0]), int(cell[1])
        self.map[max(i - size, 0): i + size + 1, max(k - size, 0): k + size + 1] = value

    def update(self, agent_pos, agent_yaw: float):
        from habitat_torch.utils.visualizations.fog_of_war import reveal_fog_of_war

        c = self.scene.world_to_cell(np.asarray(agent_pos)[[0, 2]])
        self.trace.append((int(c[0]), int(c[1])))
        if self.fog_enabled:
            self.fog_mask = reveal_fog_of_war(self.base_map != MAP_INVALID_POINT, self.fog_mask, np.asarray(c),
                                              agent_yaw, fov=90.0, max_line_len=5.0 / self.scene.nav_res)
        self._last_pose = (c, agent_yaw)

    def frame(self) -> np.ndarray:
        """(NX, NZ, 3) uint8: the map with the trace, colored under the fog,
        and the agent's marker."""
        m = self.map.copy()
        if len(self.trace) > 1:
            draw_path(m, self.trace)
        img = colorize_topdown_map(m, self.fog_mask if self.fog_enabled else None)
        if self.trace:
            c, yaw = self._last_pose
            draw_agent(img, (int(c[0]), int(c[1])), yaw)
        return img
