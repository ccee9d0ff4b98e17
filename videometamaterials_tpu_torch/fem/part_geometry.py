"""Pixel-geometry -> CAD sketch plan (pure numpy, testable outside Abaqus).

Re-implements the geometry math of the reference's `create_part`
(abaqus_script.py:79-289) as pure functions returning a declarative sketch
plan, so the loop tracing, corner reduction, spline anchoring and radius
corner-rounding are unit-testable without an Abaqus install. The Abaqus-side
builder (fem/abaqus_model.py) just replays the plan.

Semantics replicated from the reference:

  - closed boundary loops of the solid pixels, y-up (matrix row 0 at y=1);
  - loops reduced to their CORNER vertices (direction changes) -- the
    reference's `red_permutations` (abaqus_script.py:143-160);
  - splined=True (reference default): for the outer loop, boundary-touching
    segments stay straight lines and interior runs become splines anchored
    at the boundary entry/exit points; inner loops become closed splines
    through segment midpoints (abaqus_script.py:205-243);
  - splined=False with radius>0: corner rounding of the reduced polygon via
    line + arc (center p2 - r*v12_hat + r*v23_hat, direction by the cross
    product sign; 'Radius too large' guard) (abaqus_script.py:246-282);
  - per-loop surface probe points (segment midpoints), top/bottom probe
    lists (y==1 / y==0), outer-loop probes excluding domain-boundary
    midpoints, and an interior point (abaqus_script.py:165-203).

The port's copy of videometamaterials_tpu/fem/part_geometry.py.
"""

# NB must stay Python-2.7 importable: Abaqus CAE 2020 executes the builder
# script (fem/abaqus_model.py) that imports this module.
from __future__ import division, print_function

import numpy as np

_EPS = 1e-9


def _isclose(a, b):
    return abs(a - b) <= 1e-8


def _on_domain_boundary(p):
    return (_isclose(p[0], 0.0) or _isclose(p[0], 1.0)
            or _isclose(p[1], 0.0) or _isclose(p[1], 1.0))


def trace_pixel_loops(geom):
    """Closed boundary loops of the solid pixels of `geom` (n x n, matrix
    convention: row 0 at the TOP -> y=1). Returns a list of loops, each a
    float array (k+1, 2) of unit-cell (x, y) vertices with last == first,
    traced edge-by-edge at pixel resolution."""
    solid = np.asarray(geom).astype(bool)
    n = solid.shape[0]
    px = 1.0 / n

    def cell(i, j):
        if 0 <= i < n and 0 <= j < n:
            return solid[i, j]
        return False

    edges = {}

    def add_edge(p0, p1):
        edges.setdefault(p0, []).append(p1)
        edges.setdefault(p1, []).append(p0)

    for i in range(n):
        for j in range(n):
            if not cell(i, j):
                continue
            x0, x1 = j * px, (j + 1) * px
            y1, y0 = 1.0 - i * px, 1.0 - (i + 1) * px
            if not cell(i - 1, j):
                add_edge((x0, y1), (x1, y1))
            if not cell(i + 1, j):
                add_edge((x0, y0), (x1, y0))
            if not cell(i, j - 1):
                add_edge((x0, y0), (x0, y1))
            if not cell(i, j + 1):
                add_edge((x1, y0), (x1, y1))

    loops = []
    visited = set()
    for start in list(edges.keys()):
        for nxt in edges[start]:
            if (start, nxt) in visited:
                continue
            loop = [start, nxt]
            visited.add((start, nxt))
            visited.add((nxt, start))
            while loop[-1] != start:
                cur, prev = loop[-1], loop[-2]
                neighbors = [p for p in edges[cur] if p != prev
                             and (cur, p) not in visited]
                if not neighbors:
                    break
                nxt2 = neighbors[0]
                visited.add((cur, nxt2))
                visited.add((nxt2, cur))
                loop.append(nxt2)
            if loop[-1] == start and len(loop) > 3:
                loops.append(np.asarray(loop, dtype=float))
    return loops


def reduce_loop_to_corners(loop):
    """Drop collinear vertices, keeping only direction changes -- the
    reference's corner reduction of raw edge chains (abaqus_script.py:
    143-160). Input/output are closed (last == first) vertex arrays."""
    pts = np.asarray(loop, dtype=float)
    if len(pts) < 4:
        return pts
    body = pts[:-1]
    k = len(body)
    keep = []
    for i in range(k):
        prev_p = body[(i - 1) % k]
        next_p = body[(i + 1) % k]
        v_in = body[i] - prev_p
        v_out = next_p - body[i]
        if abs(v_in[0] * v_out[1] - v_in[1] * v_out[0]) > _EPS:
            keep.append(i)
    if not keep:
        return pts
    corners = body[keep]
    return np.concatenate([corners, corners[:1]], axis=0)


def _rotate_to_boundary_start(loop):
    """Rotate a closed loop so vertex 0 lies on the domain boundary (no-op
    when the loop never touches it)."""
    body = loop[:-1]
    for s, p in enumerate(body):
        if _on_domain_boundary(p):
            rolled = np.roll(body, -s, axis=0)
            return np.concatenate([rolled, rolled[:1]], axis=0)
    return loop


def order_loops(reduced_loops):
    """Outer loop (the one touching the domain boundary; tie-break: most
    vertices) first -- the reference relies on its outer loop being chain 0
    for the boundary-line special case (abaqus_script.py:214) and on the
    LONGEST permutation for the outer surface list (:173-177)."""

    def rank(lp):
        touches = any(_on_domain_boundary(p) for p in lp[:-1])
        return (not touches, -len(lp))

    return sorted(reduced_loops, key=rank)


def sketch_plan(geom, splined=True, radius=0.0):
    """Full plan: {'segments': [...], 'surf_probes': [[(x,y),...] per loop],
    'top_probes', 'bot_probes', 'outer_probes', 'interior_point'}.

    Segment forms: ('line', (x1,y1), (x2,y2)),
                   ('spline', ((x,y), ...)),
                   ('arc', center, clockwise(bool), p1, p2).
    """
    raw = trace_pixel_loops(geom)
    loops = order_loops([reduce_loop_to_corners(lp) for lp in raw])
    # the reference's outer chain starts on the domain boundary (its first
    # detected edge lies on the top row), which its spline-anchoring logic
    # relies on; rotate ours to match
    if loops:
        loops[0] = _rotate_to_boundary_start(loops[0])

    segments = []
    surf_probes = []
    top_probes, bot_probes, outer_probes = [], [], []
    longest = 0

    for idx, loop in enumerate(loops):
        k = len(loop) - 1
        touches_boundary = any(_on_domain_boundary(p) for p in loop[:-1])
        probes = []
        spline_run = []
        is_longest = False
        if k > longest:
            longest = k
            is_longest = True
            outer_probes = []

        for i in range(k):
            p1, p2 = loop[i], loop[i + 1]
            mid = 0.5 * (p1 + p2)
            probes.append((float(mid[0]), float(mid[1])))
            if _isclose(mid[1], 1.0):
                top_probes.append((float(mid[0]), float(mid[1])))
            elif _isclose(mid[1], 0.0):
                bot_probes.append((float(mid[0]), float(mid[1])))
            elif is_longest:
                outer_probes.append((float(mid[0]), float(mid[1])))

            if splined:
                if idx == 0 and touches_boundary:
                    b1 = _on_domain_boundary(p1)
                    b2 = _on_domain_boundary(p2)
                    if b1 and b2:
                        segments.append(("line", tuple(p1), tuple(p2)))
                    elif b1 and not b2:
                        spline_run.append(tuple(p1))      # anchor at entry
                    elif not b1 and b2:
                        spline_run.append(tuple(p2))      # anchor at exit
                        segments.append(("spline", tuple(spline_run)))
                        spline_run = []
                    else:
                        spline_run.append(tuple(mid))
                else:
                    if i == 0:
                        first_mid = tuple(mid)
                    spline_run.append(tuple(mid))
                    if i == k - 1:
                        spline_run.append(first_mid)      # close the spline
                        segments.append(("spline", tuple(spline_run)))
                        spline_run = []
            elif radius > 0.0:
                p3 = loop[i + 2] if i < k - 1 else loop[1]
                v12, v23 = p2 - p1, p3 - p2
                l12, l23 = np.linalg.norm(v12), np.linalg.norm(v23)
                if radius - 1e-5 > l12 / 2 or radius - 1e-5 > l23 / 2:
                    raise ValueError("Radius too large for given mesh.")
                h12, h23 = v12 / l12, v23 / l23
                p1r = p1 + radius * h12
                p2r = p2 - radius * h12
                p3r = p2 + radius * h23
                center = p2 - radius * h12 + radius * h23
                clockwise = float(-v12[0] * v23[1] + v12[1] * v23[0]) > 0
                segments.append(("line", tuple(p1r), tuple(p2r)))
                segments.append(("arc", tuple(center), clockwise,
                                 tuple(p2r), tuple(p3r)))
            else:
                segments.append(("line", tuple(p1), tuple(p2)))

        # an open spline run left at loop end (outer loop whose last segment
        # is interior) closes back onto the loop start point
        if spline_run:
            spline_run.append(tuple(loop[0]))
            segments.append(("spline", tuple(spline_run)))
        surf_probes.append(probes)

    solid = np.asarray(geom).astype(bool)
    n = solid.shape[0]
    ii, jj = np.argwhere(solid)[0]
    interior = ((jj + 0.5) / n, 1.0 - (ii + 0.5) / n)

    return {
        "segments": segments,
        "surf_probes": surf_probes,
        "top_probes": top_probes,
        "bot_probes": bot_probes,
        "outer_probes": outer_probes,
        "interior_point": interior,
    }


def apply_bounding_box(geom):
    """--bounding_box: force the outermost pixel ring solid
    (abaqus_script.py:296-300)."""
    out = np.asarray(geom).copy()
    out[0, :] = 1
    out[-1, :] = 1
    out[:, 0] = 1
    out[:, -1] = 1
    return out


def mirror_periodic(quarter):
    """2-fold mirror a quarter geometry into the periodic full cell
    (abaqus_script.py:302-312)."""
    quarter = np.asarray(quarter)
    geom_dr = np.flip(quarter, 0)
    geom_ul = np.flip(quarter, 1)
    geom_ur = np.flip(geom_ul, 0)
    geom_d = np.concatenate((quarter, geom_dr), axis=0)
    geom_u = np.concatenate((geom_ul, geom_ur), axis=0)
    return np.concatenate((geom_u, geom_d), axis=1)
