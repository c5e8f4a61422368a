"""Sub-torus shape enumeration and wraparound-aware placements (the JAX
package's ``pkg/topology/shapes.py``, the port's copy).

A "shape" is an axis-aligned (w, h, d) sub-box of the slice grid --
the TPU analog of a MIG profile: the units users actually claim
(1x1x1 single chip, 2x2x1 quad, 2x2x4 sub-cube, ... up to the full
slice). A "placement" is a concrete anchored instance of a shape; on a
wrapping axis anchors may run off the end and wrap around (the
placement stays ICI-contiguous through the wraparound link), so a
4-wide ring has 4 distinct 2-wide placements, not 3.
"""

from __future__ import annotations

from .grid import Coord, TorusGrid


def enumerate_shapes(grid: TorusGrid, max_chips: int | None = None
                     ) -> list[tuple[int, int, int]]:
    """Every sub-torus shape the grid admits, largest volume first
    (ties: more cubic first, then lexicographic). This is the shape
    catalog the fragmentation scorer protects."""
    x, y, z = grid.dims
    out = []
    for w in range(1, x + 1):
        for h in range(1, y + 1):
            for d in range(1, z + 1):
                vol = w * h * d
                if max_chips is not None and vol > max_chips:
                    continue
                out.append((w, h, d))
    out.sort(key=lambda s: (-(s[0] * s[1] * s[2]),
                            max(s) - min(s), s))
    return out


def shapes_for_count(grid: TorusGrid, count: int
                     ) -> list[tuple[int, int, int]]:
    """Shapes of exactly ``count`` chips that fit the grid, most
    compact first (min max-dimension, then min surface-to-volume --
    a 2x2x1 quad beats a 4x1x1 line)."""
    if count < 1:
        return []
    x, y, z = grid.dims
    out = []
    for w in range(1, x + 1):
        if count % w:
            continue
        rest = count // w
        for h in range(1, y + 1):
            if rest % h:
                continue
            d = rest // h
            if 1 <= d <= z:
                out.append((w, h, d))
    out.sort(key=lambda s: (max(s),
                            2 * (s[0] * s[1] + s[1] * s[2]
                                 + s[0] * s[2]), s))
    return out


def _axis_anchors(grid: TorusGrid, axis: int, size: int) -> range:
    n = grid.dims[axis]
    if size > n:
        return range(0)
    if size == n:
        # Full-axis spans at every anchor are the same cell set
        # (wrapped or not); one representative keeps placements unique.
        return range(1)
    if grid.wrap[axis]:
        return range(n)
    return range(n - size + 1)


def placements(grid: TorusGrid, shape: tuple[int, int, int]
               ) -> list[tuple[Coord, ...]]:
    """All distinct placements of ``shape``: each a tuple of cells in
    deterministic (z, y, x)-major order. Wrapping axes contribute
    anchors whose extent crosses the seam."""
    w, h, d = shape
    out: list[tuple[Coord, ...]] = []
    for az in _axis_anchors(grid, 2, d):
        for ay in _axis_anchors(grid, 1, h):
            for ax in _axis_anchors(grid, 0, w):
                cells = tuple(
                    ((ax + dx) % grid.dims[0],
                     (ay + dy) % grid.dims[1],
                     (az + dz) % grid.dims[2])
                    for dz in range(d)
                    for dy in range(h)
                    for dx in range(w)
                )
                out.append(cells)
    return out
