"""Torus grid model parsed from published DRA device attributes (the JAX
package's ``pkg/topology/grid.py``, the port's copy).

A ``TorusGrid`` is the scheduler-side view of one resource pool's ICI
fabric: the full-slice dimensions (from the ``topology`` attribute,
e.g. ``"4x4"`` or ``"2x2x4"``), per-axis wraparound links, and a
name -> (x, y, z) coordinate map for every chip that published usable
``iciX``/``iciY``/``iciZ`` attributes. Devices without coordinates
(sub-slice carve-outs, daemon/channel devices, degraded publications)
are kept aside in ``uncoordinated`` -- they always fall back to
first-fit ordering, never poison the grid.

The grid may be PARTIAL: a multi-host slice publishes one pool per
node, each carrying only that host's chips at their global slice
coordinates. Dims always describe the full slice, so hop distances and
wraparound stay correct even when only a 2x2 corner of a 4x4 slice is
visible.
"""

from __future__ import annotations

from dataclasses import dataclass, field

Coord = tuple[int, int, int]

# Generations whose ICI fabric is a 3D torus (the 2D generations are
# meshes that only close into rings at full-pod scale).
_THREE_D_PLATFORMS = frozenset({"v4", "v5", "v5p"})


def default_wrap(platform: str, dims: tuple[int, int, int]
                 ) -> tuple[bool, bool, bool]:
    """Per-axis wraparound policy by TPU generation.

    3D-torus generations (v4/v5p) ship wraparound links on any axis of
    length >= 4 (production slices are built from 4-multiples); the 2D
    generations (v5e/v6e) are meshes whose axes only close into rings
    at the full 16-wide pod dimension. Axes of length <= 2 never wrap
    (a "ring" of 2 is just the existing link). Unknown platforms get
    the conservative no-wrap model -- distances can only be
    overestimated, never underestimated.
    """
    if platform in _THREE_D_PLATFORMS:
        return tuple(n >= 4 for n in dims)  # type: ignore[return-value]
    if platform:  # known 2D generations and anything else named
        return tuple(n >= 16 for n in dims)  # type: ignore[return-value]
    return (False, False, False)


def attr_int(attrs: dict, name: str) -> int | None:
    """A device attribute as an int: accepts the typed DRA form
    ({"int": 3}) and a bare int (internal callers). THE typed-int
    unwrapping rule -- reuse it instead of re-implementing (the CD
    controller's workerId parsing goes through here too)."""
    entry = attrs.get(name)
    if isinstance(entry, dict):
        entry = entry.get("int")
    if isinstance(entry, bool) or not isinstance(entry, int):
        return None
    return entry


def _attr_str(attrs: dict, name: str) -> str | None:
    entry = attrs.get(name)
    if isinstance(entry, dict):
        entry = entry.get("string")
    return entry if isinstance(entry, str) else None


def parse_dims(topology: str) -> tuple[int, int, int] | None:
    """``"4x4"`` -> (4, 4, 1); ``"2x2x4"`` -> (2, 2, 4); None when the
    string is not a well-formed positive grid."""
    parts = topology.split("x")
    if not 1 <= len(parts) <= 3:
        return None
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        return None
    if any(d < 1 for d in dims):
        return None
    while len(dims) < 3:
        dims.append(1)
    return (dims[0], dims[1], dims[2])


@dataclass(frozen=True)
class TorusGrid:
    """One pool's ICI grid: full-slice dims, wraparound, chip coords."""

    dims: tuple[int, int, int]
    wrap: tuple[bool, bool, bool] = (False, False, False)
    # chip canonical name -> global slice coordinate
    coords: dict[str, Coord] = field(default_factory=dict)
    # devices that carried no usable coordinates (first-fit fallback)
    uncoordinated: tuple[str, ...] = ()

    @classmethod
    def from_devices(cls, devices: list[dict],
                     wrap: tuple[bool, bool, bool] | None = None,
                     ) -> "TorusGrid":
        """Build a grid from DRA Device dicts (``name`` + typed
        ``attributes``).

        Dims come from the first well-formed ``topology`` attribute;
        with none published, the bounding box of the seen coordinates.
        A device is coordinated when iciX and iciY parse as ints (iciZ
        defaults to 0 for 2D grids); duplicate or out-of-grid
        coordinates demote the later device to ``uncoordinated`` --
        a half-trusted grid would mis-rank everything.
        """
        dims: tuple[int, int, int] | None = None
        platform = ""
        raw: list[tuple[str, Coord | None]] = []
        for dev in devices:
            attrs = dev.get("attributes") or {}
            if dims is None:
                topo = _attr_str(attrs, "topology")
                if topo:
                    dims = parse_dims(topo)
            if not platform:
                platform = _attr_str(attrs, "platform") or ""
            x = attr_int(attrs, "iciX")
            y = attr_int(attrs, "iciY")
            z = attr_int(attrs, "iciZ")
            name = dev.get("name", "")
            if x is None or y is None or not name:
                raw.append((name, None))
            else:
                raw.append((name, (x, y, z if z is not None else 0)))
        if dims is None:
            seen = [c for _, c in raw if c is not None]
            if seen:
                dims = (max(c[0] for c in seen) + 1,
                        max(c[1] for c in seen) + 1,
                        max(c[2] for c in seen) + 1)
            else:
                dims = (1, 1, 1)
        coords: dict[str, Coord] = {}
        taken: set[Coord] = set()
        uncoordinated: list[str] = []
        for name, c in raw:
            if (c is None or c in taken
                    or any(not 0 <= c[i] < dims[i] for i in range(3))):
                if name:
                    uncoordinated.append(name)
                continue
            coords[name] = c
            taken.add(c)
        if wrap is None:
            wrap = default_wrap(platform, dims)
        return cls(dims=dims, wrap=wrap, coords=coords,
                   uncoordinated=tuple(uncoordinated))

    # -- geometry -------------------------------------------------------------

    def axis_distance(self, axis: int, a: int, b: int) -> int:
        d = abs(a - b)
        if self.wrap[axis]:
            d = min(d, self.dims[axis] - d)
        return d

    def hop_distance(self, a: Coord, b: Coord) -> int:
        """ICI hops between two chips (L1 on the torus)."""
        return sum(self.axis_distance(i, a[i], b[i]) for i in range(3))

    def max_hops(self, cells: set[Coord] | list[Coord]) -> int:
        """Network diameter of a chip set (0 for <= 1 chip)."""
        cells = list(cells)
        best = 0
        for i, a in enumerate(cells):
            for b in cells[i + 1:]:
                d = self.hop_distance(a, b)
                if d > best:
                    best = d
        return best

    def neighbors(self, c: Coord) -> list[Coord]:
        """The <= 6 ICI neighbors of a cell (wraparound-aware, grid
        bounds enforced on non-wrapping axes)."""
        out = []
        for axis in range(3):
            n = self.dims[axis]
            if n == 1:
                continue
            for step in (-1, 1):
                v = c[axis] + step
                if self.wrap[axis]:
                    v %= n
                elif not 0 <= v < n:
                    continue
                nc = list(c)
                nc[axis] = v
                out.append((nc[0], nc[1], nc[2]))
        return out

    def surface_area(self, cells: set[Coord]) -> int:
        """Exposed ICI links of a set: for every member, each neighbor
        slot not also in the set. Lower = more compact (fewer fabric
        links crossing the allocation boundary)."""
        return sum(
            1
            for c in cells
            for n in self.neighbors(c)
            if n not in cells
        )

