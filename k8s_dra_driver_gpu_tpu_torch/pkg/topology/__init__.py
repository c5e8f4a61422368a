"""ICI topology-aware placement engine (the JAX package's
``pkg/topology/``, the port's own copy without ``sim``, the placement
bench's simulator, which waits: ROADMAP.md §1c). The port's GPU slices
publish no ICI coordinates, so on them every ordering below falls back
to first-fit; on coordinated slices (the JAX mock's) it gives the JAX
order, which ``tests/test_torch_topology.py`` holds it to.

The driver publishes per-chip ICI coordinates (``iciX``/``iciY``/
``iciZ``, ``deviceinfo.py``) and the full-slice grid (``topology``),
but until this subsystem existed the in-tree DRA scheduler picked
devices first-fit -- a 4-chip claim could land scattered across the
torus, and churn steadily destroyed the large contiguous shapes that
multi-chip training claims need. This package is the placement layer:

- ``grid``      -- ``TorusGrid``: chip attributes -> a wraparound-aware
                   per-pool grid model (partial grids and chips with
                   missing coordinates are first-class).
- ``shapes``    -- valid sub-torus shape enumeration (1x1x1 .. full
                   slice) and wraparound-aware placement generation.
- ``score``     -- the placement scorer: candidate device sets ranked
                   by fragmentation cost (how many future large shapes
                   a pick destroys, best-fit-style) then compactness
                   (max ICI hop distance, exposed surface area).
- ``hosts``     -- multi-host gang support: rank hosts so a gang of N
                   lands on ICI-adjacent workers.

Design analog: the multi-objective MIG-fleet placement literature
(arXiv:2502.01909, ParvaGPU arXiv:2409.14447) -- keep allocations
compact AND keep the biggest future shapes allocatable. The scorer
only ORDERS candidates; correctness (constraints, counters, taints)
stays with the scheduler's backtracking fit, so first-fit semantics
are the automatic fallback whenever coordinates are absent or the
``TopologyAwarePlacement`` feature gate is off.
"""

from .grid import TorusGrid, default_wrap
from .hosts import rank_adjacent_hosts
from .score import (
    fragmentation_score,
    largest_free_shape,
    order_candidates,
    rank_placements,
    set_compactness,
)
from .shapes import enumerate_shapes, placements, shapes_for_count

__all__ = [
    "TorusGrid",
    "default_wrap",
    "enumerate_shapes",
    "fragmentation_score",
    "largest_free_shape",
    "order_candidates",
    "placements",
    "rank_adjacent_hosts",
    "rank_placements",
    "set_compactness",
    "shapes_for_count",
]
