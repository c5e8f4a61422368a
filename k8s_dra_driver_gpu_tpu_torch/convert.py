"""Carry weights from the JAX reference into the port.

The reference keeps its parameters as a nested dict of arrays with
layer-stacked ``[L, ...]`` leaves; the port uses the same keys and the
same leaves as tensors, so one ``init`` on the JAX side drives both
packages in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` reads)
    -> the same nested dict of CPU tensors, same dtypes. Copies the
    data; the source is never aliased.

    numpy has no bfloat16 of its own: JAX hands bf16 leaves over as
    ml_dtypes' ``bfloat16``, which ``torch.from_numpy`` refuses, so those
    are carried bit for bit through ``uint16``."""
    if isinstance(tree, dict):
        return {name: params_from_jax(leaf) for name, leaf in tree.items()}
    array = np.array(tree, copy=True)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)
