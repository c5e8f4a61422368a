"""Sharded, deterministic, resumable token-stream loading.

The port's copy of ``k8s_dra_driver_gpu_tpu/data/loader.py``, plain
numpy with the same semantics: for the same file, config and step,
``ShardedBatchIterator.batch`` returns the reference's rows bit for bit.

1. **Host-sharded**: each node of the gang reads a disjoint slice of
   every global batch, keyed by the env contract the driver injects
   (TPU_PROCESS_ID / TPU_NUM_PROCESSES): no coordination traffic for
   data.
2. **Deterministic and resumable**: ``batch(step)`` is a pure function of
   (file, config, step), so a run resumed from a checkpoint at step N
   replays exactly the batches N, N+1, ... with no loader state to save.
3. **Zero-copy**: token files are memory-mapped; a batch is a strided
   gather and shuffling is an affine permutation over sequence slots,
   O(1) memory.
"""

from __future__ import annotations

import json
import os

import numpy as np

TOKEN_DTYPES = {"uint16": np.uint16, "uint32": np.uint32, "int32": np.int32}


def write_token_file(path: str, tokens, dtype: str = "uint16") -> None:
    """Write a 1-D token array as a flat binary file of ``dtype``.

    The range is checked before the cast: a silent wrap (Llama-3 ids
    >= 65536 into uint16) would give valid-looking wrong tokens that no
    vocab check downstream could catch."""
    arr = np.asarray(tokens)
    info = np.iinfo(TOKEN_DTYPES[dtype])
    lo, hi = int(arr.min()), int(arr.max())
    if lo < info.min or hi > info.max:
        raise ValueError(
            f"token ids [{lo}, {hi}] don't fit dtype {dtype} "
            f"[{info.min}, {info.max}]"
        )
    arr.astype(TOKEN_DTYPES[dtype]).tofile(path)


class TokenDataset:
    """A flat token stream on disk, viewed as fixed-length sequences."""

    def __init__(self, path: str, seq_len: int, dtype: str = "uint16"):
        self.path = path
        self.seq_len = seq_len
        self._tokens = np.memmap(path, dtype=TOKEN_DTYPES[dtype], mode="r")
        # +1: each sample is seq_len inputs + 1 shifted target.
        self.num_sequences = (len(self._tokens) - 1) // seq_len
        if self.num_sequences <= 0:
            raise ValueError(
                f"{path}: {len(self._tokens)} tokens < one sequence of "
                f"{seq_len}+1"
            )

    def sequence(self, index: int) -> np.ndarray:
        """-> [seq_len + 1] tokens (inputs + next-token targets)."""
        start = index * self.seq_len
        return np.asarray(self._tokens[start:start + self.seq_len + 1])

    def max_token(self) -> int:
        """Largest token id in the file, cached in a ``.max.json`` sidecar
        keyed by (size, mtime), so a resumed run does not rescan a large
        file."""
        st = os.stat(self.path)
        key = [st.st_size, int(st.st_mtime)]
        sidecar = self.path + ".max.json"
        try:
            with open(sidecar, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("key") == key:
                return int(doc["max"])
        except (OSError, ValueError, KeyError):
            pass
        value = int(self._tokens.max())
        try:
            with open(sidecar, "w", encoding="utf-8") as f:
                json.dump({"key": key, "max": value}, f)
        except OSError:
            pass  # the cache is best-effort
        return value


def _permute(index: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Stateless pseudo-random permutation of [0, n): an affine map with
    a multiplier coprime to n. Deterministic, O(1) memory."""
    rng = np.random.RandomState(seed)
    a = int(rng.randint(1, max(n, 2)))
    while np.gcd(a, n) != 1:
        a += 1
    b = int(rng.randint(0, max(n, 1)))
    return (index * a + b) % n


class ShardedBatchIterator:
    """``batch(step)`` for one gang member.

    The global batch ``global_batch`` splits evenly over ``num_shards``
    (default: TPU_NUM_PROCESSES from ``env``, else 1); this shard
    (default: TPU_PROCESS_ID, else 0) materializes only its
    ``global_batch // num_shards`` rows.
    """

    def __init__(
        self,
        dataset: TokenDataset,
        global_batch: int,
        num_shards: int | None = None,
        shard_id: int | None = None,
        seed: int = 0,
        env=os.environ,
    ):
        self.ds = dataset
        if num_shards is None:
            num_shards = int(env.get("TPU_NUM_PROCESSES", "1"))
        if shard_id is None:
            shard_id = int(env.get("TPU_PROCESS_ID", "0"))
        if global_batch % num_shards:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{num_shards} shards"
            )
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if dataset.num_sequences < global_batch:
            # A permutation over fewer slots than one global batch could
            # not keep the shards' rows disjoint.
            raise ValueError(
                f"dataset has {dataset.num_sequences} sequences < one "
                f"global batch of {global_batch}"
            )
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.steps_per_epoch = max(self.ds.num_sequences // global_batch, 1)

    def batch(self, step: int) -> np.ndarray:
        """-> [local_batch, seq_len + 1] int32 tokens for ``step``."""
        epoch = step // self.steps_per_epoch
        pos = step % self.steps_per_epoch
        row0 = pos * self.global_batch + self.shard_id * self.local_batch
        slots = np.arange(row0, row0 + self.local_batch)
        # Permute over the WHOLE dataset (not just the consumed prefix):
        # each epoch's own affine map rotates which tail sequences fall
        # off the drop-last edge, so every sample is eventually seen.
        # Injectivity over [0, num_sequences) keeps shards disjoint
        # within a step.
        slots = _permute(slots, self.ds.num_sequences, self.seed + epoch)
        return np.stack(
            [self.ds.sequence(int(s)) for s in slots]
        ).astype(np.int32)
