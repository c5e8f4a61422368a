"""The port's token loader (``k8s_dra_driver_gpu_tpu_torch/data/loader.py``)
against the reference's ``k8s_dra_driver_gpu_tpu/data/loader.py`` on the
same files: sequences, batches over steps, shards, epochs and seeds (bit
for bit), the ``max_token`` sidecar, the env contract and each refusal."""

import json
import os

import numpy as np
import pytest

from k8s_dra_driver_gpu_tpu.data import loader as jax_loader
from k8s_dra_driver_gpu_tpu_torch.data import loader as pt_loader

SEQ = 16


@pytest.fixture()
def token_file(tmp_path):
    """10,007 tokens drawn from a seed (a prime count, so the last
    sequence is ragged), in uint16."""
    path = str(tmp_path / "tokens.bin")
    tokens = np.random.RandomState(5).randint(0, 60_000, 10_007)
    pt_loader.write_token_file(path, tokens)
    return path


def test_token_dtypes_match_the_reference():
    assert pt_loader.TOKEN_DTYPES == jax_loader.TOKEN_DTYPES


@pytest.mark.parametrize("dtype,tokens", [
    ("uint16", [0, 1, 65_535]),
    ("uint32", [0, 70_000, 2**32 - 1]),
    ("int32", [-5, 0, 2**31 - 1]),
])
def test_write_token_file_writes_the_reference_bytes(tmp_path, dtype, tokens):
    mine, ref = tmp_path / "pt.bin", tmp_path / "jax.bin"
    pt_loader.write_token_file(str(mine), tokens, dtype)
    jax_loader.write_token_file(str(ref), tokens, dtype)
    assert mine.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("dtype,tokens", [
    ("uint16", [0, 65_536]),    # a Llama-3 id that would wrap
    ("uint16", [-1, 3]),
    ("uint32", [0, 2**32]),
    ("int32", [0, 2**31]),
])
def test_write_token_file_refuses_what_does_not_fit(tmp_path, dtype, tokens):
    with pytest.raises(ValueError) as got:
        pt_loader.write_token_file(str(tmp_path / "pt.bin"), tokens, dtype)
    with pytest.raises(ValueError) as want:
        jax_loader.write_token_file(str(tmp_path / "jax.bin"), tokens, dtype)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "pt.bin").exists()


@pytest.mark.parametrize("seq_len", [1, 7, SEQ, 10_006])
def test_sequences_match_the_reference(token_file, seq_len):
    mine = pt_loader.TokenDataset(token_file, seq_len)
    ref = jax_loader.TokenDataset(token_file, seq_len)
    assert mine.num_sequences == ref.num_sequences
    n = mine.num_sequences
    for i in sorted({0, min(1, n - 1), n // 2, n - 1}):
        got = mine.sequence(i)
        assert got.shape == (seq_len + 1,)
        np.testing.assert_array_equal(got, ref.sequence(i))


@pytest.mark.parametrize("global_batch,num_shards,seed", [
    (8, 1, 0), (8, 2, 0), (8, 4, 3), (12, 3, 1), (624, 2, 7)])
def test_batches_are_bitwise_the_reference(token_file, global_batch,
                                           num_shards, seed):
    ds_pt = pt_loader.TokenDataset(token_file, SEQ)
    ds_ref = jax_loader.TokenDataset(token_file, SEQ)
    for shard in range(num_shards):
        mine = pt_loader.ShardedBatchIterator(ds_pt, global_batch, num_shards,
                                              shard, seed=seed)
        ref = jax_loader.ShardedBatchIterator(ds_ref, global_batch,
                                              num_shards, shard, seed=seed)
        assert mine.steps_per_epoch == ref.steps_per_epoch
        spe = mine.steps_per_epoch
        # Inside the first epoch, at its edges and two epochs on.
        for step in sorted({0, 1, spe - 1, spe, spe + 1, 2 * spe + 3}):
            got = mine.batch(step)
            want = ref.batch(step)
            assert got.dtype == want.dtype == np.int32
            assert got.shape == (global_batch // num_shards, SEQ + 1)
            np.testing.assert_array_equal(got, want)


def test_shards_are_disjoint_and_cover_the_global_batch(token_file):
    ds = pt_loader.TokenDataset(token_file, SEQ)
    rows = [tuple(r) for shard in range(4) for r in pt_loader
            .ShardedBatchIterator(ds, 8, 4, shard).batch(5).tolist()]
    whole = pt_loader.ShardedBatchIterator(ds, 8, 1, 0).batch(5)
    assert len(set(rows)) == len(rows) == 8
    assert sorted(rows) == sorted(tuple(r) for r in whole.tolist())


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 0), (12, 4), (625, 9),
                                    (1024, 2)])
def test_permute_is_the_reference_permutation(n, seed):
    index = np.arange(n)
    got = pt_loader._permute(index, n, seed)
    np.testing.assert_array_equal(got, jax_loader._permute(index, n, seed))
    assert sorted(got.tolist()) == list(range(n))


def test_max_token_and_its_sidecar(token_file):
    want = jax_loader.TokenDataset(token_file, SEQ).max_token()
    os.remove(token_file + ".max.json")
    ds = pt_loader.TokenDataset(token_file, SEQ)
    assert ds.max_token() == want
    with open(token_file + ".max.json", encoding="utf-8") as f:
        doc = json.load(f)
    st = os.stat(token_file)
    assert doc == {"key": [st.st_size, int(st.st_mtime)], "max": want}
    # A sidecar whose key matches is trusted (no rescan) ...
    with open(token_file + ".max.json", "w", encoding="utf-8") as f:
        json.dump({"key": doc["key"], "max": 7}, f)
    assert ds.max_token() == 7
    # ... one whose key is stale, or that is unreadable, is not.
    for text in (json.dumps({"key": [0, 0], "max": 7}), "not json"):
        with open(token_file + ".max.json", "w", encoding="utf-8") as f:
            f.write(text)
        assert ds.max_token() == want
        assert ds.max_token() == jax_loader.TokenDataset(
            token_file, SEQ).max_token()


@pytest.mark.parametrize("env,want", [
    ({}, (1, 0)),
    ({"TPU_NUM_PROCESSES": "4", "TPU_PROCESS_ID": "3"}, (4, 3)),
    ({"TPU_NUM_PROCESSES": "2"}, (2, 0)),
])
def test_env_contract_matches_the_reference(token_file, env, want):
    mine = pt_loader.ShardedBatchIterator(
        pt_loader.TokenDataset(token_file, SEQ), 8, env=env)
    ref = jax_loader.ShardedBatchIterator(
        jax_loader.TokenDataset(token_file, SEQ), 8, env=env)
    assert (mine.num_shards, mine.shard_id) == want
    assert (ref.num_shards, ref.shard_id) == want
    assert mine.local_batch == ref.local_batch == 8 // want[0]
    np.testing.assert_array_equal(mine.batch(3), ref.batch(3))


def _refusal(module, token_file, case):
    if case == "too small":
        return module.TokenDataset(token_file, 10_007)
    ds = module.TokenDataset(token_file, SEQ)
    kwargs = {"indivisible batch": dict(global_batch=7, num_shards=2,
                                        shard_id=0),
              "shard out of range": dict(global_batch=8, num_shards=2,
                                         shard_id=5),
              "negative shard": dict(global_batch=8, num_shards=2,
                                     shard_id=-1),
              "batch over the dataset": dict(global_batch=632, num_shards=1,
                                             shard_id=0)}[case]
    return module.ShardedBatchIterator(ds, **kwargs)


@pytest.mark.parametrize("case", ["too small", "indivisible batch",
                                  "shard out of range", "negative shard",
                                  "batch over the dataset"])
def test_refusals_match_the_reference(token_file, case):
    with pytest.raises(ValueError) as got:
        _refusal(pt_loader, token_file, case)
    with pytest.raises(ValueError) as want:
        _refusal(jax_loader, token_file, case)
    assert str(got.value) == str(want.value)
