"""The port's ``TrainCheckpointer`` (``torch.distributed.checkpoint``).

One 4-rank gloo gang (``tests/torch_gang.py``, worker ``checkpoint``)
saves after 2 steps of ``make_sharded_train`` on (fsdp=2, tp=2),
``make_moe_train`` on (dp=2, ep=2) and ``make_pp_train`` on (pp=2, dp=2),
restores into a fresh init from another seed, and steps on: every leaf,
both moments, the counters and step 3 must equal the uninterrupted run
bit for bit, and the saved metadata must hold the global arrays (the
guard against DCP keeping one rank's copy of a plain tensor). Single
process: the step bookkeeping (pruning, latest step, an existing step, no
checkpoint)."""

import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu_torch.models import llama
from k8s_dra_driver_gpu_tpu_torch.train import train
from k8s_dra_driver_gpu_tpu_torch.train.checkpoint import TrainCheckpointer
from tests import torch_gang

WORLD, SEQ = 4, 16
FAMILIES = ("sharded", "moe", "pp")
TINY = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("checkpoint")
    # [steps, M, B, S + 1]: the dense and MoE steps take microbatch 0.
    tokens = np.random.RandomState(4).randint(
        0, TINY.vocab_size, (3, 2, WORLD, SEQ + 1)).astype(np.int32)
    np.savez(out / "tokens.npz", tokens=tokens)
    torch_gang.run_gang("checkpoint", WORLD, out, timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("family", FAMILIES)
def test_restore_is_bitwise_the_saved_state(ranks, family):
    for rank in ranks:
        assert rank[f"{family}/saved"] is True
        # The fresh init differs, so the equality below is the load's.
        assert rank[f"{family}/fresh_differs"]
        assert rank[f"{family}/restored_differs"] == []
        assert rank[f"{family}/counters"] == (2, 2)
    want = "torch.float32" if family == "moe" else "torch.bfloat16"
    assert all(rank[f"{family}/mu_dtype"] == want for rank in ranks)


@pytest.mark.parametrize("family", FAMILIES)
def test_step_after_restore_is_bitwise_the_uninterrupted_step(ranks, family):
    for rank in ranks:
        assert rank[f"{family}/step3_differs"] == []
        got, want = rank[f"{family}/step3_losses"]
        assert got == want


@pytest.mark.parametrize("family", FAMILIES)
def test_saving_an_existing_step_writes_nothing(ranks, family):
    assert all(rank[f"{family}/saved_again"] is False for rank in ranks)


@pytest.mark.parametrize("family,key,shape", [
    ("pp", "params.layers.wq", (4, 64, 64)),
    ("pp", "opt_state.mu.layers.w_down", (4, 128, 64)),
    ("pp", "opt_state.nu.layers.attn_norm", (4, 64)),
    ("pp", "params.lm_head", (64, 256)),
    ("moe", "params.layers.w_in", (2, 4, 64, 96)),
    ("moe", "opt_state.nu.layers.w_out", (2, 4, 96, 64)),
    # The MoE's replicated leaves, one copy an ep rank (per_rank_axes).
    ("moe", "params.layers.router", (2, 2, 64, 4)),
    ("moe", "opt_state.mu.embed", (2, 256, 64)),
    ("sharded", "params.layers.wq", (2, 64, 64)),
    ("sharded", "params.embed", (256, 64)),
    ("sharded", "opt_state.count", ()),
    ("sharded", "step", ()),
])
def test_metadata_holds_the_global_arrays(ranks, family, key, shape):
    for rank in ranks:
        assert rank[f"{family}/metadata"][key] == shape


def test_plain_local_leaves_without_specs_would_lose_stages(ranks):
    # What the specs guard against: without them DCP takes each stage's
    # [L/pp, ...] rows for a replicated tensor and keeps one stage's.
    assert ranks[0]["pp_plain/metadata"]["params.layers.wq"] == (2, 64, 64)


def test_moe_replicas_saved_once_would_not_come_back(ranks):
    # The MoE trainer clips each ep rank by its own gradient norm (as the
    # reference does), so its replicated leaves drift apart across ep from
    # step 2; saved once a leaf, some rank gets another rank's copy back.
    # per_rank_axes=("ep",) keeps each rank's (the bitwise cases above).
    assert any(rank["moe_once/restored_differs"] for rank in ranks)
    # The expert blocks are sharded, not replicated: they always come back.
    assert not [name for rank in ranks
                for name in rank["moe_once/restored_differs"]
                if name.endswith(("/w_in", "/w_out"))]


def _state(seed):
    params = llama.init(TINY, torch.Generator().manual_seed(seed), "cpu")
    opt = train.make_optimizer(mu_dtype=torch.bfloat16)
    return train.TrainState(params, opt.init(params), 0), opt


def test_bookkeeping_prunes_to_max_to_keep(tmp_path):
    state, _ = _state(0)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=3)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for step in range(1, 6):
        assert ckpt.save(step, state._replace(step=step))
    assert ckpt.all_steps() == [3, 4, 5]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "3", "4", "5"]
    assert ckpt.latest_step() == 5
    assert not ckpt.save(5, state)
    assert ckpt.nbytes(5) > sum(
        t.numel() * t.element_size() for t in train.tree_leaves(state.params))
    ckpt.close()


def test_restore_reads_the_asked_step_into_the_given_state(tmp_path):
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, TINY.vocab_size, (2, SEQ + 1)))
    state, opt = _state(0)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    state, _ = train.train_step(state, tokens, cfg=TINY, optimizer=opt)
    ckpt.save(1, state)
    want = [t.detach().clone() for t in train.tree_leaves(state.params)]
    state, _ = train.train_step(state, tokens, cfg=TINY, optimizer=opt)
    ckpt.save(2, state)
    fresh, _ = _state(3)
    restored = ckpt.restore(fresh, step=1)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for got, ref in zip(train.tree_leaves(restored.params), want):
        assert torch.equal(got, ref)
    assert ckpt.restore(fresh).step == 2


def test_restore_without_a_checkpoint_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no checkpoint to restore"):
        ckpt.restore(None)
    # A step directory without DCP's metadata (a save cut short) is not a
    # checkpoint.
    (tmp_path / "empty" / "7").mkdir()
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(None)


def test_mesh_and_specs_go_together(tmp_path):
    with pytest.raises(ValueError, match="give both or neither"):
        TrainCheckpointer(str(tmp_path), mesh=object())
    with pytest.raises(ValueError, match="give both or neither"):
        TrainCheckpointer(str(tmp_path), specs={})
    with pytest.raises(ValueError, match="per_rank_axes name axes"):
        TrainCheckpointer(str(tmp_path), per_rank_axes=("ep",))
