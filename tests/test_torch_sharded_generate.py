"""The port's sharded serving against its single-device ``generate`` and
the JAX reference's: one 4-rank gloo gang (``tests/torch_gang.py``,
worker ``sharded_generate``) runs ``make_sharded_generate`` on the tiny
config in fp32 over the meshes (dp=2, tp=2) and (fsdp=2, tp=2), greedy
with the fp and the int8 KV cache and sampled at temperature 1.0, greedy
and sampled for a one-row prompt (fewer rows than dp * fsdp: laid out
replicated), and tries tp=4 over 2 kv heads and the entry's dry run on 2
ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import decode as jax_decode
from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.parallel import mesh as jax_mesh
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from tests import torch_gang

WORLD, BATCH, PROMPT, NEW, MAX_LEN = 4, 4, 8, 6, 16
SEED = 5  # of every rank's sampling generator
MESHES = ("dp2_tp2", "fsdp2_tp2")
ONE_ROW = ("one_row", "one_row_sampled")
JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)
PT_CFG = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Runs the gang once; returns (per-rank results, the port's
    single-device tokens and the reference's, by cache kind)."""
    out = tmp_path_factory.mktemp("sharded_generate")
    params = jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)
    flat = {}

    def walk(tree, prefix=""):
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}/")
            else:
                flat[prefix + name] = np.asarray(value)

    walk(params)
    np.savez(out / "params.npz", **flat)
    prompt = np.random.RandomState(3).randint(
        0, JAX_CFG.vocab_size, (BATCH, PROMPT)).astype(np.int64)
    np.savez(out / "prompt.npz", prompt=prompt, new=NEW, max_len=MAX_LEN,
             seed=SEED)
    torch_gang.run_gang("sharded_generate", WORLD, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    single, reference = {}, {}
    for kind, quant in (("fp", False), ("int8", True)):
        single[kind] = pt_decode.generate(
            params_from_jax(params), torch.from_numpy(prompt), PT_CFG, NEW,
            MAX_LEN, kv_quant=quant)
        reference[kind] = np.asarray(jax_decode.generate(
            params, jnp.asarray(prompt.astype(np.int32)), JAX_CFG, NEW,
            MAX_LEN, kv_quant=quant))
    repeated = np.repeat(prompt[:1], BATCH, axis=0)
    for kind, rows in (("sampled", prompt), ("sampled_repeated", repeated),
                       ("one_row_sampled", prompt[:1])):
        single[kind] = pt_decode.generate(
            params_from_jax(params), torch.from_numpy(rows), PT_CFG, NEW,
            MAX_LEN, temperature=1.0,
            generator=torch.Generator().manual_seed(SEED))
    one_row = prompt[:1].astype(np.int32)
    single["one_row"] = pt_decode.generate(
        params_from_jax(params), torch.from_numpy(prompt[:1]), PT_CFG, NEW,
        MAX_LEN)
    reference["one_row"] = np.asarray(jax_decode.generate(
        params, jnp.asarray(one_row), JAX_CFG, NEW, MAX_LEN))
    # JAX's own sharded generate refuses a batch that dp * fsdp does not
    # divide, so its one-row tokens come from a (tp=2) mesh.
    mesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(tp=2),
                               devices=jax.devices()[:2])
    generate_fn, prompt_shard, place = jax_decode.make_sharded_generate(
        mesh, JAX_CFG, NEW, MAX_LEN)
    reference["one_row_sharded"] = np.asarray(generate_fn(
        place(params), jax.device_put(jnp.asarray(one_row), prompt_shard)))
    return ranks, single, reference


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_tokens_match_single_device_and_jax(gang, mesh, kind):
    ranks, single, reference = gang
    np.testing.assert_array_equal(single[kind].numpy(), reference[kind])
    for rank in ranks:
        got = rank[f"{mesh}/{kind}/tokens"]
        assert got.shape == (BATCH, NEW) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), single[kind].numpy())


@pytest.mark.parametrize("kind", ["sampled", "sampled_repeated"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sampled_tokens_match_single_device(gang, mesh, kind):
    # The draw is made from the global batch: the same generator gives
    # the same tokens as the plain generate.
    ranks, single, _ = gang
    for rank in ranks:
        np.testing.assert_array_equal(
            rank[f"{mesh}/{kind}/tokens"].numpy(), single[kind].numpy())


@pytest.mark.parametrize("kind", ONE_ROW)
@pytest.mark.parametrize("mesh", MESHES)
def test_one_row_tokens_match_single_device_and_jax(gang, mesh, kind):
    # One row on dp * fsdp = 2: replicated over the batch axes, so no
    # rank views a sharded size-1 batch; greedy tokens also equal JAX's
    # generate and its sharded generate (on tp=2).
    ranks, single, reference = gang
    if kind == "one_row":
        np.testing.assert_array_equal(single[kind].numpy(),
                                      reference["one_row"])
        np.testing.assert_array_equal(reference["one_row_sharded"],
                                      reference["one_row"])
    for rank in ranks:
        got = rank[f"{mesh}/{kind}/tokens"]
        assert got.shape == (1, NEW) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), single[kind].numpy())


@pytest.mark.parametrize("kind", ONE_ROW)
@pytest.mark.parametrize("mesh", MESHES)
def test_one_row_output_is_replicated(gang, mesh, kind):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank[f"{mesh}/{kind}/placements"] == ["R", "R"]
        assert rank[f"{mesh}/{kind}/local_shape"] == (1, NEW)


@pytest.mark.parametrize("mesh", MESHES)
def test_sampled_rows_of_a_repeated_prompt_differ(gang, mesh):
    # Rows r and r + B/2 lie on different shards of the batch dim; a
    # draw per shard from generators seeded alike gave them the same
    # random numbers, hence the same tokens for the same prompt.
    ranks, _, _ = gang
    half = BATCH // 2
    for rank in ranks:
        got = rank[f"{mesh}/sampled_repeated/tokens"]
        for row in range(half):
            assert not torch.equal(got[row], got[row + half]), got


@pytest.mark.parametrize("kind", ["fp", "int8", "sampled"])
@pytest.mark.parametrize("mesh", MESHES)
def test_output_is_batch_sharded(gang, mesh, kind):
    # Sharded over the mesh's dp or fsdp dim (the first), replicated over
    # tp: each rank holds half the rows.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank[f"{mesh}/{kind}/placements"] == ["S(0)", "R"]
        assert rank[f"{mesh}/{kind}/local_shape"] == (BATCH // 2, NEW)


def test_tp_over_kv_heads_refused_before_work(gang):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["tp4/error"] == "n_kv_heads=2 not divisible by tp=4"


def test_dryrun_of_another_size_inside_the_gang_raises(gang):
    # The entry's dry run runs in place only in a group of its size.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["dryrun2/error"] == \
            "dryrun_multichip(2) inside a process group of 4 ranks"


def test_gang_of_one_matches_generate():
    # One in-process rank, "flash" attention (its plain version through
    # local_map on the CPU) and the int8 cache: the sharded generate and
    # its prefill logits equal the plain ones bit for bit, for a prompt
    # of two rows and of one (the reference's dry run serves a row a
    # device; one row is laid out replicated). One process group for
    # both: each group leaves gloo threads in the test process.
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pt_mesh

    cfg = dataclasses.replace(PT_CFG, attn_impl="flash")
    params = pt_llama.init(cfg, torch.Generator().manual_seed(2), "cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = pt_mesh.build_mesh()
        generate_fn, layout, place = pt_decode.make_sharded_generate(
            mesh, cfg, NEW, MAX_LEN, kv_quant=True)
        placed = place(params)
        for rows in (2, 1):
            prompt = torch.from_numpy(np.random.RandomState(4).randint(
                0, cfg.vocab_size, (rows, PROMPT)))
            want = pt_decode.generate(params, prompt, cfg, NEW, MAX_LEN,
                                      kv_quant=True)
            want_logits = pt_decode.prefill(params, prompt, cfg, MAX_LEN)[0]
            sharded_prompt = layout(prompt)
            got = generate_fn(placed, sharded_prompt)
            with implicit_replication():
                logits = pt_decode.prefill(placed, sharded_prompt, cfg,
                                           MAX_LEN)[0].full_tensor()
            assert torch.equal(got.full_tensor(), want), rows
            assert torch.equal(logits, want_logits), rows
    finally:
        dist.destroy_process_group()


# The vocab-parallel embedding lookup in serving, recorded around one
# prefill and one decode_step on each mesh: (collective, mesh axis, local
# shape sent) for each collective, and the local table of each lookup.
V, D = JAX_CFG.vocab_size, JAX_CFG.d_model
TP = 2


def _table_shard(shape):
    """Whether a collective's local tensor is a [V / tp, D or D / fsdp]
    shard of the embedding table."""
    return len(shape) == 2 and shape[0] == V // TP and shape[1] in (D, D // 2)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", MESHES)
def test_serving_moves_no_table_rows_over_tp(gang, mesh, phase):
    ranks, _, _ = gang
    for rank in ranks:
        calls = rank[f"{mesh}/{phase}_calls"]
        assert not [c for c in calls if c[1] == "tp" and _table_shard(c[2])]


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", MESHES)
def test_serving_lookup_all_reduces_its_rows_over_tp(gang, mesh, phase):
    # The lookup's collectives open the step: the fsdp gather of the
    # table's columns (fsdp meshes), then one all-reduce over tp of the
    # rows [B / 2, positions, D].
    ranks, _, _ = gang
    positions = PROMPT if phase == "prefill" else 1
    want = [("all_reduce", "tp", (BATCH // 2, positions, D))]
    if mesh.startswith("fsdp"):
        want.insert(0, ("all_gather_into_tensor", "fsdp", (V // TP, D // 2)))
    for rank in ranks:
        assert rank[f"{mesh}/{phase}_calls"][:len(want)] == want


@pytest.mark.parametrize("mesh", MESHES)
def test_serving_lookups_see_one_vocab_shard(gang, mesh):
    # One lookup in prefill, one in the decode step, each on V / tp rows.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank[f"{mesh}/local_tables"] == [(V // TP, D)] * 2
