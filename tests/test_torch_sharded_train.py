"""The port's sharded training against the JAX reference: one 4-rank gloo
gang (``tests/torch_gang.py``, worker ``sharded_train``) trains the tiny
config in fp32 for 3 steps on the meshes (dp=2, fsdp=2), (fsdp=2, tp=2)
and (tp=4), ``plan_for(4)``, where tp splits the model's 2 kv heads,
then 3 steps in one scanned call, and on a multislice mesh of two
(fsdp=2) slices with ``batch_axes=("dcn", "dp", "fsdp")``; JAX's
single-device ``train_step`` on the same parameters and global batches
is the reference, and at tp=4 JAX's own ``make_sharded_train`` on 4 CPU
devices too. The collectives of one step on each mesh are recorded."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.parallel import mesh as jax_mesh
from k8s_dra_driver_gpu_tpu.train import train as jax_train
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from tests import torch_gang

WORLD, STEPS, BATCH, SEQ = 4, 3, 8, 16
MESHES = {"dp2_fsdp2": {"dp": 2, "fsdp": 2}, "fsdp2_tp2": {"fsdp": 2, "tp": 2},
          "tp4": {"tp": 4}}
# fp32 on both sides; the sharded step sums its matmuls and gradients in
# another order than one device does.
TOL = 1e-4
JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = np.asarray(value)
    return out


def _inputs():
    """The reference's initial parameters and the [steps, B, S + 1]
    global batches."""
    params = jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)
    tokens = np.random.RandomState(7).randint(
        0, JAX_CFG.vocab_size, (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Runs the gang once; returns (per-rank results, JAX losses, JAX
    final params by "/" name)."""
    out = tmp_path_factory.mktemp("sharded_train")
    params, tokens = _inputs()
    np.savez(out / "params.npz", **_flat(params))
    np.savez(out / "tokens.npz", tokens=tokens)
    torch_gang.run_gang("sharded_train", WORLD, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    opt = jax_train.make_optimizer()
    state = jax_train.TrainState(params, opt.init(params),
                                 jnp.zeros((), jnp.int32))
    step = jax.jit(lambda st, t: jax_train.train_step(
        st, t, cfg=JAX_CFG, optimizer=opt))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens[i]))
        losses.append(float(loss))
    return ranks, losses, _flat(state.params)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ``make_sharded_train`` and ``make_scanned_sharded_train`` at
    ``plan_for(4)`` (tp=4) on 4 CPU devices: {"single" | "scanned":
    (losses, final params by "/" name)}."""
    params, tokens = _inputs()
    plan = jax_mesh.plan_for(WORLD)
    assert (plan.dp, plan.fsdp, plan.tp) == (1, 1, 4)
    mesh = jax_mesh.build_mesh(plan, devices=jax.devices()[:WORLD])
    init_fn, step_fn, batch_shard, place = jax_train.make_sharded_train(
        mesh, JAX_CFG)
    state = init_fn(place(params))
    losses = []
    for i in range(STEPS):
        state, loss = step_fn(state, jax.device_put(tokens[i], batch_shard))
        losses.append(float(loss))
    got = {"single": (losses, _flat(state.params))}
    init_fn, scan_fn, scan_shard, place = (
        jax_train.make_scanned_sharded_train(mesh, JAX_CFG))
    state, scanned = scan_fn(init_fn(place(params)),
                             jax.device_put(tokens, scan_shard))
    got["scanned"] = ([float(x) for x in scanned], _flat(state.params))
    return got


@pytest.mark.parametrize("mesh", MESHES)
def test_losses_match_jax_train_step(gang, mesh):
    ranks, want, _ = gang
    for rank in ranks:
        np.testing.assert_allclose(rank[f"{mesh}/losses"], want, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_final_params_match_jax_train_step(gang, mesh):
    ranks, _, want = gang
    for name, ref in want.items():
        got = ranks[0][f"{mesh}/param/{name}"].numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=name)


def _shards(name, mesh):
    """How many ways each dim of a leaf is split on ``mesh``, from the
    reference's specs."""
    spec = pt_llama._PARAM_SPECS
    for part in name.split("/"):
        spec = spec[part]
    return [MESHES[mesh].get(axis, 1) if axis else 1 for axis in spec]


@pytest.mark.parametrize("what", ["local", "local_mu", "local_nu"])
@pytest.mark.parametrize("mesh", MESHES)
def test_params_and_moments_are_sharded(gang, mesh, what):
    ranks, _, want = gang
    for name, ref in want.items():
        local = [ref.shape[d] // n for d, n in enumerate(_shards(name, mesh))]
        for rank in ranks:
            assert rank[f"{mesh}/{what}/{name}"] == tuple(local), name
    # Something is split on every mesh: the embedding, over fsdp or tp.
    assert ranks[0][f"{mesh}/{what}/embed"] != want["embed"].shape


@pytest.mark.parametrize("mesh", MESHES)
def test_replicas_are_equal_across_ranks(gang, mesh):
    # Ranks that hold the same shard of a leaf hold the same bits: every
    # rank for a replicated leaf, the dp replicas for an fsdp shard.
    ranks, _, want = gang
    sizes = MESHES[mesh]
    for name in want:
        shards = _shards(name, mesh)
        groups = {}
        for r, rank in enumerate(ranks):
            # Ranks lie row-major over the mesh, (dp, fsdp, tp).
            axes = [a for a in ("dp", "fsdp", "tp") if a in sizes]
            coord = dict(zip(axes, np.unravel_index(
                r, [sizes[a] for a in axes])))
            spec = pt_llama._PARAM_SPECS
            for part in name.split("/"):
                spec = spec[part]
            key = tuple(coord[a] if a and sizes.get(a, 1) > 1 else 0
                        for a in spec)
            groups.setdefault(key, []).append(
                rank[f"{mesh}/local_param/{name}"])
        assert len(groups) == int(np.prod(shards)), name
        for members in groups.values():
            for other in members[1:]:
                assert torch.equal(members[0], other), name


@pytest.mark.parametrize("mesh", MESHES)
def test_state_step_counts_steps(gang, mesh):
    ranks, _, _ = gang
    assert all(rank[f"{mesh}/step"] == STEPS for rank in ranks)


def test_scanned_steps_equal_single_steps(gang):
    ranks, want, _ = gang
    for rank in ranks:
        assert rank["scanned/step"] == STEPS
        np.testing.assert_allclose(rank["scanned/losses"],
                                   rank["fsdp2_tp2/losses"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["scanned/losses"], want, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("kind", ["single", "scanned"])
def test_tp4_matches_jax_make_sharded_train(gang, jax_sharded, kind):
    # tp=4 over 2 kv heads: JAX's sharded step runs there (XLA pads the
    # split head), and so does the port's, with the same losses and
    # leaves (fp32, TOL).
    ranks, _, _ = gang
    want_losses, want_params = jax_sharded[kind]
    prefix = "tp4" if kind == "single" else "tp4_scanned"
    for rank in ranks:
        np.testing.assert_allclose(rank[f"{prefix}/losses"], want_losses,
                                   rtol=TOL, atol=TOL)
    for name, ref in want_params.items():
        np.testing.assert_allclose(ranks[0][f"{prefix}/param/{name}"].numpy(),
                                   ref, rtol=TOL, atol=TOL, err_msg=name)


def _summary(calls):
    """{(collective, mesh axis): (calls, elements sent)} of a record."""
    out = {}
    for name, axis, shape in calls:
        count, size = out.get((name, axis), (0, 0))
        out[name, axis] = (count + 1, size + int(np.prod(shape)))
    return out


# The collectives of one step (forward, backward, optimizer) on the meshes
# where tp divides the kv heads, by (collective, mesh axis): (calls,
# elements sent). The k/v gather of tp > kv heads must not run here.
# (dp=2, fsdp=2) is the record of the step before that gather existed;
# (fsdp=2, tp=2) that of attention on each rank's local q, k, v, which are
# laid out batch over fsdp and heads over tp first.
STEP_CALLS = {
    "dp2_fsdp2": {
        ("all_gather_into_tensor", "fsdp"): (48, 118880),
        ("all_reduce", "dp"): (14, 106818),
        ("all_reduce", "fsdp"): (5, 16705),
        ("reduce_scatter_tensor", "fsdp"): (9, 106496)},
    "fsdp2_tp2": {
        ("all_gather_into_tensor", "fsdp"): (43, 83968),
        ("all_gather_into_tensor", "tp"): (48, 80000),
        ("all_reduce", "fsdp"): (6, 323),
        ("all_reduce", "tp"): (5, 4417),
        ("reduce_scatter_tensor", "fsdp"): (9, 61440),
        ("reduce_scatter_tensor", "tp"): (32, 200704)},
}


@pytest.mark.parametrize("mesh", STEP_CALLS)
def test_step_collectives_where_tp_divides_the_kv_heads(gang, mesh):
    ranks, _, _ = gang
    for rank in ranks:
        assert _summary(rank[f"{mesh}/step_calls"]) == STEP_CALLS[mesh]


def test_tp4_step_gathers_whole_kv_heads_over_tp(gang):
    # At tp=4 each rank's k and v columns are half a head: the forward
    # gathers them over tp, [B, S, kv * hd / tp] a rank, once for k and
    # once for v in each of the 2 layers. Only tp is left on this mesh.
    ranks, _, _ = gang
    kv_cols = JAX_CFG.n_kv_heads * JAX_CFG.head_dim // 4
    for rank in ranks:
        calls = rank["tp4/step_calls"]
        assert calls.count(("all_gather_into_tensor", "tp",
                            (BATCH, SEQ, kv_cols))) == 2 * JAX_CFG.n_layers
        assert {axis for _, axis, _ in calls} == {"tp"}


@pytest.mark.parametrize("kind", ["losses", "scanned_losses"])
def test_multislice_batch_axes_match_jax_train_step(gang, kind):
    # Two slices of (fsdp=2), the batch over ("dcn", "dp", "fsdp") as the
    # reference's multislice training passes it: the single steps and
    # the scanned call give JAX's single-device losses (fp32, TOL).
    ranks, want, _ = gang
    for rank in ranks:
        np.testing.assert_allclose(rank[f"multislice/{kind}"], want,
                                   rtol=TOL, atol=TOL)


def test_multislice_batch_is_split_four_ways(gang):
    # Each rank holds B / 4 rows: sharded over dcn and fsdp (dp is 1 and
    # dropped), not replicated over the slices.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["multislice/local_batch"] == (BATCH // WORLD, SEQ + 1)
        assert rank["multislice/scanned_local_batch"] == (
            STEPS, BATCH // WORLD, SEQ + 1)
        assert rank["multislice/batch_shard_dims"] == [0, 0]


@pytest.mark.parametrize("label,words", [
    ("order", ("('fsdp', 'dcn')", "('dcn', 'fsdp')")),
    ("missing", ("no axis ep",))])
def test_multislice_batch_axes_refusals(gang, label, words):
    ranks, _, _ = gang
    for rank in ranks:
        for word in words:
            assert word in rank[f"multislice/{label}_error"]


class _Mesh:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


@pytest.mark.parametrize("impl,size,want", [
    ("auto", 1, "auto"), ("auto", 4, "einsum"), ("flash", 4, "flash"),
    ("flash", 1, "flash"), ("einsum", 1, "einsum")])
def test_pin_auto_attn_for_pjit(impl, size, want):
    cfg = dataclasses.replace(pt_llama.LlamaConfig.tiny(), attn_impl=impl)
    assert pt_llama.pin_auto_attn_for_pjit(cfg, _Mesh(size)).attn_impl == want
    # The reference's rule, on the same cases.
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(), attn_impl=impl)
    assert jax_llama.pin_auto_attn_for_pjit(
        jcfg, type("M", (), {"size": size})()).attn_impl == want


def test_gang_pins_einsum_on_four_ranks(gang):
    ranks, _, _ = gang
    assert all(rank[f"{m}/pinned_einsum"] for rank in ranks for m in MESHES)


@pytest.mark.parametrize("axis", ["fsdp", "tp"])
def test_bench_allreduce_over_mesh_axis(gang, axis):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank[f"allreduce/{axis}/participants"] == 2
        assert rank[f"allreduce/{axis}/gbps"] > 0


@pytest.fixture()
def gang_of_one():
    """A one-rank gloo group in this process, as the launcher makes
    without a gang env; the mesh over it."""
    import torch.distributed as dist

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pt_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pt_mesh.build_mesh()
    finally:
        dist.destroy_process_group()


def test_gang_of_one_runs_flash_through_local_map(gang_of_one):
    # One rank: "flash" stays (pin_auto_attn_for_pjit), the kernel wrapper
    # sees the local tensors through local_map (its plain version on the
    # CPU), and the sharded and scanned steps give train_step's losses
    # bit for bit.
    from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash
    from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train

    cfg = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32,
                              attn_impl="flash", loss_chunk=8)
    opt = pt_train.make_optimizer(mu_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))

    def params():
        return pt_llama.init(cfg, torch.Generator().manual_seed(0), "cpu")

    init_fn, step_fn, layout, _ = pt_train.make_sharded_train(
        gang_of_one, cfg, opt)
    _, scan_fn, scan_layout, _ = pt_train.make_scanned_sharded_train(
        gang_of_one, cfg, opt)
    plain = pt_train.TrainState(params(), None, 0)
    plain = plain._replace(opt_state=opt.init(plain.params))
    sharded, scanned = init_fn(params()), init_fn(params())
    batch = layout(tokens)
    want, got = [], []
    for _ in range(STEPS):
        plain, loss = pt_train.train_step(plain, tokens, cfg=cfg,
                                          optimizer=opt)
        want.append(loss.item())
        sharded, loss = step_fn(sharded, batch)
        got.append(loss.item())
    scanned, losses = scan_fn(scanned, scan_layout(
        tokens[None].expand(STEPS, -1, -1)))
    assert got == want and losses.tolist() == want
    assert sharded.params["layers"]["wq"].placements == (
        torch.distributed.tensor.Replicate(),)
    # The CPU path launches no kernel.
    assert pt_flash.flash_attention.launches == 0


# The vocab-parallel embedding lookup, recorded on the (fsdp=2, tp=2) mesh
# around one embed_tokens forward and backward of the step's table and
# batch: (collective, mesh axis, local shape sent) for each collective.
V, D = JAX_CFG.vocab_size, JAX_CFG.d_model
TP = FSDP = 2


@pytest.mark.parametrize("what", ["rows", "grad"])
def test_embed_lookup_equals_the_plain_lookup(gang, what):
    # The rows are one rank's row plus zeros: exact. The gradient sums the
    # same cotangent rows in another order (per rank, then over fsdp).
    ranks, _, _ = gang
    for rank in ranks:
        got, want = rank[f"embed/{what}"], rank[f"embed/want_{what}"]
        if what == "rows":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_embed_local_table_holds_one_vocab_shard(gang):
    # The lookup runs on V / tp rows with the fsdp columns gathered.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["embed/local_tables"] == [(V // TP, D)]


def test_embed_forward_all_reduces_the_rows_over_tp_once(gang):
    # The fsdp gather of the table's columns, then one all-reduce of the
    # rows over tp, and nothing else.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["embed/forward_calls"] == [
            ("all_gather_into_tensor", "fsdp", (V // TP, D // FSDP)),
            ("all_reduce", "tp", (BATCH // FSDP, SEQ + 1, D))]


def test_embed_backward_stays_within_the_vocab_shard(gang):
    # Each rank's gradient is its own vocab shard's: one reduce-scatter
    # over fsdp to the parameter's columns (of the local [V / tp, D]
    # gradient cut into its fsdp column blocks, stacked), nothing over tp.
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["embed/backward_calls"] == [
            ("reduce_scatter_tensor", "fsdp", (FSDP * (V // TP), D // FSDP))]


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_embed_gathers_no_table_rows_over_tp(gang, direction):
    ranks, _, _ = gang
    for rank in ranks:
        assert not [c for c in rank[f"embed/{direction}_calls"]
                    if c[1] == "tp" and c[0] != "all_reduce"]


def test_embed_rows_are_laid_out_like_the_batch(gang):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["embed/rows_placements"] == ["S(0)", "R"]


def test_embed_refuses_a_vocab_tp_does_not_divide(gang):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["embed/indivisible_error"].startswith(
            f"vocab {V - 1} not divisible by tp=2")
