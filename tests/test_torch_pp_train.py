"""The port's pipeline-parallel trainer against the JAX reference: one
4-rank gloo gang (``tests/torch_gang.py``, worker ``pp_train``) trains the
tiny config in fp32 for 2 steps through ``make_pp_train`` on (pp=2, dp=2,
M=2) and (pp=4, dp=1, M=3, 4 layers, remat "full"); JAX's own
``make_pp_train`` on meshes of the same shape over 4 of the CPU devices,
with ``make_optimizer()`` on both sides, is the reference. The (pp=2,
dp=2) case is also held against the port's single-process ``train_step``
on the concatenated M * B rows (GPipe is exact data parallelism over
microbatches)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.parallel.mesh import build_pipeline_mesh
from k8s_dra_driver_gpu_tpu.train import pp_train as jax_pp
from k8s_dra_driver_gpu_tpu.train import train as jax_train
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.train import pp_train as pt_pp
from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train
from tests import torch_gang
from tests.test_torch_moe_train import ILL_GRAD, assert_adam_close

WORLD, STEPS, SEQ = 4, 2, 16
# label: (pp, dp, M, n_layers, remat); the global batch is 2 rows a dp
# column.
CASES = {"pp2_dp2": (2, 2, 2, 2, "none"), "pp4_dp1": (4, 1, 3, 4, "full")}
# fp32 on both sides; the stages sum the loss and the gradients over
# ranks in another order than XLA does (as the MoE trainer's tests).
TOL = 1e-5


def _jax_cfg(n_layers, remat):
    return dataclasses.replace(jax_llama.LlamaConfig.tiny(), n_layers=n_layers,
                               remat=remat, dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = np.asarray(value)
    return out


def _mean_loss(params, tokens, cfg):
    """The loss the pipeline step takes: the mean over the M * B rows."""
    return jax_train.loss_fn(params, tokens.reshape(-1, tokens.shape[-1]),
                             cfg)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Runs the gang once; returns (per-rank results, {case: (JAX losses,
    JAX final params by "/" name, masks of the weights whose reference
    gradient was under ILL_GRAD at some step, the whole model's gradient
    norm at each step)}, {case: (initial params, tokens)})."""
    out = tmp_path_factory.mktemp("pp_train")
    (out / "pp_cases.json").write_text(json.dumps(CASES))
    inputs, want = {}, {}
    for seed, (label, (pp, dp, m, n_layers, remat)) in enumerate(
            CASES.items()):
        cfg = _jax_cfg(n_layers, remat)
        params = jax_llama.init(jax.random.PRNGKey(seed), cfg)
        tokens = np.random.RandomState(10 + seed).randint(
            0, cfg.vocab_size, (STEPS, m, 2 * dp, SEQ + 1)).astype(np.int32)
        np.savez(out / f"params_{label}.npz", **_flat(params))
        np.savez(out / f"tokens_{label}.npz", tokens=tokens)
        inputs[label] = params, tokens
    torch_gang.run_gang("pp_train", WORLD, out, timeout=240)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    grad_fn = jax.jit(jax.grad(_mean_loss), static_argnums=2)
    for label, (pp, dp, m, n_layers, remat) in CASES.items():
        cfg = _jax_cfg(n_layers, remat)
        params, tokens = inputs[label]
        mesh = build_pipeline_mesh(pp, dp, devices=jax.devices()[:WORLD])
        init_fn, step_fn, batch_shard, place = jax_pp.make_pp_train(
            mesh, cfg, n_microbatches=m, optimizer=jax_train.make_optimizer())
        state = init_fn(place(params))
        losses, small, norms = [], None, []
        for step in range(STEPS):
            grads = _flat(grad_fn(jax.tree_util.tree_map(
                np.asarray, state.params), jnp.asarray(tokens[step]), cfg))
            norms.append(float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                           for g in grads.values()))))
            tiny = {k: (g != 0) & (np.abs(g) < ILL_GRAD)
                    for k, g in grads.items()}
            small = tiny if small is None else {
                k: small[k] | tiny[k] for k in tiny}
            state, loss = step_fn(state, jax.device_put(tokens[step],
                                                        batch_shard))
            losses.append(float(loss))
        want[label] = losses, _flat(state.params), small, norms
    return ranks, want, inputs


@pytest.mark.parametrize("case", CASES)
def test_clip_norm_is_the_whole_models(gang, case):
    # The reference clips the global gradient (its optimizer runs outside
    # the shard_map); it must clip at step 1 for the norm to matter. Every
    # rank, whatever its stage, clips by the norm over every stage's
    # layers and the replicated leaves once. (Adam's first step is the
    # same for any clip scale, so the parameters alone would show a
    # stage-local norm only faintly.)
    norms = gang[1][case][3]
    assert norms[0] > 1.0, norms
    for rank in gang[0]:
        np.testing.assert_allclose(rank[f"{case}/clip_norms"], norms,
                                   rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_losses_match_jax_make_pp_train(gang, case):
    ranks, want, _ = gang
    for rank in ranks:
        assert rank[f"{case}/step"] == STEPS
        assert rank[f"{case}/count"] == STEPS
        np.testing.assert_allclose(rank[f"{case}/losses"], want[case][0],
                                   rtol=TOL, atol=TOL)


def _stage_rows(name, rank, case, whole):
    """This rank's block of a leaf: its stage's layer rows, or all."""
    pp = CASES[case][0]
    if not name.startswith("layers/"):
        return whole
    per = whole.shape[0] // pp
    stage = rank[f"{case}/coords"][0]
    return whole[stage * per:(stage + 1) * per]


@pytest.mark.parametrize("case", CASES)
def test_every_parameter_matches_jax_make_pp_train(gang, case):
    ranks, want, _ = gang
    _, final, ill, _ = want[case]
    for r, rank in enumerate(ranks):
        for name, ref in final.items():
            got = rank[f"{case}/param/{name}"].numpy()
            assert_adam_close(got, _stage_rows(name, rank, case, ref),
                              _stage_rows(name, rank, case, ill[name]),
                              f"{case} {name} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_their_stage_rows_and_dp_column(gang, case):
    ranks, _, inputs = gang
    pp, dp, m, n_layers, _ = CASES[case]
    params, tokens = inputs[case]
    whole = _flat(params)
    for r, rank in enumerate(ranks):
        # Row-major over (pp, dp): pp outermost.
        assert rank[f"{case}/coords"] == (r // dp, r % dp)
        for name, leaf in whole.items():
            got = rank[f"{case}/placed/{name}"].numpy()
            block = _stage_rows(name, rank, case, leaf)
            if name.startswith("layers/"):
                assert got.shape[0] == n_layers // pp, name
            np.testing.assert_array_equal(got, block, err_msg=name)
        for moment in ("mu", "nu"):
            for name, leaf in whole.items():
                assert rank[f"{case}/{moment}/{name}"] == _stage_rows(
                    name, rank, case, leaf).shape
        column = r % dp
        np.testing.assert_array_equal(
            rank[f"{case}/local_batch"].numpy(),
            tokens[-1][:, 2 * column:2 * column + 2])


def test_pp_step_is_train_step_on_the_concatenated_microbatches(gang):
    # GPipe is exact data parallelism over microbatches: the port's
    # single-process train_step on the M * B rows of each step.
    ranks, want, inputs = gang
    params, tokens = inputs["pp2_dp2"]
    cfg = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32,
                              remat="none")
    opt = pt_train.make_optimizer()
    whole = params_from_jax(params)
    state = pt_train.TrainState(whole, opt.init(whole), 0)
    losses = []
    for step in range(STEPS):
        rows = torch.from_numpy(tokens[step].reshape(-1, SEQ + 1))
        state, loss = pt_train.train_step(state, rows, cfg=cfg, optimizer=opt)
        losses.append(loss.item())
    final = {k: v.detach().numpy() for k, v in torch_gang._flat(
        state.params).items()}
    _, _, ill, _ = want["pp2_dp2"]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["pp2_dp2/losses"], losses, rtol=TOL,
                                   atol=TOL)
        for name, ref in final.items():
            assert_adam_close(rank[f"pp2_dp2/param/{name}"].numpy(),
                              _stage_rows(name, rank, "pp2_dp2", ref),
                              _stage_rows(name, rank, "pp2_dp2", ill[name]),
                              f"{name} rank {r}")


@pytest.mark.parametrize("label,message", [
    ("layers", "n_layers=2 not divisible by pp=4"),
    ("microbatches", "need at least one microbatch"),
    ("three_microbatches", "tokens must be [M=2, B, S+1], got [3, 2, 9]"),
    ("two_dims", "tokens must be [M=2, B, S+1], got [2, 9]"),
])
def test_refusals(gang, label, message):
    for rank in gang[0]:
        assert rank[f"refusal/{label}"] == message


def test_pp_param_specs_shard_only_the_layer_leaves():
    cfg = pt_llama.LlamaConfig.tiny()
    specs = pt_pp.pp_param_specs(cfg)
    jax_specs = jax_pp.pp_param_specs(_jax_cfg(2, "none"))
    assert set(specs) == set(jax_specs)
    assert set(specs["layers"]) == set(jax_specs["layers"])
    for name, spec in specs["layers"].items():
        assert spec == ("pp",) and tuple(jax_specs["layers"][name]) == ("pp",)
    for name in ("embed", "final_norm", "lm_head"):
        assert specs[name] == () and tuple(jax_specs[name]) == ()
    assert pt_pp.pp_param_specs(cfg, "stage")["layers"]["wq"] == ("stage",)
