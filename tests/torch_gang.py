"""Rank workers of the port's multi-process CPU tests.

    python tests/torch_gang.py WORKER RANK WORLD STORE OUT

runs ``WORKER`` (a function of this module) as rank ``RANK`` of a gloo
gang of ``WORLD`` processes that meet in the ``FileStore`` at ``STORE``;
inputs and results are files in the directory ``OUT``. This module
imports neither JAX nor the JAX package: the tests compute the reference
side in their own process and hand it over as ``.npz`` files.

``run_gang`` starts the ranks and waits for them.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_gang(worker: str, world: int, out: Path, timeout: float = 240.0):
    """Run ``worker`` as a gang of ``world`` processes; raise with the
    ranks' output if any fails."""
    store = out / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, worker, str(rank), str(world), str(store),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    bad = [(rank, proc.returncode, log) for rank, (proc, log)
           in enumerate(zip(procs, logs)) if proc.returncode]
    if bad:
        raise RuntimeError("gang ranks failed:\n" + "\n".join(
            f"--- rank {rank} exit {rc}\n{log[-4000:]}"
            for rank, rc, log in bad))


def _tiny(**changes):
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                               **changes)


def _load_tree(path: Path) -> dict:
    """A nested dict of CPU tensors from an ``.npz`` of "/"-keyed arrays."""
    import numpy as np

    from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax

    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = f[key]
    return params_from_jax(tree)


def _load_params(out: Path) -> dict:
    """The reference's initial parameters, flattened with "/" keys."""
    return _load_tree(out / "params.npz")


def _collectives(mesh):
    """A ``CommDebugMode`` that also keeps, for each collective, its name,
    the mesh axis of its group and the shape of the local tensor it sends:
    ``calls``, a list of ``(name, axis, shape)``."""
    from torch.distributed.tensor.debug import CommDebugMode

    axes = {mesh.get_group(name).group_name: name
            for name in mesh.mesh_dim_names}

    class Collectives(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            packet = getattr(func, "_overloadpacket", None)
            if packet in self.comm_registry:
                # DTensor's collectives name their group last.
                self.calls.append((packet.__name__, axes.get(args[-1]),
                                   tuple(args[0].shape)))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Collectives()


def _recording_lookups(results: dict, key: str):
    """Has ``llama.vocab_shard_lookup`` append the shape of each local
    table it looks ids up in to ``results[key]``; returns the undo."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama

    original = llama.vocab_shard_lookup

    def recording(table, ids, vocab_start):
        results.setdefault(key, []).append(tuple(table.shape))
        return original(table, ids, vocab_start)

    llama.vocab_shard_lookup = recording
    return lambda: setattr(llama, "vocab_shard_lookup", original)


def _flat(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flat(value, f"{prefix}{name}/"))
        else:
            flat[prefix + name] = value
    return flat


def sharded_train(rank: int, world: int, out: Path) -> None:
    """3 sharded steps on each of the meshes (dp=2, fsdp=2), (fsdp=2,
    tp=2) and (tp=4), ``plan_for(4)``, where tp splits the tiny model's 2
    kv heads, then on the last two 3 steps as one scanned call, on the
    tokens of ``tokens.npz`` (the same global batch on every rank); the
    collectives of one more step on each mesh; then the multislice
    layout (``_multislice_train``)."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.ops import collectives
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import train

    cfg = _tiny()
    tokens = np.load(out / "tokens.npz")["tokens"]  # [steps, B, S + 1]
    steps, batch = tokens.shape[:2]
    results = {}
    for label, plan in (("dp2_fsdp2", pmesh.MeshPlan(dp=2, fsdp=2)),
                        ("fsdp2_tp2", pmesh.MeshPlan(fsdp=2, tp=2)),
                        ("tp4", pmesh.plan_for(world))):
        mesh = pmesh.build_mesh(plan)
        pinned = llama.pin_auto_attn_for_pjit(cfg, mesh)
        results[f"{label}/pinned_einsum"] = pinned.attn_impl == "einsum"
        init_fn, step_fn, layout, _ = train.make_sharded_train(mesh, cfg)
        state = init_fn(_load_params(out))
        local = batch // world
        losses = []
        for step in range(steps):
            mine = tokens[step, rank * local:(rank + 1) * local]
            state, loss = step_fn(state, layout(mine))
            losses.append(loss.item())
        results[f"{label}/losses"] = losses
        results[f"{label}/step"] = state.step
        for name, leaf in _flat(state.params).items():
            results[f"{label}/param/{name}"] = leaf.full_tensor().detach()
            results[f"{label}/local/{name}"] = tuple(leaf.to_local().shape)
            results[f"{label}/local_param/{name}"] = leaf.to_local().detach()
        for moment in ("mu", "nu"):
            for name, leaf in _flat(state.opt_state[moment]).items():
                results[f"{label}/local_{moment}/{name}"] = tuple(
                    leaf.to_local().shape)
        state = init_fn(_load_params(out))
        rows = layout(tokens[0, rank * local:(rank + 1) * local])
        with _collectives(pmesh.compute_mesh(mesh)) as one_step:
            step_fn(state, rows)
        results[f"{label}/step_calls"] = one_step.calls
        if label == "tp4":
            _, scan_fn, scan_layout, _ = train.make_scanned_sharded_train(
                mesh, cfg)
            state = init_fn(_load_params(out))
            state, scanned = scan_fn(state, scan_layout(
                tokens[:, rank * local:(rank + 1) * local]))
            results["tp4_scanned/losses"] = scanned.tolist()
            for name, leaf in _flat(state.params).items():
                results[f"tp4_scanned/param/{name}"] = (
                    leaf.full_tensor().detach())
        if label == "fsdp2_tp2":
            _, scan_fn, scan_layout, _ = train.make_scanned_sharded_train(
                mesh, cfg)
            state = init_fn(_load_params(out))
            state, scanned = scan_fn(state, scan_layout(
                tokens[:, rank * local:(rank + 1) * local]))
            results["scanned/losses"] = scanned.tolist()
            results["scanned/step"] = state.step
            for axis in ("fsdp", "tp"):
                stats = collectives.bench_allreduce(mesh, axis, nbytes=1 << 16,
                                                    iters=2)
                results[f"allreduce/{axis}/participants"] = stats[
                    "participants"]
                results[f"allreduce/{axis}/gbps"] = stats["gbps"]
            _embed_lookup(mesh, cfg, out, layout(tokens[0, rank * local:
                                                        (rank + 1) * local]),
                          tokens[0], results)
        del state
    _multislice_train(rank, world, tokens, cfg, out, results)
    torch.save(results, out / f"rank{rank}.pt")


def _embed_lookup(mesh, cfg, out, tokens, global_tokens, results) -> None:
    """One ``embed_tokens`` forward and backward on the parameters' table,
    placed as the sharded step places it, with the collectives of each
    and the shape of the local table the lookup sees; and the rows and
    gradient of the plain ``table[tokens]`` on the whole table."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh

    cmesh = pmesh.compute_mesh(mesh)
    full = _load_params(out)["embed"]
    table = distribute_tensor(full.clone(), cmesh,
                              llama.param_specs(cfg, cmesh)["embed"],
                              src_data_rank=None).requires_grad_()
    cotangent = torch.from_numpy(np.random.RandomState(11).standard_normal(
        (*global_tokens.shape, cfg.d_model)).astype(np.float32))
    undo = _recording_lookups(results, "embed/local_tables")
    try:
        with _collectives(cmesh) as forward:
            rows = llama.embed_tokens(table, tokens)
        with _collectives(cmesh) as backward:
            rows.backward(distribute_tensor(cotangent, cmesh,
                                            rows.placements,
                                            src_data_rank=None))
    finally:
        undo()
    odd = distribute_tensor(torch.zeros(cfg.vocab_size - 1, cfg.d_model),
                            cmesh, table.placements, src_data_rank=None)
    try:
        llama.embed_tokens(odd, tokens)
    except ValueError as err:
        results["embed/indivisible_error"] = str(err)
    plain = full.clone().requires_grad_()
    want = plain[torch.from_numpy(global_tokens).long()]
    want.backward(cotangent)
    results["embed/forward_calls"] = forward.calls
    results["embed/backward_calls"] = backward.calls
    results["embed/rows"] = rows.full_tensor().detach()
    results["embed/rows_placements"] = [str(p) for p in rows.placements]
    results["embed/want_rows"] = want.detach()
    results["embed/grad"] = table.grad.full_tensor()
    results["embed/want_grad"] = plain.grad


def _multislice_train(rank, world, tokens, cfg, out, results) -> None:
    """The reference's multislice layout: 2 slices of (fsdp=2), the batch
    sharded over ("dcn", "dp", "fsdp"); 3 single steps, then 3 steps in
    one scanned call; and the refusals of an axis order DTensor cannot
    lay out and of an axis the mesh lacks."""
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import train

    mesh = pmesh.build_multislice_mesh(2, pmesh.MeshPlan(fsdp=2))
    axes = ("dcn", "dp", "fsdp")
    local = tokens.shape[1] // world
    mine = tokens[:, rank * local:(rank + 1) * local]
    init_fn, step_fn, layout, _ = train.make_sharded_train(
        mesh, cfg, batch_axes=axes)
    state = init_fn(_load_params(out))
    losses = []
    for step in range(tokens.shape[0]):
        batch = layout(mine[step])
        results["multislice/local_batch"] = tuple(batch.to_local().shape)
        results["multislice/batch_shard_dims"] = [
            p.dim if p.is_shard() else None for p in batch.placements]
        state, loss = step_fn(state, batch)
        losses.append(loss.item())
    results["multislice/losses"] = losses
    _, scan_fn, scan_layout, _ = train.make_scanned_sharded_train(
        mesh, cfg, batch_axes=axes)
    state = init_fn(_load_params(out))
    batch = scan_layout(mine)
    results["multislice/scanned_local_batch"] = tuple(batch.to_local().shape)
    state, scanned = scan_fn(state, batch)
    results["multislice/scanned_losses"] = scanned.tolist()
    del state
    for label, bad in (("order", ("fsdp", "dcn")), ("missing", ("ep",))):
        try:
            train.make_sharded_train(mesh, cfg, batch_axes=bad)
        except ValueError as err:
            results[f"multislice/{label}_error"] = str(err)


def sharded_generate(rank: int, world: int, out: Path) -> None:
    """Greedy tokens of ``make_sharded_generate`` on the meshes (dp=2,
    tp=2) and (fsdp=2, tp=2), with the fp and the int8 cache, for the
    prompt of ``prompt.npz``; tokens sampled at temperature 1.0 with a
    generator seeded ``seed`` on every rank, for that prompt and for its
    first row repeated in every row; greedy and sampled tokens for the
    prompt's first row alone (a batch smaller than dp * fsdp); the
    refusal of tp=4 over 2 kv heads; and ``entry.dryrun_multichip(2)``'s
    inside this gang of 4."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import decode
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh

    cfg = _tiny()
    with np.load(out / "prompt.npz") as f:
        prompt = torch.from_numpy(f["prompt"])
        new, max_len, seed = int(f["new"]), int(f["max_len"]), int(f["seed"])
    repeated = prompt[:1].expand_as(prompt).contiguous()
    results = {}
    for label, plan in (("dp2_tp2", pmesh.MeshPlan(dp=2, tp=2)),
                        ("fsdp2_tp2", pmesh.MeshPlan(fsdp=2, tp=2))):
        mesh = pmesh.build_mesh(plan)
        for kind, rows, quant, temperature in (
                ("fp", prompt, False, 0.0), ("int8", prompt, True, 0.0),
                ("sampled", prompt, False, 1.0),
                ("sampled_repeated", repeated, False, 1.0),
                ("one_row", prompt[:1], False, 0.0),
                ("one_row_sampled", prompt[:1], False, 1.0)):
            generate_fn, layout, place = decode.make_sharded_generate(
                mesh, cfg, new, max_len, temperature=temperature,
                kv_quant=quant)
            tokens = generate_fn(place(_load_params(out)), layout(rows),
                                 torch.Generator().manual_seed(seed))
            key = f"{label}/{kind}"
            results[f"{key}/tokens"] = tokens.full_tensor()
            results[f"{key}/placements"] = [str(p) for p in tokens.placements]
            results[f"{key}/local_shape"] = tuple(tokens.to_local().shape)
        _serving_lookups(mesh, cfg, place(_load_params(out)), layout(prompt),
                         max_len, label, results)
    mesh = pmesh.build_mesh(pmesh.MeshPlan(tp=4))
    try:
        decode.make_sharded_generate(mesh, cfg, new, max_len)
    except ValueError as err:
        results["tp4/error"] = str(err)
    from k8s_dra_driver_gpu_tpu_torch import entry

    try:
        entry.dryrun_multichip(2, device="cpu")
    except ValueError as err:
        results["dryrun2/error"] = str(err)
    torch.save(results, out / f"rank{rank}.pt")


def _serving_lookups(mesh, cfg, params, prompt, max_len, label,
                     results) -> None:
    """The collectives of one ``prefill`` and of one ``decode_step`` on
    the placed parameters and prompt, and the shape of each local table
    their lookups see."""
    from torch.distributed.tensor.experimental import implicit_replication

    from k8s_dra_driver_gpu_tpu_torch.models import decode
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh

    cmesh = pmesh.compute_mesh(mesh)
    undo = _recording_lookups(results, f"{label}/local_tables")
    try:
        with implicit_replication():
            with _collectives(cmesh) as prefill:
                logits, cache = decode.prefill(params, prompt, cfg, max_len)
            token = logits.argmax(-1)
            with _collectives(cmesh) as step:
                decode.decode_step(params, cache, token, cfg)
    finally:
        undo()
    results[f"{label}/prefill_calls"] = prefill.calls
    results[f"{label}/decode_calls"] = step.calls


def meshes(rank: int, world: int, out: Path) -> None:
    """Names, shapes and rank grids of the mesh builders on 4 ranks."""
    import torch

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh

    built = {
        "default": pmesh.build_mesh(),
        "dp2_tp2": pmesh.build_mesh(pmesh.MeshPlan(dp=2, tp=2)),
        "multislice2": pmesh.build_multislice_mesh(2),
        "pipeline2": pmesh.build_pipeline_mesh(2),
        "topology_2x2": pmesh.mesh_from_topology("2x2"),
        "topology_2x2_tp2": pmesh.mesh_from_topology("2x2", tp=2),
    }
    results = {}
    for label, mesh in built.items():
        results[label] = {
            "names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
            "ranks": mesh.mesh.tolist(),
            "compute_names": tuple(
                pmesh.compute_mesh(mesh).mesh_dim_names)}
    try:
        pmesh.build_mesh(pmesh.MeshPlan(dp=3))
    except ValueError as err:
        results["mismatch_error"] = str(err)
    torch.save(results, out / f"rank{rank}.pt")


def _moe_tiny():
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama_moe

    return dataclasses.replace(llama_moe.LlamaMoEConfig.tiny(),
                               dtype=torch.float32)


def moe_train(rank: int, world: int, out: Path) -> None:
    """2 steps of ``make_moe_train`` on each of the meshes (dp=2, ep=2) and
    (dp=1, ep=4) on the tokens of ``tokens.npz`` (each rank hands in its
    rows of the global batch); then ``make_sharded_moe`` at ep=4 on layer
    0's weights and the activations of ``moe_x.npz``."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama_moe, moe
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh

    cfg = _moe_tiny()
    tokens = np.load(out / "tokens.npz")["tokens"]  # [steps, B, S + 1]
    local = tokens.shape[1] // world
    results = {}
    for label, (dp, ep) in (("dp2_ep2", (2, 2)), ("dp1_ep4", (1, 4))):
        mesh = pmesh.build_expert_mesh(ep, dp)
        init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, cfg)
        state = init_fn(_load_params(out))
        losses = []
        for step in range(tokens.shape[0]):
            batch = layout(tokens[step, rank * local:(rank + 1) * local])
            results[f"{label}/local_batch"] = batch
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
        results[f"{label}/losses"] = losses
        results[f"{label}/step"] = state.step
        results[f"{label}/coords"] = (mesh.get_local_rank("dp"),
                                      mesh.get_local_rank("ep"))
        for name, leaf in _flat(state.params).items():
            results[f"{label}/param/{name}"] = leaf.detach()
        for moment in ("mu", "nu"):
            for name, leaf in _flat(state.opt_state[moment]).items():
                results[f"{label}/{moment}/{name}"] = tuple(leaf.shape)
    mesh = pmesh.build_expert_mesh(4, 1)
    fn, place = moe.make_sharded_moe(mesh, "ep", top_k=cfg.top_k,
                                     dtype=torch.float32)
    layers = _load_params(out)["layers"]
    placed = place({name: layers[name][0]
                    for name in ("router", "w_in", "w_out")})
    results["sharded_moe/local_experts"] = placed["w_in"].shape[0]
    x = torch.from_numpy(np.load(out / "moe_x.npz")["x"])
    results["sharded_moe/out"], results["sharded_moe/aux"] = fn(placed, x)
    torch.save(results, out / f"rank{rank}.pt")


def moe_launcher(rank: int, world: int, out: Path) -> None:
    """The launcher's ``--model moe-tiny`` run over 2 nodes of 2 local
    ranks, here without the launcher: ``make_moe_train`` on its (dp, ep)
    mesh, its seeded init and each rank's rows of its synthetic batches
    (shape in ``launch.npz``); the losses of every step."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama_moe
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import main

    with np.load(out / "launch.npz") as f:
        steps, batch, seq, local_ranks = (int(f[k]) for k in (
            "steps", "batch", "seq", "local_ranks"))
    cfg = llama_moe.LlamaMoEConfig.tiny()
    dp, ep = main.moe_mesh_shape(world, cfg.n_experts)
    mesh = pmesh.build_expert_mesh(ep, dp)
    init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, cfg)
    state = init_fn(llama_moe.init(cfg, torch.Generator().manual_seed(0),
                                   "cpu"))
    node, local = divmod(rank, local_ranks)
    rows = batch // local_ranks
    losses = []
    for step in range(steps):
        mine = main.synthetic_batch(step, batch, seq, cfg.vocab_size, node)
        state, loss = step_fn(state, layout(
            mine[local * rows:(local + 1) * rows]))
        losses.append(loss.item())
    torch.save({"losses": losses, "mesh": (dp, ep)}, out / f"rank{rank}.pt")


def sp_train(rank: int, world: int, out: Path) -> None:
    """2 steps of ``make_sp_train`` with ring attention on (dp=1, sp=4) and
    (dp=2, sp=2) and with Ulysses on (dp=2, sp=2), on the tokens of
    ``tokens.npz``; ring attention at sp=4 on the q, k, v and cotangent
    of ``ring.npz``, its output and gradients; Ulysses' refusal of sp=4
    over 2 kv heads; and ``make_sp_train``'s of an unknown attention."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.parallel import ring_attention, ulysses
    from k8s_dra_driver_gpu_tpu_torch.train import sp_train as pt_sp

    cfg = _tiny()
    tokens = np.load(out / "tokens.npz")["tokens"]  # [steps, B, S + 1]
    local = tokens.shape[1] // world
    results = {}
    for label, attn, dp, sp in (("ring_dp1_sp4", "ring", 1, 4),
                                ("ring_dp2_sp2", "ring", 2, 2),
                                ("ulysses_dp2_sp2", "ulysses", 2, 2)):
        mesh = pmesh.build_mesh(pmesh.MeshPlan(dp=dp, sp=sp))
        init_fn, step_fn, layout, _ = pt_sp.make_sp_train(mesh, cfg, attn)
        state = init_fn(_load_params(out))
        losses = []
        for step in range(tokens.shape[0]):
            state, loss = step_fn(state, layout(
                tokens[step, rank * local:(rank + 1) * local]))
            losses.append(loss.item())
        results[f"{label}/losses"] = losses
        results[f"{label}/step"] = state.step
        for name, leaf in _flat(state.params).items():
            results[f"{label}/param/{name}"] = leaf.detach()
    mesh = pmesh.build_mesh(pmesh.MeshPlan(sp=4))
    fn, place = ring_attention.make_ring_attention(mesh)
    with np.load(out / "ring.npz") as f:
        q, k, v, cot = (torch.from_numpy(f[n]) for n in ("q", "k", "v",
                                                         "cot"))
    leaves = [place(t).requires_grad_() for t in (q, k, v)]
    got = fn(*leaves)
    (got * place(cot)).sum().backward()
    results["ring/out"] = got.detach()
    for name, leaf in zip(("dq", "dk", "dv"), leaves):
        results[f"ring/{name}"] = leaf.grad
    fn, place = ulysses.make_ulysses_attention(mesh)
    try:
        fn(*(place(t) for t in (q, k, v)))
    except ValueError as err:
        results["ulysses/refusal"] = str(err)
    try:
        pt_sp.make_sp_train(mesh, cfg, attn="flash")
    except ValueError as err:
        results["unknown_attn"] = str(err)
    torch.save(results, out / f"rank{rank}.pt")


def _recording_optimizer(norms: list):
    """``make_optimizer()`` that appends to ``norms`` the clip norm each
    update uses."""
    from k8s_dra_driver_gpu_tpu_torch.train import train

    class Recording(train.AdamW):
        def update(self, grads, opt_state, params, sq_norm=None):
            used = train.squared_norm(grads) if sq_norm is None else sq_norm
            norms.append(used.sqrt().item())
            return super().update(grads, opt_state, params, sq_norm)

    return Recording()


def pp_train(rank: int, world: int, out: Path) -> None:
    """For each case of ``pp_cases.json`` ({label: [pp, dp, M, n_layers,
    remat]}): ``make_pp_train`` on the (pp, dp) mesh from the parameters
    of ``params_<label>.npz``, the layer rows it placed, and the losses
    and local parameters after the steps of ``tokens_<label>.npz``
    ([steps, M, B, S + 1], the global microbatches on every rank); then
    the refusals."""
    import json

    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import pp_train as pt_pp

    cases = json.loads((out / "pp_cases.json").read_text())
    results = {}
    for label, (pp, dp, m, n_layers, remat) in cases.items():
        cfg = _tiny(n_layers=n_layers, remat=remat)
        mesh = pmesh.build_pipeline_mesh(pp, dp)
        norms = results[f"{label}/clip_norms"] = []
        init_fn, step_fn, layout, _ = pt_pp.make_pp_train(
            mesh, cfg, m, _recording_optimizer(norms))
        state = init_fn(_load_tree(out / f"params_{label}.npz"))
        results[f"{label}/coords"] = (mesh.get_local_rank("pp"),
                                      mesh.get_local_rank("dp"))
        for name, leaf in _flat(state.params).items():
            results[f"{label}/placed/{name}"] = leaf.detach().clone()
        tokens = np.load(out / f"tokens_{label}.npz")["tokens"]
        losses = []
        for step in range(tokens.shape[0]):
            batch = layout(tokens[step])
            results[f"{label}/local_batch"] = batch
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
        results[f"{label}/losses"] = losses
        results[f"{label}/step"] = state.step
        results[f"{label}/count"] = state.opt_state["count"]
        for name, leaf in _flat(state.params).items():
            results[f"{label}/param/{name}"] = leaf.detach()
        for moment in ("mu", "nu"):
            for name, leaf in _flat(state.opt_state[moment]).items():
                results[f"{label}/{moment}/{name}"] = tuple(leaf.shape)
    mesh = pmesh.build_pipeline_mesh(4, 1)
    for label, n_layers, m in (("layers", 2, 2), ("microbatches", 4, 0)):
        try:
            pt_pp.make_pp_train(mesh, _tiny(n_layers=n_layers), m)
        except ValueError as err:
            results[f"refusal/{label}"] = str(err)
    _, step_fn, layout, _ = pt_pp.make_pp_train(mesh, _tiny(n_layers=4), 2)
    for label, shape in (("three_microbatches", (3, 2, 9)),
                         ("two_dims", (2, 9))):
        try:
            step_fn(None, torch.zeros(shape, dtype=torch.int64))
        except ValueError as err:
            results[f"refusal/{label}"] = str(err)
    torch.save(results, out / f"rank{rank}.pt")


def _local(leaf):
    """A clone of the rank's own block of a state leaf."""
    from torch.distributed.tensor import DTensor

    leaf = leaf.detach()
    return (leaf.to_local() if isinstance(leaf, DTensor) else leaf).clone()


def _state_blocks(state) -> dict:
    """Every tensor of a TrainState, the rank's own blocks, by "/" name."""
    blocks = {f"params/{k}": _local(v) for k, v in _flat(state.params).items()}
    for moment in ("mu", "nu"):
        blocks.update({f"{moment}/{k}": _local(v) for k, v in _flat(
            state.opt_state[moment]).items()})
    return blocks


def _differing(got: dict, want: dict) -> list:
    """Names whose tensors differ in dtype or in any bit."""
    import torch

    return [name for name in want if got[name].dtype != want[name].dtype
            or not torch.equal(got[name], want[name])]


def checkpoint(rank: int, world: int, out: Path) -> None:
    """For each family, 2 steps from seed 0, a save at step 2, step 3;
    then a fresh init from seed 1 restored from the save, and its step 3:
    the leaves that differ from the saved state and from the uninterrupted
    step 3, the counters, and the global shapes in the saved metadata;
    the MoE state saved without ``per_rank_axes`` and the pipeline state
    saved without its specs."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed.checkpoint as dcp

    from k8s_dra_driver_gpu_tpu_torch.models import llama, llama_moe
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import pp_train as pt_pp
    from k8s_dra_driver_gpu_tpu_torch.train import train
    from k8s_dra_driver_gpu_tpu_torch.train.checkpoint import (
        TrainCheckpointer)

    tokens = np.load(out / "tokens.npz")["tokens"]  # [3, M=2, B, S + 1]
    local = tokens.shape[2] // world
    bf16_mu = train.make_optimizer(mu_dtype=torch.bfloat16)
    cfg, moe_cfg = _tiny(), _moe_tiny()

    def sharded():
        mesh = pmesh.build_mesh(pmesh.MeshPlan(fsdp=2, tp=2))
        init_fn, step_fn, layout, _ = train.make_sharded_train(mesh, cfg,
                                                               bf16_mu)
        return (lambda seed: init_fn(llama.init(
                    cfg, torch.Generator().manual_seed(seed), "cpu")),
                step_fn, lambda step: layout(
                    tokens[step, 0, rank * local:(rank + 1) * local]),
                {})

    def moe():
        mesh = pmesh.build_expert_mesh(2, 2)
        init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, moe_cfg)
        return (lambda seed: init_fn(llama_moe.init(
                    moe_cfg, torch.Generator().manual_seed(seed), "cpu")),
                step_fn, lambda step: layout(
                    tokens[step, 0, rank * local:(rank + 1) * local]),
                dict(mesh=mesh, specs=llama_moe.param_specs(moe_cfg),
                     per_rank_axes=("ep",)))

    def pipeline():
        pcfg = dataclasses.replace(cfg, n_layers=4)
        mesh = pmesh.build_pipeline_mesh(2, 2)
        init_fn, step_fn, layout, _ = pt_pp.make_pp_train(mesh, pcfg, 2,
                                                          bf16_mu)
        return (lambda seed: init_fn(llama.init(
                    pcfg, torch.Generator().manual_seed(seed), "cpu")),
                step_fn, lambda step: layout(tokens[step]),
                dict(mesh=mesh, specs=pt_pp.pp_param_specs(pcfg)))

    results = {}
    for family, build in (("sharded", sharded), ("moe", moe),
                          ("pp", pipeline)):
        init, step_fn, batch, where = build()
        ckpt = TrainCheckpointer(str(out / f"ckpt_{family}"), **where)
        state = init(0)
        for step in range(2):
            state, _ = step_fn(state, batch(step))
        results[f"{family}/saved"] = ckpt.save(state.step, state)
        results[f"{family}/saved_again"] = ckpt.save(state.step, state)
        saved = _state_blocks(state)
        state, loss = step_fn(state, batch(2))
        uninterrupted = _state_blocks(state), loss
        del state

        fresh = init(1)
        results[f"{family}/fresh_differs"] = bool(_differing(
            _state_blocks(fresh), saved))
        restored = ckpt.restore(fresh)
        results[f"{family}/counters"] = (restored.step,
                                         restored.opt_state["count"])
        results[f"{family}/restored_differs"] = _differing(
            _state_blocks(restored), saved)
        results[f"{family}/mu_dtype"] = str(_flat(
            restored.opt_state["mu"])["layers/wq"].dtype)
        restored, loss = step_fn(restored, batch(2))
        results[f"{family}/step3_differs"] = _differing(
            _state_blocks(restored), uninterrupted[0])
        results[f"{family}/step3_losses"] = (loss.item(),
                                             uninterrupted[1].item())
        meta = dcp.FileSystemReader(str(out / f"ckpt_{family}" / "2")
                                    ).read_metadata().state_dict_metadata
        results[f"{family}/metadata"] = {
            key: tuple(value.size) for key, value in meta.items()}
        if family == "moe":
            # Step 3's state saved once a replicated leaf (without
            # per_rank_axes), restored into another fresh init.
            once = TrainCheckpointer(str(out / "ckpt_moe_once"),
                                     mesh=where["mesh"], specs=where["specs"])
            once.save(restored.step, restored)
            results["moe_once/restored_differs"] = _differing(
                _state_blocks(once.restore(init(1))), _state_blocks(restored))
        if family == "pp":
            # The same state without its specs: each stage's plain layer
            # rows look replicated, and one rank's are all that is kept.
            plain = TrainCheckpointer(str(out / "ckpt_pp_plain"))
            plain.save(restored.step, restored)
            meta = dcp.FileSystemReader(str(out / "ckpt_pp_plain" / "3")
                                        ).read_metadata().state_dict_metadata
            results["pp_plain/metadata"] = {
                key: tuple(value.size) for key, value in meta.items()}
        del restored, fresh
    torch.save(results, out / f"rank{rank}.pt")


def pp_launcher(rank: int, world: int, out: Path) -> None:
    """The launcher's ``--pp`` run over nodes of local ranks, here without
    the launcher: ``make_pp_train`` on its (pp, dp) mesh, its seeded init
    and the global microbatches of its synthetic batches (sizes in
    ``launch.npz``); the losses of every step."""
    import numpy as np
    import torch

    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pmesh
    from k8s_dra_driver_gpu_tpu_torch.train import main, pp_train

    with np.load(out / "launch.npz") as f:
        steps, batch, seq, nodes, pp, m = (int(f[k]) for k in (
            "steps", "batch", "seq", "nodes", "pp", "microbatches"))
    cfg = llama.LlamaConfig.tiny()
    mesh = pmesh.build_pipeline_mesh(pp)
    init_fn, step_fn, layout, _ = pp_train.make_pp_train(mesh, cfg, m)
    state = init_fn(llama.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    losses = []
    for step in range(steps):
        tokens = np.stack([np.concatenate([
            main.synthetic_batch(step * m + i, batch, seq, cfg.vocab_size, s)
            for s in range(nodes)]) for i in range(m)])
        state, loss = step_fn(state, layout(tokens))
        losses.append(loss.item())
    torch.save({"losses": losses}, out / f"rank{rank}.pt")


WORKERS = {"meshes": meshes, "sharded_train": sharded_train,
           "sharded_generate": sharded_generate, "moe_train": moe_train,
           "moe_launcher": moe_launcher, "sp_train": sp_train,
           "pp_train": pp_train, "checkpoint": checkpoint,
           "pp_launcher": pp_launcher}


def main(argv: list[str]) -> int:
    worker, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        WORKERS[worker](rank, world, Path(out))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
