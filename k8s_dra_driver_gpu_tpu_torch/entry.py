"""Entry points of the port: a forward of the tiny flagship, and dry runs
of every parallelism family on n ranks.

    python -m k8s_dra_driver_gpu_tpu_torch.entry [--dryrun N] [--device cpu]

The port of the repo's ``__graft_entry__.py``:

- ``entry()`` returns a forward of the flagship architecture at its tiny
  shapes (``LlamaConfig.tiny()``) with example arguments.
- ``dryrun_multichip(n)`` runs one real step of each family on n ranks:
  dp x fsdp x tp (single and scanned), sequence parallelism (ring and
  Ulysses), MoE-Llama over (dp, ep), pipeline over (pp, dp), multislice
  over a "dcn" dim, and sharded serving. The reference runs them on n
  virtual devices in one process; here a device is a rank, and the
  function starts its ranks itself unless it is called inside a process
  group of n ranks.
- ``dryrun_multichip_multiprocess`` runs ``train.verify`` as a real
  multi-process gang whose env comes from a ComputeDomain daemon's
  ``bootstrap.json``, with daemon names resolved through the
  ``members.json`` beside it.

Everything runs on the card unless ``device="cpu"`` is asked for; without
a card the entry points raise rather than fall back to the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from .computedomain import (BOOTSTRAP_KEYS, JAX_COORDINATOR_PORT,
                            daemon_dns_name)  # noqa: F401 - re-exported
from .computedomain.daemon.dnsnames import dns_name_mappings
from .models import llama
from .ops import resolve_device

# The ComputeDomain daemon's file contract: the coordinator port it
# advertises, the stable DNS names of the daemons and the keys of its
# bootstrap.json.
COORDINATOR_PORT = JAX_COORDINATOR_PORT

# The seeds of each dry-run family's parameters and tokens, the numbers of
# the reference's PRNGKeys (None: the family reuses the state before it).
FAMILY_SEEDS = {"train": (0, 1), "scan": (None, 11), "sp": (2, 3),
                "ep": (4, 5), "pp": (8, 9), "multislice": (6, 7),
                "serve": (0, 10)}
# A rank started by ``dryrun_multichip`` writes rank 0's report here.
REPORT_VAR = "TORCH_ENTRY_REPORT"
_MODULE = "k8s_dra_driver_gpu_tpu_torch.entry"


def entry(device: str | torch.device | None = None):
    """-> (fn, example_args): the forward of the tiny flagship, parameters
    drawn from a generator seeded 0, tokens ``zeros(2, 32)``."""
    device = resolve_device(device)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
    tokens = torch.zeros(2, 32, dtype=torch.int32, device=device)

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return llama.forward(params, tokens, cfg)

    return fn, (params, tokens)


def draw_params(cfg, seed: int, device: torch.device, init=llama.init
                ) -> dict:
    """``init(cfg, ...)`` from a CPU generator seeded ``seed``, moved to
    ``device``: the same numbers on every rank and every device."""
    from .train.train import tree_map

    params = init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return tree_map(lambda leaf: leaf.to(device), params)


def draw_tokens(seed: int, shape, vocab_size: int, device: torch.device
                ) -> torch.Tensor:
    """Token ids of ``shape`` from a CPU generator seeded ``seed``."""
    ids = torch.randint(0, vocab_size, tuple(shape),
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.int32)
    return ids.to(device)


def _global_batch(mesh, tokens: torch.Tensor, axes, batch_dim: int = 0):
    """The whole batch (the same on every rank) as a DTensor on the
    mesh's dims > 1, sharded along ``batch_dim`` over ``axes``: the
    reference's ``device_put`` of its global batch."""
    from torch.distributed.tensor import distribute_tensor

    from .parallel.mesh import compute_mesh, placements

    cmesh = compute_mesh(mesh)
    spec = [None] * batch_dim + [tuple(axes)]
    return distribute_tensor(tokens, cmesh, placements(spec, cmesh),
                             src_data_rank=None)


def _dp_rows(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's dp shard of the whole batch (the manual-SPMD
    trainers' input)."""
    from .ops.collectives import MeshAxis

    dp = MeshAxis(mesh, "dp")
    return tokens.chunk(dp.size)[dp.index].contiguous()


def _mesh_dims(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dryrun(n: int, device: torch.device) -> dict:
    """Every family on the current process group of ``n`` ranks; the
    report of this rank."""
    import torch.distributed as dist

    from .models import llama_moe
    from .models.decode import make_sharded_generate
    from .parallel.mesh import (MeshPlan, build_expert_mesh, build_mesh,
                                build_multislice_mesh, build_pipeline_mesh,
                                plan_for)
    from .train.pp_train import make_pp_train
    from .train.sp_train import make_sp_train
    from .train.train import make_scanned_sharded_train, make_sharded_train

    cfg = llama.LlamaConfig.tiny()
    rank0 = dist.get_rank() == 0
    report = {}
    # The reference's 4 rows a training batch, rounded up to a multiple
    # of n.
    rows = -(-4 // n) * n

    def fit_sp(want: int) -> int:
        """Largest power-of-two size <= want that divides n."""
        sp = want
        while sp > 1 and n % sp:
            sp //= 2
        return sp

    def run(key: str, label: str, body):
        """Run one family, timed to its end on the device; record and
        print its result, or why it was skipped."""
        t0 = time.perf_counter()
        result = body()
        if "skipped" not in result and device.type == "cuda":
            torch.cuda.synchronize()
        result["seconds"] = time.perf_counter() - t0
        report[key] = result
        if not rank0:
            return
        if "skipped" in result:
            line = f"skipped ({result['skipped']})"
        else:  # the reference's line, losses to 4 places
            shown = [f"{k}={result[k]}" for k in ("mesh", "step")
                     if k in result]
            if "loss" in result:
                shown.append(f"loss={result['loss']:.4f}")
            if "losses" in result:
                losses = [round(x, 4) for x in result["losses"]]
                shown.append(f"losses={losses}")
            if "tokens" in result:
                tokens = result["tokens"]
                shown.append(f"tokens={(len(tokens), len(tokens[0]))}")
            line = " ".join(shown)
        print(f"dryrun_multichip{label}: {line}", flush=True)

    def loss_of(result: dict, loss) -> dict:
        result["loss"] = loss.item()
        return result

    # -- 1. dp x fsdp x tp, then the scanned dispatch on the same state --
    state_1 = {}

    def train():
        mesh = build_mesh(plan_for(n))
        init_fn, step_fn, _, _ = make_sharded_train(mesh, cfg)
        p_seed, t_seed = FAMILY_SEEDS["train"]
        state = init_fn(draw_params(cfg, p_seed, device))
        shape = (rows, 33)
        state, loss = step_fn(state, _global_batch(
            mesh, draw_tokens(t_seed, shape, cfg.vocab_size, device),
            ("dp", "fsdp")))
        state_1.update(mesh=mesh, state=state)
        return loss_of({"mesh": _mesh_dims(mesh), "step": state.step,
                        "batch": list(shape)}, loss)

    def scan():
        mesh, state = state_1.pop("mesh"), state_1.pop("state")
        _, scan_fn, _, _ = make_scanned_sharded_train(mesh, cfg)
        shape = (2, rows, 33)
        state, losses = scan_fn(state, _global_batch(
            mesh, draw_tokens(FAMILY_SEEDS["scan"][1], shape,
                              cfg.vocab_size, device),
            ("dp", "fsdp"), batch_dim=1))
        return {"step": state.step, "losses": losses.tolist(),
                "batch": list(shape)}

    run("train", "", train)
    run("scan", "[scan]", scan)

    # -- 2. sequence parallelism: ring (sp=4) and Ulysses (sp=2) ---------
    def sp_family(attn: str, want: int):
        sp = fit_sp(want)
        if sp < 2:
            return {"skipped": f"no sp>=2 divides {n} devices"}
        dp = n // sp
        mesh = build_mesh(MeshPlan(dp=dp, sp=sp))
        init_fn, step_fn, _, _ = make_sp_train(mesh, cfg, attn=attn)
        p_seed, t_seed = FAMILY_SEEDS["sp"]
        state = init_fn(draw_params(cfg, p_seed, device))
        shape = (dp * 2, sp * 16 + 1)
        state, loss = step_fn(state, _dp_rows(mesh, draw_tokens(
            t_seed, shape, cfg.vocab_size, device)))
        return loss_of({"mesh": f"dp{dp}xsp{sp}", "step": state.step,
                        "batch": list(shape)}, loss)

    for attn, want in (("ring", 4), ("ulysses", min(2, cfg.n_kv_heads))):
        run(f"sp:{attn}", f"[sp:{attn}]",
            lambda attn=attn, want=want: sp_family(attn, want))

    # -- 3. expert parallelism: a MoE-Llama step over (dp, ep) -----------
    mcfg = llama_moe.LlamaMoEConfig.tiny()

    def ep_family():
        ep = fit_sp(min(4, mcfg.n_experts))
        if ep < 2:
            return {"skipped": f"no ep>=2 divides {n} devices"}
        dp = n // ep
        mesh = build_expert_mesh(ep, dp)
        init_fn, step_fn, _, _ = llama_moe.make_moe_train(mesh, mcfg)
        p_seed, t_seed = FAMILY_SEEDS["ep"]
        state = init_fn(draw_params(mcfg, p_seed, device, llama_moe.init))
        shape = (dp * 2, 17)
        state, loss = step_fn(state, _dp_rows(mesh, draw_tokens(
            t_seed, shape, mcfg.vocab_size, device)))
        return loss_of({"mesh": f"dp{dp}xep{ep}", "step": state.step,
                        "batch": list(shape)}, loss)

    run("ep", "[ep]", ep_family)

    # -- 4. pipeline parallelism: GPipe over (pp, dp) --------------------
    def pp_family():
        pp = fit_sp(4)
        if pp < 2:
            return {"skipped": f"no pp>=2 divides {n} devices"}
        dp = n // pp
        pcfg = dataclasses.replace(cfg, n_layers=pp)  # a layer a stage
        mesh = build_pipeline_mesh(pp, dp)
        init_fn, step_fn, layout, _ = make_pp_train(mesh, pcfg,
                                                    n_microbatches=pp)
        p_seed, t_seed = FAMILY_SEEDS["pp"]
        state = init_fn(draw_params(pcfg, p_seed, device))
        shape = (pp, dp * 2, 17)
        state, loss = step_fn(state, layout(draw_tokens(
            t_seed, shape, pcfg.vocab_size, device)))
        return loss_of({"mesh": f"pp{pp}xdp{dp}", "step": state.step,
                        "batch": list(shape)}, loss)

    run("pp", "[pp]", pp_family)

    # -- 5. multislice: 2 slices over a "dcn" dim ------------------------
    def multislice():
        num_slices = 2
        if n % num_slices:
            return {"skipped": f"{n} devices not divisible into "
                               f"{num_slices} slices"}
        mesh = build_multislice_mesh(num_slices, plan_for(n // num_slices))
        axes = ("dcn", "dp", "fsdp")
        init_fn, step_fn, _, _ = make_sharded_train(mesh, cfg,
                                                    batch_axes=axes)
        p_seed, t_seed = FAMILY_SEEDS["multislice"]
        state = init_fn(draw_params(cfg, p_seed, device))
        shape = (rows, 33)
        state, loss = step_fn(state, _global_batch(
            mesh, draw_tokens(t_seed, shape, cfg.vocab_size, device), axes))
        return loss_of({"mesh": _mesh_dims(mesh), "step": state.step,
                        "batch": list(shape)}, loss)

    run("multislice", "[multislice]", multislice)

    # -- 6. serving: sharded KV-cache generate over dp x tp ---------------
    def serve():
        tp = fit_sp(min(4, cfg.n_kv_heads))  # whole kv heads a tp shard
        mesh = build_mesh(MeshPlan(dp=n // tp, tp=tp))
        generate_fn, layout, place = make_sharded_generate(
            mesh, cfg, max_new_tokens=4, max_len=16)
        p_seed, t_seed = FAMILY_SEEDS["serve"]
        # The reference's prompt: a row a device.
        shape = (n, 8)
        tokens = generate_fn(
            place(draw_params(cfg, p_seed, device)),
            layout(draw_tokens(t_seed, shape, cfg.vocab_size, device)))
        return {"mesh": _mesh_dims(mesh),
                "tokens": tokens.full_tensor().tolist(),
                "batch": list(shape)}

    run("serve", "[serve]", serve)
    return report


def dryrun_multichip(n_devices: int,
                     device: str | torch.device | None = None) -> dict:
    """One real step of each parallelism family on ``n_devices`` ranks at
    the tiny config; returns the report (rank 0's where this call starts
    the ranks): for each family (``train``,
    ``scan``, ``sp:ring``, ``sp:ulysses``, ``ep``, ``pp``, ``multislice``,
    ``serve``) its mesh, step, loss (losses for ``scan``, tokens for
    ``serve``), batch shape and seconds, or why it was skipped.

    Inside a process group of ``n_devices`` ranks it runs in place on
    every rank. Outside one it starts ``n_devices`` ranks on this host
    (``python -m k8s_dra_driver_gpu_tpu_torch.entry --dryrun N``): gloo
    ranks with ``device="cpu"``, else NCCL ranks with a card each; it
    raises when fewer cards are visible."""
    import torch.distributed as dist

    from .train.main import _run_local_ranks

    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a "
                             f"process group of {world} ranks")
        device = resolve_device(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _dryrun(n_devices, device)
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, "
                           f"{torch.cuda.device_count()} visible")
    # The ranks are one node's: no ComputeDomain env of the caller's.
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_"))}
    with tempfile.TemporaryDirectory() as tmp:
        env[REPORT_VAR] = os.path.join(tmp, "report.json")
        env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get(
            "PYTHONPATH", "")
        rc = _run_local_ranks(["--dryrun", str(n_devices), "--device",
                               device.type], n_devices, module=_MODULE,
                              env=env)
        if rc:
            raise RuntimeError(f"a dry-run rank exited with {rc}")
        with open(env[REPORT_VAR], encoding="utf-8") as f:
            return json.load(f)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_bootstrap(bootstrap_file: str) -> tuple[int, str, list[str]]:
    """(process count, coordinator, hostnames) of a daemon's
    bootstrap.json, daemon names resolved to addresses through the
    members.json beside it when there is one."""
    with open(bootstrap_file, encoding="utf-8") as f:
        boot = json.load(f)
    missing = [key for key in BOOTSTRAP_KEYS if key not in boot]
    if missing:
        raise ValueError(f"{bootstrap_file} lacks {', '.join(missing)}")
    coordinator = boot["coordinatorAddress"]
    hostnames = list(boot["workerHostnames"])
    members_file = os.path.join(os.path.dirname(bootstrap_file),
                                "members.json")
    if os.path.exists(members_file):
        with open(members_file, encoding="utf-8") as f:
            name_to_ip = dns_name_mappings(json.load(f).get("workers", []))
        host, _, port = coordinator.rpartition(":")
        coordinator = f"{name_to_ip.get(host, host)}:{port}"
        hostnames = [name_to_ip.get(h, h) for h in hostnames]
    return int(boot["numProcesses"]), coordinator, hostnames


def dryrun_multichip_multiprocess(
    n_procs: int = 2,
    local_devices: int = 4,
    bootstrap_file: str | None = None,
    timeout: float = 600.0,
    device: str | torch.device | None = None,
) -> list[dict]:
    """A real multi-process gang: ``n_procs`` node processes of
    ``train.verify --require-gang --steps 2``, each with
    ``local_devices`` ranks, joined from the ComputeDomain env.

    With ``bootstrap_file`` (a daemon's bootstrap.json) the env comes from
    it: coordinator, process count and positional hostnames, daemon names
    resolved through the members.json beside it, as a workload pod
    consumes the mounted domain dir. Without one, a local contract on
    ``127.0.0.1:COORDINATOR_PORT`` is made up. On the card the local
    ranks are the visible cards (``local_devices`` must equal their
    count); with ``device="cpu"`` they are gloo ranks.

    Returns the node reports after checking that the gang computed one
    result: every ``globalDevices`` and ``devSum`` is n_procs *
    local_devices, every ``rankSum`` is local_devices * (1 + ... +
    n_procs), and the loss is the same on every node."""
    device = resolve_device(device)
    if device.type == "cuda" and local_devices != torch.cuda.device_count():
        raise ValueError(f"local_devices={local_devices}: on the card a "
                         f"node runs a rank a visible card "
                         f"({torch.cuda.device_count()})")
    if bootstrap_file:
        n_procs, coordinator, hostnames = _read_bootstrap(bootstrap_file)
    else:
        coordinator = f"127.0.0.1:{COORDINATOR_PORT}"
        hostnames = ["127.0.0.1"] * n_procs
    args = [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.verify",
            "--require-gang", "--steps", "2"]
    if device.type == "cpu":
        args += ["--device", "cpu", "--local-devices", str(local_devices)]
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "MEGASCALE_"))}
    base["PYTHONPATH"] = _repo_root() + os.pathsep + base.get(
        "PYTHONPATH", "")
    procs, reports = [], []
    try:
        for i in range(n_procs):
            env = {**base,
                   "TPU_COORDINATOR_ADDRESS": coordinator,
                   "TPU_PROCESS_ID": str(i),
                   "TPU_NUM_PROCESSES": str(n_procs),
                   "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
                   # A peer that dies must fail the gang within the run.
                   "TPU_INIT_TIMEOUT_S": os.environ.get(
                       "TPU_INIT_TIMEOUT_S", "120")}
            procs.append(subprocess.Popen(
                args, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for i, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"gang process {i} timed out") from None
            lines = [line for line in out.splitlines()
                     if line.startswith("{")]
            if proc.returncode != 0 or not lines:
                raise RuntimeError(f"gang process {i} failed rc="
                                   f"{proc.returncode}:\n{out}\n{err}")
            reports.append(json.loads(lines[-1]))
    finally:
        # One member failing must not leave the others waiting in the
        # rendezvous.
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    n_global = n_procs * local_devices
    want_rank_sum = float(local_devices * sum(range(1, n_procs + 1)))
    for rep in reports:
        if not (rep["globalDevices"] == n_global
                and rep["devSum"] == float(n_global)
                and rep["rankSum"] == want_rank_sum):
            raise RuntimeError(f"gang report {rep} is not of one gang of "
                               f"{n_procs} x {local_devices}")
    if len({rep["loss"] for rep in reports}) != 1:
        raise RuntimeError(f"the nodes' losses differ: {reports}")
    print(f"dryrun_multichip_multiprocess: {n_procs} procs x "
          f"{local_devices} devices, devSum={n_global}, "
          f"rankSum={want_rank_sum}, loss={reports[0]['loss']}")
    return reports


def main(argv: list[str] | None = None) -> int:
    from .train.main import LOCAL_RANK_VAR, join_gang

    p = argparse.ArgumentParser(prog="python -m " + _MODULE)
    p.add_argument("--dryrun", type=int, metavar="N", default=None,
                   help="run every parallelism family on N ranks")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for "
                        "gloo ranks on the host)")
    args = p.parse_args(argv)
    if args.dryrun is None:
        fn, example_args = entry(args.device)
        out = fn(*example_args)
        print("entry forward:", tuple(out.shape), out.dtype)
        return 0
    if args.dryrun < 1:
        p.error("--dryrun N needs N >= 1")
    if LOCAL_RANK_VAR not in os.environ:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    # A rank started by dryrun_multichip.
    import torch.distributed as dist

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.dryrun))
    join_gang(device, int(os.environ[LOCAL_RANK_VAR]), args.dryrun)
    try:
        report = dryrun_multichip(args.dryrun, device.type)
        if dist.get_rank() == 0 and REPORT_VAR in os.environ:
            with open(os.environ[REPORT_VAR], "w", encoding="utf-8") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
