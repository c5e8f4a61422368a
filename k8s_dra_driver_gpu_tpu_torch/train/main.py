"""Training launcher of the port: consumes the env contract the DRA
driver injects.

    python -m k8s_dra_driver_gpu_tpu_torch.train.main --model flagship \\
        --seq-len 4096 --batch-size 4 [--steps 10] [--tp N] \\
        [--steps-per-call K] [--pp P [--microbatches M]] \\
        [--data-file F [--data-dtype uint16]] \\
        [--checkpoint-dir D [--checkpoint-every N]] [--profile-dir P] \\
        [--device cuda] [--local-devices N]

The port of ``k8s_dra_driver_gpu_tpu/train/main.py::run``. It is started
once per node, as the reference's process is: a pod whose claim carries a
ComputeDomain channel gets

  TPU_COORDINATOR_ADDRESS / TPU_PROCESS_ID / TPU_NUM_PROCESSES
      -> one process per node (the plugin counts nodes); absent = a gang
         of this node alone;
  TPU_INIT_TIMEOUT_S -> the rendezvous timeout (default 300 s);
  DATA_FILE / DATA_DTYPE, CHECKPOINT_DIR, PROFILE_DIR -> the flags'
         defaults.

The reference's process drives every local chip; here the launcher
starts one worker per local card (``--local-devices N`` with ``--device
cpu``), re-running itself with a private local-rank variable. With L
local ranks, worker l of node p is global rank p * L + l of a world of
TPU_NUM_PROCESSES * L, on card l, in one ``torch.distributed`` gang over
TCP at the coordinator (NCCL; gloo with ``--device cpu``), whose store
global rank 0 hosts. A worker that fails makes the launcher stop its
other workers and exit non-zero.

Families. A dense run, a gang of one included, builds a (dp, fsdp, sp,
tp) mesh over the gang (``parallel.mesh.plan_for``, ``--tp`` honoured)
and trains through ``train.make_sharded_train``
(``make_scanned_sharded_train`` with ``--steps-per-call`` > 1). ``--pp
P`` trains the dense family through ``pp_train.make_pp_train`` on a (pp,
dp) mesh over the world with ``--microbatches`` M (default P) a step.
``--model moe-tiny`` trains the tiny MoE-Llama through
``models.llama_moe.make_moe_train`` on a (dp, ep) mesh sized as the
reference sizes it (``moe_mesh_shape``). The reference's refusals are
parser errors, made before any rank starts: ``--tp``, ``--steps-per-call``
> 1, ``--pp`` and ``--mu-dtype`` with moe-tiny; ``--pp`` with ``--tp`` or
``--steps-per-call`` > 1; ``--microbatches`` without ``--pp`` > 1; a
``--pp`` that does not divide the world or the layers.

Data. Every family trains from fp32 master weights from a seeded init,
in the model's compute dtype. Without ``--data-file`` a node draws its
``--batch-size`` rows of step s from ``np.random.RandomState(s * 65521 +
process_id)`` (JAX's synthetic batches); with it, its shard of the
global batch from ``data.loader.ShardedBatchIterator`` keyed by the gang
env (a token id >= the vocab exits before training). Local rank l takes
rows [l b / L, (l + 1) b / L), the order in which
``make_array_from_process_local_data`` lays a process's rows over its
devices, so the global batch is ``--batch-size`` times the node count in
the reference's row order. A pipeline step takes M such global batches
(steps s M + i), assembled alike on every rank, each rank keeping its dp
column.

Checkpoints (``--checkpoint-dir``): the latest step is restored before
training ("resumed from step N"); a step is saved on crossing each
multiple of ``--checkpoint-every`` and at the end, through
``checkpoint.TrainCheckpointer`` (a step already on disk is kept), each
save and restore logged with its bytes and seconds. ``--profile-dir``: a
``torch.profiler`` trace (host, and the card's kernels on CUDA) of the
steps after the first call through step start + 3, one file a rank.

Global rank 0 logs "step N loss X (T tok/s)" every 10 steps and at the
last, X the loss's full repr, throughput (global tokens) counted from
the end of the first (warm-up) call. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("k8s_dra_driver_gpu_tpu_torch.train")

# Set by the launcher on the workers it starts: the worker's local rank.
LOCAL_RANK_VAR = "TORCH_TRAIN_LOCAL_RANK"
# torch's switch for a coordinator another process serves: with it every
# rank, rank 0 too, joins the store at TPU_COORDINATOR_ADDRESS as a client.
AGENT_STORE_VAR = "TORCHELASTIC_USE_AGENT_STORE"


class GangEnvError(ValueError):
    """The injected ComputeDomain gang env is inconsistent.

    Raised BEFORE touching torch.distributed: every one of these
    misconfigurations would otherwise surface as a hang (a gang member
    waiting for peers that never come) or a silently wrong mesh.
    """


def validate_gang_env(env=os.environ) -> dict | None:
    """Check the injected env contract; None when not in a gang.

    Returns {"coordinator", "process_id", "num_processes"} when the
    pod carries a ComputeDomain channel. The contract (injected by the
    CD plugin):
      - TPU_COORDINATOR_ADDRESS implies TPU_PROCESS_ID and
        TPU_NUM_PROCESSES (a partial contract means a broken prepare,
        not a single-process run -- fail loudly, don't guess),
      - TPU_WORKER_HOSTNAMES, when present, is positional by process
        id, so its length must equal TPU_NUM_PROCESSES,
      - 0 <= process_id < num_processes.
    """
    coordinator = env.get("TPU_COORDINATOR_ADDRESS", "")
    if not coordinator:
        return None
    missing = [k for k in ("TPU_PROCESS_ID", "TPU_NUM_PROCESSES")
               if not env.get(k)]
    if missing:
        raise GangEnvError(
            f"TPU_COORDINATOR_ADDRESS is set but {', '.join(missing)} "
            "missing: the ComputeDomain channel env is partial (broken "
            "prepare?); refusing to guess single-process defaults")
    try:
        process_id = int(env["TPU_PROCESS_ID"])
        num_processes = int(env["TPU_NUM_PROCESSES"])
    except ValueError as e:
        raise GangEnvError(f"non-integer gang env: {e}") from e
    if not 0 <= process_id < num_processes:
        raise GangEnvError(
            f"TPU_PROCESS_ID={process_id} out of range for "
            f"TPU_NUM_PROCESSES={num_processes}")
    hostnames = env.get("TPU_WORKER_HOSTNAMES", "")
    if hostnames:
        n = len(hostnames.split(","))
        if n != num_processes:
            raise GangEnvError(
                f"TPU_WORKER_HOSTNAMES lists {n} worker(s) but "
                f"TPU_NUM_PROCESSES={num_processes}; the list is "
                "positional by process id and must match exactly")
    # rpartition: the host may be a bracketed IPv6 literal
    # ("[fd00::1]:8476") -- only the LAST colon separates the port.
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise GangEnvError(
            f"TPU_COORDINATOR_ADDRESS={coordinator!r} is not host:port")
    return {
        "coordinator": coordinator,
        "process_id": process_id,
        "num_processes": num_processes,
    }


def initialize_distributed(env=os.environ, device: str = "cuda",
                           local_rank: int = 0, local_ranks: int = 1) -> bool:
    """``torch.distributed`` from the ComputeDomain channel env, if present.

    Returns True when a gang was joined: the default process group over
    TCP at ``TPU_COORDINATOR_ADDRESS`` (an IPv6 literal keeps its
    brackets; global rank 0 hosts the store there, unless
    ``TORCHELASTIC_USE_AGENT_STORE=True`` says another process serves it,
    as ``host_store`` does), in which this
    process, local rank ``local_rank`` of the node's ``local_ranks``, is
    rank ``TPU_PROCESS_ID * local_ranks + local_rank`` of
    ``TPU_NUM_PROCESSES * local_ranks``: NCCL on card ``local_rank``, or
    gloo for ``device="cpu"``. ``TPU_INIT_TIMEOUT_S`` bounds the
    rendezvous (default 300 s), so an unreachable coordinator is a clear
    error, not an indefinite hang.
    """
    import torch.distributed as dist

    gang = validate_gang_env(env)
    if gang is None:
        return False
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    rank = gang["process_id"] * local_ranks + local_rank
    world = gang["num_processes"] * local_ranks
    timeout = int(env.get("TPU_INIT_TIMEOUT_S", "300"))
    dist.init_process_group(
        backend, init_method="tcp://" + gang["coordinator"],
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    logger.info("joined gang: process %s/%s, local rank %s/%s, rank %s/%s "
                "via %s (%s)", gang["process_id"], gang["num_processes"],
                local_rank, local_ranks, rank, world, gang["coordinator"],
                backend)
    return True


def synthetic_batch(step: int, batch_size: int, seq_len: int,
                    vocab_size: int, process_id: int = 0) -> np.ndarray:
    """Step ``step``'s tokens [batch_size, seq_len + 1], int32, of shard
    ``process_id``: the JAX launcher's draw for the same step and shard."""
    rng = np.random.RandomState(step * 65521 + process_id)
    return rng.randint(0, vocab_size,
                       (batch_size, seq_len + 1)).astype(np.int32)


def moe_mesh_shape(world: int, n_experts: int) -> tuple[int, int]:
    """(dp, ep) of the MoE trainer over ``world`` ranks, as the reference
    sizes it: ep takes as many ranks as divide both the rank count and
    the expert count, dp the rest."""
    ep = min(world, n_experts)
    while ep > 1 and (world % ep or n_experts % ep):
        ep -= 1
    return world // ep, ep


def model_config(model: str):
    """The config of a ``--model`` choice."""
    from ..models import llama, llama_moe

    return {"tiny": llama.LlamaConfig.tiny,
            "flagship": llama.LlamaConfig.flagship,
            "llama3-8b": llama.LlamaConfig.llama3_8b,
            "moe-tiny": llama_moe.LlamaMoEConfig.tiny}[model]()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torch-train")
    p.add_argument("--model", choices=["tiny", "flagship", "llama3-8b",
                                       "moe-tiny"], default="tiny")
    p.add_argument("--mu-dtype", choices=["f32", "bf16"], default=None,
                   help="Adam first-moment dtype; bf16 frees 2 bytes a "
                        "parameter (the flagship default)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8,
                   help="rows per node, split over its local ranks; the "
                        "global batch is this times TPU_NUM_PROCESSES")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel size (default: planned)")
    p.add_argument("--steps-per-call", type=int,
                   default=int(os.environ.get("STEPS_PER_CALL", "1")),
                   help="optimizer steps per call (see "
                        "train.scanned_train_step) [STEPS_PER_CALL]")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (GPipe over a (pp, dp) "
                        "mesh; the layers must divide evenly)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="microbatches a step with --pp > 1 (default: pp)")
    p.add_argument("--data-file", default=os.environ.get("DATA_FILE", ""),
                   help="flat binary token file; synthetic data when unset "
                        "[DATA_FILE]")
    p.add_argument("--data-dtype", choices=["uint16", "uint32", "int32"],
                   default=os.environ.get("DATA_DTYPE", "uint16"),
                   help="the token file's dtype (a Llama-3 vocab needs "
                        "uint32) [DATA_DTYPE]")
    p.add_argument("--checkpoint-dir",
                   default=os.environ.get("CHECKPOINT_DIR", ""),
                   help="save and resume here [CHECKPOINT_DIR]")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--profile-dir", default=os.environ.get("PROFILE_DIR", ""),
                   help="write a torch.profiler trace of the steps after "
                        "the first call through start + 3 here "
                        "[PROFILE_DIR]")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="local ranks of this node with --device cpu "
                        "(default 1); on the card, one per visible card")
    return p


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = _parser()
    args = p.parse_args(argv)
    if args.model == "flagship" and args.seq_len % 128:
        p.error("--seq-len must be a multiple of 128 for the flagship "
                "config (its chunked loss walks 128-position chunks)")
    if args.steps < 1:
        p.error("--steps must be >= 1")
    if args.steps_per_call < 1:
        p.error("--steps-per-call must be >= 1")
    if args.local_devices is not None and args.local_devices < 1:
        p.error("--local-devices must be >= 1")
    if args.checkpoint_every < 1:
        p.error("--checkpoint-every must be >= 1")
    if args.pp < 1:
        p.error("--pp must be >= 1")
    if args.pp > 1 and args.steps_per_call > 1:
        p.error("--steps-per-call composes with the auto-sharded trainer "
                "only; in pp mode the microbatch loop already amortizes "
                "dispatch (use --microbatches)")
    if args.pp > 1 and args.tp and args.tp != 1:
        p.error("--tp and --pp are mutually exclusive (the pp trainer "
                "runs over a (pp, dp) mesh)")
    if args.microbatches is not None:
        if args.pp == 1:
            p.error("--microbatches requires --pp > 1")
        if args.microbatches < 1:
            p.error("--microbatches must be >= 1")
    if args.model == "moe-tiny":
        if args.mu_dtype:
            p.error("--mu-dtype applies to the dense families only "
                    "(the MoE trainer builds its own optimizer)")
        if args.tp and args.tp != 1:
            p.error("--tp applies to the dense families only; "
                    "--model moe-tiny uses a (dp, ep) mesh")
        if args.steps_per_call > 1:
            p.error("--steps-per-call applies to the dense families "
                    "only (the MoE trainer is manual-SPMD)")
        if args.pp > 1:
            p.error("--pp applies to the dense families only")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    device, local_ranks = node_ranks(p, args.device, args.local_devices)
    if args.batch_size % local_ranks:
        p.error(f"--batch-size {args.batch_size} rows a node do not split "
                f"over its {local_ranks} local ranks")
    gang = validate_gang_env()  # a broken contract fails here, first
    nodes = gang["num_processes"] if gang else 1
    world = nodes * local_ranks
    cfg = model_config(args.model)
    if args.model == "moe-tiny":
        dp, ep = moe_mesh_shape(world, cfg.n_experts)
        if args.batch_size % dp:
            p.error(f"--batch-size {args.batch_size} must be divisible "
                    f"by dp={dp} ({world} devices / ep={ep})")
    if args.pp > 1:
        if world % args.pp:
            p.error(f"--pp {args.pp} does not divide {world} devices")
        if cfg.n_layers % args.pp:
            p.error(f"--pp {args.pp} does not divide {cfg.n_layers} layers")
        # dp = world / pp divides the global batch: each node's rows split
        # over its local ranks (checked above), so batch * nodes is
        # (batch / L) * pp * dp.
    if args.data_file:
        from ..data.loader import TokenDataset

        # An id past the vocab would index past the embedding table; the
        # file's largest id is cached beside it, so a resume rescans
        # nothing.
        file_max = TokenDataset(args.data_file, args.seq_len,
                                dtype=args.data_dtype).max_token()
        if file_max >= cfg.vocab_size:
            raise SystemExit(
                f"--data-file contains token id {file_max} >= model "
                f"vocab {cfg.vocab_size}; retokenize, fix --data-dtype, "
                "or pick the right --model")
    if local_ranks > 1 and LOCAL_RANK_VAR not in os.environ:
        return _run_local_ranks(argv, local_ranks)
    local_rank = int(os.environ.get(LOCAL_RANK_VAR, "0"))

    import torch.distributed as dist

    join_gang(device, local_rank, local_ranks)
    try:
        return _train(args, device, local_rank, local_ranks)
    finally:
        dist.destroy_process_group()


def node_ranks(parser: argparse.ArgumentParser, device: str,
               local_devices: int | None) -> tuple[torch.device, int]:
    """The device and the number of local ranks of this node: one a
    visible card, or ``--local-devices`` (default 1) with ``--device
    cpu``; any other use of ``--local-devices`` is a parser error."""
    from ..ops import resolve_device

    device = resolve_device(device)
    if device.type == "cpu":
        return device, local_devices or 1
    if local_devices is not None:
        parser.error("--local-devices is for --device cpu: on the card a "
                     "rank runs per visible card")
    return device, torch.cuda.device_count()


def join_gang(device: torch.device, local_rank: int,
              local_ranks: int) -> bool:
    """Join the gang of the ComputeDomain env (``initialize_distributed``)
    or, without one, make this process a gang of one, so that the same
    sharded path runs over a one-rank group. True when a gang was joined
    from the env."""
    import torch.distributed as dist

    if initialize_distributed(device=str(device), local_rank=local_rank,
                              local_ranks=local_ranks):
        return True
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                            store=dist.HashStore(), rank=0, world_size=1)
    return False


def host_store(timeout_s: float = 300.0):
    """A TCPStore served from this process on a port the kernel picks, and
    the env under which a gang's ranks meet there as its clients
    (``TPU_COORDINATOR_ADDRESS``, ``TORCHELASTIC_USE_AGENT_STORE``). The
    port is bound before anyone is told of it, so no other process can
    take it in between, as one could take a port found free and let go.
    The store serves while the returned object lives."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    return store, {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{store.port}",
                   AGENT_STORE_VAR: "True"}


def _run_local_ranks(argv: list[str], local_ranks: int,
                     module: str = "k8s_dra_driver_gpu_tpu_torch.train.main",
                     env: dict | None = None) -> int:
    """Start ``python -m module`` (this launcher by default) once per
    local rank, each with ``LOCAL_RANK_VAR`` set, and wait for them.
    Their env is ``env`` (default this process's). Without a gang env
    the node is a gang alone, meeting at a store this process serves
    (``host_store``). When a worker fails the others are stopped (a
    collective would wait for it forever) and its exit code is
    returned."""
    env = dict(os.environ if env is None else env)
    if validate_gang_env(env) is None:
        store, store_env = host_store(
            float(env.get("TPU_INIT_TIMEOUT_S", "300")))
        env.update(store_env, TPU_PROCESS_ID="0", TPU_NUM_PROCESSES="1")
        logger.info("%d local ranks meet at this node's store on port %d",
                    local_ranks, store.port)
    workers = [subprocess.Popen(
        [sys.executable, "-m", module, *argv],
        env={**env, LOCAL_RANK_VAR: str(rank)})
        for rank in range(local_ranks)]
    try:
        while True:
            codes = [w.poll() for w in workers]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                logger.error("a local rank exited with %s; stopping the "
                             "others", failed[0])
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()


def _train(args, device: torch.device, local_rank: int,
           local_ranks: int) -> int:
    import torch.distributed as dist

    from ..models import llama, llama_moe
    from ..parallel.mesh import (build_expert_mesh, build_mesh,
                                 build_pipeline_mesh, plan_for)
    from .pp_train import make_pp_train, pp_param_specs
    from .train import (make_optimizer, make_scanned_sharded_train,
                        make_sharded_train)

    world, rank = dist.get_world_size(), dist.get_rank()
    nodes = world // local_ranks  # TPU_NUM_PROCESSES
    node = rank // local_ranks  # TPU_PROCESS_ID
    rows = args.batch_size // local_ranks
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    cfg = model_config(args.model)
    scan_fn = scan_layout = None
    pp_m = 0  # microbatches a step in pp mode
    # How the checkpointer finds the global arrays of a manual-SPMD state.
    where = {}
    if args.model == "moe-tiny":
        dp, ep = moe_mesh_shape(world, cfg.n_experts)
        mesh = build_expert_mesh(ep, dp)
        mu = "f32"
        init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, cfg)
        state = init_fn(llama_moe.init(cfg, gen, device))
        where = dict(mesh=mesh, specs=llama_moe.param_specs(cfg),
                     per_rank_axes=("ep",))
    else:
        mu = args.mu_dtype or ("bf16" if args.model == "flagship"
                               else "f32")
        optimizer = make_optimizer(
            mu_dtype=torch.bfloat16 if mu == "bf16" else None)
        if args.pp > 1:
            mesh = build_pipeline_mesh(args.pp)
            pp_m = args.microbatches or args.pp
            init_fn, step_fn, layout, _ = make_pp_train(mesh, cfg, pp_m,
                                                        optimizer)
            where = dict(mesh=mesh, specs=pp_param_specs(cfg))
        else:
            mesh = build_mesh(plan_for(world, tp=args.tp))
            init_fn, step_fn, layout, _ = make_sharded_train(mesh, cfg,
                                                             optimizer)
            if args.steps_per_call > 1:
                _, scan_fn, scan_layout, _ = make_scanned_sharded_train(
                    mesh, cfg, optimizer)
        state = init_fn(llama.init(cfg, gen, device, dtype=torch.float32))
    logger.info("device %s, mesh %s, model %s, mu %s, batch %d x %d per "
                "node over %d local rank(s), %d rank(s)%s", device,
                dict(zip(mesh.mesh_dim_names, mesh.shape)), args.model, mu,
                args.batch_size, args.seq_len, local_ranks, world,
                f", {pp_m} microbatches a step" if pp_m else "")

    shard_batch = _shard_batches(args, cfg.vocab_size, nodes)

    def local_batch(step: int) -> np.ndarray:
        return shard_batch(step, node)[local_rank * rows:
                                       (local_rank + 1) * rows]

    def pp_batch(step: int) -> np.ndarray:
        # The global microbatches, the same on every rank (the pp batch is
        # replicated over the stages, so its copies must agree bitwise):
        # steps step * M + i of every node's shard, in shard order.
        return np.stack([np.concatenate([shard_batch(step * pp_m + i, s)
                                         for s in range(nodes)])
                         for i in range(pp_m)])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ckpt = None
    if args.checkpoint_dir:
        from .checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(args.checkpoint_dir, **where)
        latest = ckpt.latest_step()
        if latest is not None:
            t = time.perf_counter()
            state = ckpt.restore(state)
            sync()
            logger.info("resumed from step %d (%d bytes in %.3f s)",
                        state.step, ckpt.nbytes(latest),
                        time.perf_counter() - t)

    def save(step: int) -> None:
        sync()
        t = time.perf_counter()
        if ckpt.save(step, state) and rank == 0:
            logger.info("checkpoint step %d saved: %d bytes in %.3f s", step,
                        ckpt.nbytes(step), time.perf_counter() - t)

    tokens_per_step = args.batch_size * nodes * args.seq_len * (pp_m or 1)
    start = state.step
    t0, first_timed, step = time.perf_counter(), None, start
    trace, traced = None, False  # the profiler while it records; once
    k = args.steps_per_call
    while step < args.steps:
        prev = step
        if args.profile_dir and not traced and step >= start + 1:
            trace, traced = _start_trace(device), True
        # K full steps a call while they fit; the tail takes single steps
        # on the same batches in the same order.
        if pp_m:
            state, loss = step_fn(state, layout(pp_batch(step)))
            step += 1
        elif scan_fn is not None and step + k <= args.steps:
            state, losses = scan_fn(state, scan_layout(np.stack(
                [local_batch(step + i) for i in range(k)])))
            loss = losses[-1]
            step += k
        else:
            state, loss = step_fn(state, layout(local_batch(step)))
            step += 1
        if trace is not None and step >= start + 3:
            _stop_trace(trace, args.profile_dir, rank, sync)
            trace = None
        if first_timed is None:
            sync()  # the first call warms caches and builds kernels
            t0, first_timed = time.perf_counter(), step
        if rank == 0 and (prev // 10 != step // 10 or step == args.steps):
            value = loss.item()
            dt = time.perf_counter() - t0
            done = step - first_timed
            tps = tokens_per_step * done / dt if dt > 0 and done > 0 else 0.0
            logger.info("step %d loss %r (%.0f tok/s)", step, value, tps)
        if ckpt and (prev // args.checkpoint_every
                     != step // args.checkpoint_every):
            save(step)
    if trace is not None:  # a short run: close the trace before exit
        _stop_trace(trace, args.profile_dir, rank, sync)
    if ckpt:
        save(state.step)
        ckpt.close()
    return 0


def _shard_batches(args, vocab_size: int, nodes: int):
    """``shard_batch(step, shard)``: node ``shard``'s [batch_size, S + 1]
    int32 rows of step ``step``, from the token file or synthetic."""
    if not args.data_file:
        return lambda step, shard: synthetic_batch(
            step, args.batch_size, args.seq_len, vocab_size, shard)
    from ..data.loader import ShardedBatchIterator, TokenDataset

    ds = TokenDataset(args.data_file, args.seq_len, dtype=args.data_dtype)
    # One iterator a shard, made once: batch(step) is pure, so every rank
    # builds the same rows of any shard.
    shards = {}

    def shard_batch(step: int, shard: int) -> np.ndarray:
        if shard not in shards:
            shards[shard] = ShardedBatchIterator(
                ds, global_batch=args.batch_size * nodes, num_shards=nodes,
                shard_id=shard)
        return shards[shard].batch(step)

    return shard_batch


def _start_trace(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace = profile(activities=activities)
    trace.start()
    return trace


def _stop_trace(trace, directory: str, rank: int, sync) -> None:
    """Stop ``trace`` once the device is done and write this rank's
    Chrome trace into ``directory``."""
    sync()
    trace.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_rank{rank}.json")
    trace.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)


if __name__ == "__main__":
    import sys

    sys.exit(run())
