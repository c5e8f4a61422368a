"""The port's gang launcher: its copy of ``validate_gang_env`` against the
reference's, and ``python -m k8s_dra_driver_gpu_tpu_torch.train.main``
as a 2-process gloo gang (``--tp 2``, with and without
``--steps-per-call 2``) against the port's single-process ``train_step``
on the concatenated shard batches; 2 nodes of 2 local ranks each
(``--local-devices 2``) against that gang; one node of 2 local ranks
with ``--tp 2`` against ``train_step`` on the node's batch; ``--model
moe-tiny`` on 2 nodes of 2 local ranks against ``make_moe_train`` on the
same sizing and batches (a 4-rank gang of ``tests/torch_gang.py``); one
node of 4 local ranks on ``plan_for(4)`` (tp=4 over the tiny model's 2
kv heads) against JAX's ``make_sharded_train`` on the same mesh shape,
init and batches; plus the env and parser failures, and the MoE sizing
and refusals."""

import math
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.train import main as jax_main
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.train import main as pt_main
from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train
from tests import torch_gang

REPO = str(Path(__file__).resolve().parents[1])
STEPS, BATCH, SEQ, WORLD = 3, 2, 16, 2
# One node of 4 local ranks: a row each.
BATCH_1X4 = 4
GANG_VARS = ("TPU_COORDINATOR_ADDRESS", "TPU_PROCESS_ID", "TPU_NUM_PROCESSES",
             "TPU_WORKER_HOSTNAMES", "TPU_INIT_TIMEOUT_S", "STEPS_PER_CALL")

ENVS = [
    {},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476", "TPU_PROCESS_ID": "1",
     "TPU_NUM_PROCESSES": "2", "TPU_WORKER_HOSTNAMES": "10.0.0.1,10.0.0.2"},
    {"TPU_COORDINATOR_ADDRESS": "[fd00::1]:8476", "TPU_PROCESS_ID": "0",
     "TPU_NUM_PROCESSES": "2"},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476"},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476", "TPU_PROCESS_ID": "0"},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476", "TPU_PROCESS_ID": "0",
     "TPU_NUM_PROCESSES": "3", "TPU_WORKER_HOSTNAMES": "a,b"},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476", "TPU_PROCESS_ID": "2",
     "TPU_NUM_PROCESSES": "2"},
    {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476", "TPU_PROCESS_ID": "zero",
     "TPU_NUM_PROCESSES": "2"},
    {"TPU_COORDINATOR_ADDRESS": "no-port-here", "TPU_PROCESS_ID": "0",
     "TPU_NUM_PROCESSES": "2"},
]


def _outcome(fn, env):
    try:
        return "ok", fn(env=env)
    except ValueError as err:
        return type(err).__name__, str(err)


@pytest.mark.parametrize("env", ENVS)
def test_validate_gang_env_matches_reference(env):
    got = _outcome(pt_main.validate_gang_env, env)
    assert got == _outcome(jax_main.validate_gang_env, env)
    if got[0] != "ok":
        assert got[0] == "GangEnvError"
        assert issubclass(pt_main.GangEnvError, ValueError)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in GANG_VARS}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(*extra):
    return [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
            "--device", "cpu", "--model", "tiny", "--steps", str(STEPS),
            "--tp", "2", "--batch-size", str(BATCH), "--seq-len", str(SEQ),
            *extra]


def _tiny_args(batch, *extra):
    """The dense launcher on ``plan_for``'s mesh (no ``--tp``)."""
    return [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
            "--device", "cpu", "--model", "tiny", "--steps", str(STEPS),
            "--batch-size", str(batch), "--seq-len", str(SEQ), *extra]


def _moe_args(*extra):
    return [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
            "--device", "cpu", "--model", "moe-tiny", "--steps", str(STEPS),
            "--batch-size", str(BATCH), "--seq-len", str(SEQ), *extra]


def _launch(*extra, argv=None):
    """Starts one 2-node gang of the launcher (one process a node), with
    ``argv`` or the dense ``_args(*extra)``; returns its processes, node
    0's first."""
    port = _free_port()
    return [subprocess.Popen(
        argv or _args(*extra),
        env=_env(TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 TPU_PROCESS_ID=str(rank), TPU_NUM_PROCESSES=str(WORLD),
                 TPU_INIT_TIMEOUT_S="60"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]


@pytest.fixture(scope="module")
def gangs():
    """Every gang at once; returns {gang: [node logs]}: 1 and 2 (steps
    per call) are 2 nodes of one rank, "2x2" 2 nodes of 2 local ranks,
    "1x2" one node (no gang env) of 2 local ranks, "1x4" one node of 4
    local ranks on the default mesh, "moe" ``--model moe-tiny`` on 2
    nodes of 2 local ranks."""
    running = {k: _launch("--steps-per-call", str(k)) for k in (1, 2)}
    running["2x2"] = _launch("--local-devices", "2")
    running["moe"] = _launch(argv=_moe_args("--local-devices", "2"))
    running["1x2"] = [subprocess.Popen(
        _args("--local-devices", "2"), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    running["1x4"] = [subprocess.Popen(
        _tiny_args(BATCH_1X4, "--local-devices", "4"), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    logs = {}
    try:
        for k, procs in running.items():
            logs[k] = [proc.communicate(timeout=240)[0] for proc in procs]
            for proc, log in zip(procs, logs[k]):
                assert proc.returncode == 0, log[-3000:]
    finally:
        for procs in running.values():
            for proc in procs:
                proc.kill()
    return logs


def _single_process_loss(nodes: int) -> float:
    """The last of ``STEPS`` losses of the single-process ``train_step``
    on the same init and the concatenated batches of ``nodes`` nodes."""
    cfg = pt_llama.LlamaConfig.tiny()
    opt = pt_train.make_optimizer()
    params = pt_llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = pt_train.TrainState(params, opt.init(params), 0)
    for step in range(STEPS):
        batch = np.concatenate([
            pt_main.synthetic_batch(step, BATCH, SEQ, cfg.vocab_size, shard)
            for shard in range(nodes)])
        state, loss = pt_train.train_step(state, torch.from_numpy(batch),
                                          cfg=cfg, optimizer=opt)
    return loss.item()


@pytest.fixture(scope="module")
def single_process_loss():
    return _single_process_loss(WORLD)


def _steps(log):
    return re.findall(r"step (\d+) loss (\S+) \((\d+) tok/s\)", log)


def _assert_near(loss, want):
    # The tiny config computes in bf16, and tp=2 splits the depth of wo
    # and w_down: their partial products are rounded to bf16 before the
    # sum across ranks, a few bf16 ulps (2^-8) of the loss apart from one
    # device's.
    assert math.isfinite(loss)
    assert abs(loss - want) <= 2e-3 * want, (loss, want)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_gang_logs_the_single_process_loss(gangs, single_process_loss,
                                           steps_per_call):
    for node, log in enumerate(gangs[steps_per_call]):
        assert "joined gang: process" in log and "'tp': 2" in log, log
        if node:  # only global rank 0 logs the steps
            assert not _steps(log), log
            continue
        lines = _steps(log)
        assert lines[-1][0] == str(STEPS), log
        _assert_near(float(lines[-1][1]), single_process_loss)


def test_steps_per_call_logs_the_same_loss(gangs):
    # K steps a call run the same steps on the same batches in order.
    assert _steps(gangs[1][0])[-1][:2] == _steps(gangs[2][0])[-1][:2]


def test_nodes_of_local_ranks_log_the_two_process_losses(gangs):
    # 2 nodes x 2 local ranks: world 4, each node's rows split over its
    # ranks; the global batch is the 2-process gang's, so are the losses.
    logs = gangs["2x2"]
    for node, log in enumerate(logs):
        for local in (0, 1):
            rank = 2 * node + local
            assert (f"process {node}/2, local rank {local}/2, rank "
                    f"{rank}/4") in log, log
    assert "'dp': 2" in logs[0] and "'tp': 2" in logs[0], logs[0]
    assert not _steps(logs[1]), logs[1]
    got, want = _steps(logs[0])[-1], _steps(gangs[1][0])[-1]
    assert got[0] == want[0] == str(STEPS)
    _assert_near(float(got[1]), float(want[1]))
    # Throughput counts the global batch: 2 nodes' rows.
    assert "batch 2 x 16 per node over 2 local rank(s), 4 rank(s)" in logs[0]


def test_one_node_of_local_ranks_with_tp_logs_its_batch_loss(gangs):
    # No gang env: the node alone, its 2 local ranks on one tp=2 mesh,
    # training on the node's rows: train_step's losses on that batch.
    (log,) = gangs["1x2"]
    assert "local rank 1/2, rank 1/2" in log and "'tp': 2" in log, log
    lines = _steps(log)
    assert len(lines) == 1 and lines[0][0] == str(STEPS), log
    _assert_near(float(lines[0][1]), _single_process_loss(1))


@pytest.fixture(scope="module")
def jax_tp4_loss():
    """The last of ``STEPS`` losses of JAX's ``make_sharded_train`` at
    ``plan_for(4)`` (tp=4) on 4 CPU devices, from the launcher's init (the
    port's draw, carried over) and one node's synthetic batches."""
    import jax

    from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
    from k8s_dra_driver_gpu_tpu.parallel import mesh as jax_mesh
    from k8s_dra_driver_gpu_tpu.train import train as jax_train

    cfg = pt_llama.LlamaConfig.tiny()
    params = pt_train.tree_map(
        lambda t: t.numpy(),
        pt_llama.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    mesh = jax_mesh.build_mesh(jax_mesh.plan_for(4),
                               devices=jax.devices()[:4])
    assert dict(mesh.shape)["tp"] == 4
    init_fn, step_fn, batch_shard, place = jax_train.make_sharded_train(
        mesh, jax_llama.LlamaConfig.tiny())
    state = init_fn(place(params))
    for step in range(STEPS):
        state, loss = step_fn(state, jax.device_put(pt_main.synthetic_batch(
            step, BATCH_1X4, SEQ, cfg.vocab_size, 0), batch_shard))
    return float(loss)


def test_one_node_of_four_local_ranks_logs_jax_sharded_loss(gangs,
                                                            jax_tp4_loss):
    # plan_for(4) is tp=4, over the tiny model's 2 kv heads; JAX's
    # launcher runs that mesh, and so does the port's.
    (log,) = gangs["1x4"]
    assert "mesh {'dp': 1, 'fsdp': 1, 'sp': 1, 'tp': 4}" in log, log
    assert "local rank 3/4, rank 3/4" in log, log
    lines = _steps(log)
    assert len(lines) == 1 and lines[0][0] == str(STEPS), log
    _assert_near(float(lines[0][1]), jax_tp4_loss)


@pytest.mark.parametrize("batch,local", [(3, 2), (2, 4), (6, 4)])
def test_batch_indivisible_by_local_ranks_is_a_parser_error(batch, local):
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
         "--device", "cpu", "--batch-size", str(batch), "--local-devices",
         str(local)], env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2, proc.stderr
    assert (f"--batch-size {batch} rows a node do not split over its {local} "
            "local ranks") in proc.stderr


def test_unreachable_coordinator_fails_within_timeout():
    # Process 1 connects to a port nothing listens on; the rendezvous
    # must give up after TPU_INIT_TIMEOUT_S, not hang for 300 s.
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
         "--device", "cpu", "--steps", "1"],
        env=_env(TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                 TPU_PROCESS_ID="1", TPU_NUM_PROCESSES="2",
                 TPU_INIT_TIMEOUT_S="5"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 120
    out = (proc.stdout + proc.stderr).lower()
    assert "timed out" in out or "timeout" in out, out[-2000:]


def test_partial_env_fails_fast():
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
         "--device", "cpu", "--steps", "1"],
        env=_env(TPU_COORDINATOR_ADDRESS="127.0.0.1:8476"),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "GangEnvError" in proc.stderr
    assert "TPU_PROCESS_ID, TPU_NUM_PROCESSES missing" in proc.stderr


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """``make_moe_train``'s losses on the launcher's sizing, init and
    batches for 2 nodes of 2 local ranks, from a 4-rank gang of the
    ``moe_launcher`` worker."""
    out = tmp_path_factory.mktemp("moe_launcher")
    np.savez(out / "launch.npz", steps=STEPS, batch=BATCH, seq=SEQ,
             local_ranks=2)
    torch_gang.run_gang("moe_launcher", 4, out)
    return torch.load(out / "rank0.pt", weights_only=False)


def test_moe_tiny_logs_the_losses_of_make_moe_train(gangs, moe_reference):
    # World 4 and 4 experts: ep = 4, dp = 1.
    logs = gangs["moe"]
    assert moe_reference["mesh"] == (1, 4)
    assert "mesh {'dp': 1, 'ep': 4}, model moe-tiny, mu f32" in logs[0], \
        logs[0]
    assert "local rank 1/2, rank 3/4" in logs[1], logs[1]
    assert not _steps(logs[1]), logs[1]
    lines = _steps(logs[0])
    assert lines[-1][0] == str(STEPS), logs[0]
    loss = float(lines[-1][1])
    assert math.isfinite(loss)
    # The log prints 4 decimals of the same computation.
    assert abs(loss - moe_reference["losses"][-1]) <= 5e-5, (
        loss, moe_reference["losses"])


@pytest.mark.parametrize("world,experts,want", [
    (1, 4, (1, 1)), (2, 4, (1, 2)), (3, 4, (3, 1)), (4, 4, (1, 4)),
    (6, 4, (3, 2)), (8, 4, (2, 4)), (12, 4, (3, 4)), (16, 8, (2, 8)),
    (6, 8, (3, 2)), (5, 8, (5, 1))])
def test_moe_mesh_shape_sizes_as_the_reference(world, experts, want):
    # ep: the most ranks, up to the expert count, that divide both.
    assert pt_main.moe_mesh_shape(world, experts) == want


@pytest.mark.parametrize("extra,message", [
    (["--tp", "2"], "--tp applies to the dense families only"),
    (["--steps-per-call", "2"], "--steps-per-call applies to the dense "
     "families only"),
    (["--mu-dtype", "bf16"], "--mu-dtype applies to the dense families "
     "only"),
    (["--batch-size", "2"], "--batch-size 2 must be divisible by dp=3 "
     "(3 devices / ep=1)"),
])
def test_moe_tiny_refusals_are_parser_errors(extra, message, monkeypatch,
                                             capsys):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)
    # Three nodes of one rank: 3 ranks over 4 experts give ep=1, dp=3.
    monkeypatch.setenv("TPU_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("TPU_PROCESS_ID", "0")
    monkeypatch.setenv("TPU_NUM_PROCESSES", "3")
    with pytest.raises(SystemExit) as exit_info:
        pt_main.run(["--device", "cpu", "--model", "moe-tiny", "--batch-size",
                     "3", *extra])
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err
