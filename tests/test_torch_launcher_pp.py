"""The port's launcher beyond its dense and MoE paths, and its gang
verifier, as subprocesses on gloo:

- ``--pp 2 --microbatches 2`` on 2 nodes of 2 local ranks against
  ``make_pp_train`` in a 4-rank gang of ``tests/torch_gang.py`` on the
  same global microbatches, and the pp refusals as parser errors;
- ``--data-file`` on 2 nodes against the single-process ``train_step``
  on the loader's concatenated shard batches, and an out-of-vocab file;
- ``--checkpoint-dir`` with ``--steps 2`` then ``--steps 4`` against an
  uninterrupted ``--steps 4`` (one node of 2 local ranks), and the
  ``--profile-dir`` trace of the first run;
- ``python -m k8s_dra_driver_gpu_tpu_torch.train.verify --require-gang``
  on 2 nodes of 2 local ranks, on 2 nodes of one with
  ``TPU_NUM_SLICES=2``, and its refusals.
"""

import inspect
import json
import math
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.train import main as jax_main
from k8s_dra_driver_gpu_tpu.train import verify as jax_verify
from k8s_dra_driver_gpu_tpu_torch.data import loader
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.train import main as pt_main
from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train
from k8s_dra_driver_gpu_tpu_torch.train import verify as pt_verify
from tests import torch_gang
from tests.test_torch_launcher import GANG_VARS, _assert_near, _env, _steps

STEPS, BATCH, SEQ, NODES = 3, 2, 16, 2
PP, MICROBATCHES = 2, 2
VERIFY_KEYS = {"processId", "numProcesses", "globalDevices", "localDevices",
               "devSum", "rankSum", "steps", "loss", "gang", "numSlices",
               "sliceId", "mesh", "env"}


def _main(*args):
    return [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.main",
            "--device", "cpu", "--model", "tiny", "--seq-len", str(SEQ),
            *args]


def _verify(*args):
    return [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.train.verify",
            "--device", "cpu", *args]


def _ports(n: int) -> list[int]:
    """n free ports, distinct: all held at once while they are picked."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _nodes(argv, port: int, nodes: int = NODES, **extra):
    """One gang of ``nodes`` launcher processes (one a node) meeting at
    ``port``."""
    return [subprocess.Popen(
        argv, env=_env(TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       TPU_PROCESS_ID=str(node), TPU_NUM_PROCESSES=str(nodes),
                       TPU_INIT_TIMEOUT_S="60", **extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for node in range(nodes)]


def _wait(procs, timeout=240):
    logs = [proc.communicate(timeout=timeout)[0] for proc in procs]
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    return logs


@pytest.fixture(scope="module")
def tokens_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    loader.write_token_file(str(path), np.random.RandomState(6).randint(
        0, pt_llama.LlamaConfig.tiny().vocab_size, 64 * SEQ + 1))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tokens_file):
    """Every run, in two waves of about 14 processes (the resumed run
    after the run it resumes); returns {run: [node logs]} and the
    checkpoint and trace dirs."""
    work = tmp_path_factory.mktemp("launcher_pp")
    ckpt, trace = work / "ckpt", work / "trace"
    # The runs of one node of 2 local ranks get a one-node gang env too,
    # so that every port is picked here, distinct.
    ports = iter(_ports(7))
    waves = [
        {"pp": lambda: _nodes(_main(
            "--steps", str(STEPS), "--batch-size", str(BATCH), "--pp",
            str(PP), "--microbatches", str(MICROBATCHES), "--local-devices",
            "2"), next(ports)),
         "data": lambda: _nodes(_main(
             "--steps", str(STEPS), "--batch-size", str(BATCH), "--data-file",
             tokens_file), next(ports)),
         "first": lambda: _nodes(_main(
             "--steps", "2", "--batch-size", "2", "--tp", "2",
             "--local-devices", "2", "--checkpoint-dir", str(ckpt),
             "--profile-dir", str(trace)), next(ports), nodes=1),
         "whole": lambda: _nodes(_main(
             "--steps", "4", "--batch-size", "2", "--tp", "2",
             "--local-devices", "2"), next(ports), nodes=1)},
        {"resumed": lambda: _nodes(_main(
            "--steps", "4", "--batch-size", "2", "--tp", "2",
            "--local-devices", "2", "--checkpoint-dir", str(ckpt)),
            next(ports), nodes=1),
         "verify": lambda: _nodes(_verify(
             "--require-gang", "--local-devices", "2"), next(ports)),
         "slices": lambda: _nodes(_verify("--require-gang"), next(ports),
                                  TPU_NUM_SLICES="2")},
    ]
    logs, running = {}, {}
    try:
        for wave in waves:
            running = {name: start() for name, start in wave.items()}
            logs.update({name: _wait(procs)
                         for name, procs in running.items()})
    finally:
        for procs in running.values():
            for proc in procs:
                proc.kill()
    return logs, ckpt, trace


@pytest.fixture(scope="module")
def pp_reference(tmp_path_factory):
    """``make_pp_train``'s losses on the launcher's mesh, init and global
    microbatches, from a 4-rank gang of the ``pp_launcher`` worker."""
    out = tmp_path_factory.mktemp("pp_launcher")
    np.savez(out / "launch.npz", steps=STEPS, batch=BATCH, seq=SEQ,
             nodes=NODES, pp=PP, microbatches=MICROBATCHES)
    torch_gang.run_gang("pp_launcher", 4, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)["losses"]
            for r in range(4)]


def test_pp_logs_the_losses_of_make_pp_train(runs, pp_reference):
    logs = runs[0]["pp"]
    assert ("mesh {'pp': 2, 'dp': 2}, model tiny, mu f32, batch 2 x 16 per "
            "node over 2 local rank(s), 4 rank(s), 2 microbatches a step"
            ) in logs[0], logs[0]
    assert "local rank 1/2, rank 3/4" in logs[1], logs[1]
    assert not _steps(logs[1]), logs[1]
    # Every rank of the gang reports the whole batch's loss.
    assert all(losses == pp_reference[0] for losses in pp_reference)
    (line,) = _steps(logs[0])
    assert line[0] == str(STEPS)
    # The same computation on the same batches: the logged repr is the
    # loss's, bit for bit.
    assert float(line[1]) == pp_reference[0][-1], (line, pp_reference)


REFUSALS = [
    (["--pp", "0"], "--pp must be >= 1", True),
    (["--pp", "2", "--steps-per-call", "2"], "--steps-per-call composes "
     "with the auto-sharded trainer only", True),
    (["--pp", "2", "--tp", "2"], "--tp and --pp are mutually exclusive (the "
     "pp trainer runs over a (pp, dp) mesh)", True),
    (["--microbatches", "2"], "--microbatches requires --pp > 1", True),
    (["--pp", "2", "--microbatches", "0"], "--microbatches must be >= 1",
     True),
    (["--pp", "2", "--model", "moe-tiny"], "--pp applies to the dense "
     "families only", True),
    (["--pp", "2", "--local-devices", "3", "--batch-size", "3"],
     "--pp 2 does not divide 3 devices", False),
    (["--pp", "4", "--local-devices", "4", "--batch-size", "4"],
     "--pp 4 does not divide 2 layers", False),
    (["--checkpoint-every", "0"], "--checkpoint-every must be >= 1", False),
]


@pytest.mark.parametrize("extra,message,reference", REFUSALS,
                         ids=[" ".join(r[0]) for r in REFUSALS])
def test_refusals_are_parser_errors(extra, message, reference, monkeypatch,
                                    capsys):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exit_info:
        pt_main.run(["--device", "cpu", *extra])
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err
    if reference:
        # The reference's own words (its message splits across lines).
        words = re.sub(r'"\s+"', "", inspect.getsource(jax_main.run))
        assert message in words


def test_data_file_logs_train_step_on_the_loaders_batches(runs, tokens_file):
    logs = runs[0]["data"]
    assert "'tp': 2" in logs[0], logs[0]
    (line,) = _steps(logs[0])
    assert line[0] == str(STEPS)
    cfg = pt_llama.LlamaConfig.tiny()
    opt = pt_train.make_optimizer()
    params = pt_llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = pt_train.TrainState(params, opt.init(params), 0)
    ds = loader.TokenDataset(tokens_file, SEQ)
    shards = [loader.ShardedBatchIterator(ds, BATCH * NODES, NODES, s)
              for s in range(NODES)]
    for step in range(STEPS):
        batch = np.concatenate([it.batch(step) for it in shards])
        state, loss = pt_train.train_step(state, torch.from_numpy(batch),
                                          cfg=cfg, optimizer=opt)
    _assert_near(float(line[1]), loss.item())


def test_out_of_vocab_data_file_exits(tmp_path, monkeypatch):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)
    path = str(tmp_path / "big.bin")
    loader.write_token_file(path, np.arange(300).repeat(4))
    with pytest.raises(SystemExit) as exit_info:
        pt_main.run(["--device", "cpu", "--seq-len", str(SEQ),
                     "--data-file", path])
    assert str(exit_info.value) == (
        "--data-file contains token id 299 >= model vocab 256; retokenize, "
        "fix --data-dtype, or pick the right --model")


def test_resume_logs_the_uninterrupted_loss(runs):
    logs, ckpt, _ = runs
    (first,) = logs["first"]
    assert "checkpoint step 2 saved: " in first, first
    (resumed,) = logs["resumed"]
    assert "resumed from step 2 (" in resumed, resumed
    assert "checkpoint step 4 saved: " in resumed, resumed
    got, want = _steps(resumed)[-1], _steps(logs["whole"][0])[-1]
    assert got[0] == want[0] == "4"
    assert got[1] == want[1]  # the full repr: bit for bit
    assert sorted(p.name for p in ckpt.iterdir()) == ["2", "4"]


def test_profile_dir_holds_a_trace_a_rank(runs):
    logs, _, trace = runs
    assert sorted(p.name for p in trace.iterdir()) == [
        "trace_rank0.json", "trace_rank1.json"]
    for path in trace.iterdir():
        events = json.loads(path.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "profile trace written to" in logs["first"][0]


# run: (local ranks a node, mesh, devSum, rankSum); the rank sums are
# (node id + 1) over every rank: 2 x 1 + 2 x 2, or 1 + 2.
VERIFY_RUNS = {
    "verify": (2, {"dp": 2, "fsdp": 1, "sp": 1, "tp": 2}, 4.0, 6.0),
    "slices": (1, {"dcn": 2, "dp": 1, "fsdp": 1, "sp": 1, "tp": 1}, 2.0, 3.0),
}


@pytest.mark.parametrize("run", VERIFY_RUNS)
def test_verify_prints_one_line_a_node_with_the_gangs_proofs(runs, run):
    local, mesh, dev_sum, rank_sum = VERIFY_RUNS[run]
    docs = []
    for node, log in enumerate(runs[0][run]):
        lines = [line for line in log.splitlines() if line.startswith("{")]
        assert len(lines) == 1, log  # local rank 0 prints, rank 1 does not
        doc = json.loads(lines[0])
        assert set(doc) == VERIFY_KEYS
        assert doc["processId"] == node and doc["numProcesses"] == NODES
        assert doc["globalDevices"] == NODES * local
        assert doc["localDevices"] == local
        assert doc["devSum"] == dev_sum  # every rank
        assert doc["rankSum"] == rank_sum  # every node
        assert doc["steps"] == 1 and doc["gang"] is True
        assert doc["mesh"] == mesh
        assert doc["numSlices"] == (2 if run == "slices" else 1)
        assert math.isfinite(float(doc["loss"]))
        docs.append(doc)
    # One global computation: the nodes agree bit for bit.
    assert docs[0]["loss"] == docs[1]["loss"]


def test_verify_keys_are_the_references():
    source = inspect.getsource(jax_verify.run)
    assert all(f'"{key}"' in source for key in VERIFY_KEYS)


def test_verify_require_gang_without_env_exits_2(monkeypatch, capsys):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)
    assert pt_verify.run(["--device", "cpu", "--require-gang"]) == 2
    assert ("verify: no ComputeDomain channel env (TPU_COORDINATOR_ADDRESS "
            "unset) but --require-gang") in capsys.readouterr().err


def test_verify_refuses_a_slice_count_that_does_not_divide_the_gang():
    proc = subprocess.run(_verify(), env=_env(TPU_NUM_SLICES="3"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "TPU_NUM_SLICES=3 does not divide 1 global devices" in proc.stderr


@pytest.mark.parametrize("extra,message", [
    (["--steps", "0"], "--steps must be >= 1"),
    (["--batch-per-process", "3", "--local-devices", "2"],
     "--batch-per-process 3 rows do not split over 2 local ranks"),
])
def test_verify_parser_refusals(extra, message, monkeypatch, capsys):
    for var in GANG_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exit_info:
        pt_verify.run(["--device", "cpu", *extra])
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err
