"""The port's entry (``k8s_dra_driver_gpu_tpu_torch/entry.py``) against the
reference's ``__graft_entry__.py`` and against the plain single-process
paths.

- ``entry(device="cpu")`` on the JAX entry's parameters, carried over
  through ``convert.params_from_jax``: the tiny bf16 forward against
  JAX's.
- ``dryrun_multichip(4, device="cpu")``, one self-launched gang of 4 gloo
  ranks: every family runs, and each loss equals the plain loss of the
  same parameters and batch, rebuilt here from the family's seeds.
- ``dryrun_multichip_multiprocess`` from a bootstrap.json and members.json
  written by the ComputeDomain daemon's own code: 2 node processes of 2
  gloo ranks each, held to the reference's checks.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.computedomain import JAX_COORDINATOR_PORT
from k8s_dra_driver_gpu_tpu.computedomain import \
    daemon_dns_name as jax_daemon_dns_name
from k8s_dra_driver_gpu_tpu.computedomain.daemon.dnsnames import \
    dns_name_mappings as jax_dns_name_mappings
from k8s_dra_driver_gpu_tpu_torch import entry as pt_entry
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.models import llama_moe as pt_moe
from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N = 4
# The entry forward, bf16 on both sides: the logits of two bf16
# computations that round their activations at different points (JAX's
# XLA fusions against PyTorch's ops). The logits reach ~3.3, where a bf16
# ulp is 1.6e-2; the measured worst gap is 3.1e-2.
FORWARD_ATOL = 4e-2
# A family's sharded step-1 loss against the plain loss of the same
# parameters and batch, both bf16 compute with fp32 losses of ~6: the
# collectives sum the bf16 partial products in another order. The
# measured gaps are at most 2.9e-3 (the scan's step 2).
LOSS_ATOL = 5e-3


def test_entry_forward_matches_the_reference_entry():
    sys.path.insert(0, str(ROOT))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.pop(0)
    jax_fn, (jax_params, jax_tokens) = graft.entry()
    want = np.asarray(jax.jit(jax_fn)(jax_params, jax_tokens))
    fn, (params, tokens) = pt_entry.entry(device="cpu")
    assert torch.equal(tokens, torch.zeros(2, 32, dtype=torch.int32))
    carried = params_from_jax(jax_params)
    assert {k: v.shape for k, v in carried["layers"].items()} == {
        k: v.shape for k, v in params["layers"].items()}
    got = fn(carried, tokens)
    assert got.shape == want.shape == (2, 32, 256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_ATOL, rtol=0)


def test_entry_cli_prints_the_forward():
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.entry",
         "--device", "cpu"], cwd=ROOT, env={**os.environ,
                                            "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=120, check=True)
    assert proc.stdout.strip() == "entry forward: (2, 32, 256) torch.float32"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    for call in (pt_entry.entry, lambda: pt_entry.dryrun_multichip(N),
                 pt_entry.dryrun_multichip_multiprocess):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_daemon_contract_copies_equal_the_driver_sides():
    members = [{"index": 1, "ipAddress": "10.0.0.2"},
               {"index": 0, "ipAddress": "10.0.0.1"},
               {"index": 2, "ipAddress": ""}, {"ipAddress": "10.0.0.9"}]
    assert pt_entry.dns_name_mappings(members) == \
        jax_dns_name_mappings(members)
    for index in (0, 7, 1234):
        assert pt_entry.daemon_dns_name(index) == jax_daemon_dns_name(index)
    assert pt_entry.COORDINATOR_PORT == JAX_COORDINATOR_PORT


# ---------------------------------------------------------------------------
# dryrun_multichip: one self-launched gang of 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun():
    return pt_entry.dryrun_multichip(N, device="cpu")


def _params(cfg, family, init=pt_llama.init):
    return pt_entry.draw_params(cfg, pt_entry.FAMILY_SEEDS[family][0], CPU,
                                init)


def _tokens(report, family, vocab):
    return pt_entry.draw_tokens(pt_entry.FAMILY_SEEDS[family][1],
                                report["batch"], vocab, CPU)


def _plain_loss(family, report):
    """The plain single-process loss of a family's parameters and batch."""
    cfg = pt_llama.LlamaConfig.tiny()
    if family == "ep":
        mcfg = pt_moe.LlamaMoEConfig.tiny()
        return pt_moe.loss_fn(_params(mcfg, "ep", pt_moe.init),
                              _tokens(report, "ep", mcfg.vocab_size), mcfg)
    if family == "pp":
        # A stage a layer; the loss is the microbatches' mean.
        pcfg = dataclasses.replace(cfg, n_layers=report["batch"][0])
        params = _params(pcfg, "pp")
        return torch.stack([pt_train.loss_fn(params, mb, pcfg) for mb in
                            _tokens(report, "pp", cfg.vocab_size)]).mean()
    key = "sp" if family.startswith("sp:") else family
    return pt_train.loss_fn(_params(cfg, key),
                            _tokens(report, key, cfg.vocab_size), cfg)


def test_dryrun_runs_every_family(dryrun):
    assert list(dryrun) == ["train", "scan", "sp:ring", "sp:ulysses", "ep",
                            "pp", "multislice", "serve"]
    assert not [key for key, rep in dryrun.items() if "skipped" in rep]
    assert dryrun["train"]["mesh"] == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 4}
    assert dryrun["sp:ring"]["mesh"] == "dp1xsp4"
    assert dryrun["sp:ulysses"]["mesh"] == "dp2xsp2"
    assert dryrun["ep"]["mesh"] == "dp1xep4"
    assert dryrun["pp"]["mesh"] == "pp4xdp1"
    assert dryrun["multislice"]["mesh"] == {"dcn": 2, "dp": 1, "fsdp": 1,
                                            "sp": 1, "tp": 2}
    assert dryrun["serve"]["mesh"] == {"dp": 2, "fsdp": 1, "sp": 1, "tp": 2}
    for key, rep in dryrun.items():
        assert rep["seconds"] > 0
        if key != "serve":
            assert rep["step"] == (3 if key == "scan" else 1)


@pytest.mark.parametrize("family", ["train", "sp:ring", "sp:ulysses", "ep",
                                    "pp", "multislice"])
def test_dryrun_loss_equals_the_plain_loss(dryrun, family):
    want = _plain_loss(family, dryrun[family]).item()
    assert abs(dryrun[family]["loss"] - want) <= LOSS_ATOL, (
        dryrun[family]["loss"], want)


def test_dryrun_scan_continues_from_the_first_step(dryrun):
    # Steps 2 and 3 of the plain train_step after step 1, on the scanned
    # call's batches.
    cfg = pt_llama.LlamaConfig.tiny()
    optimizer = pt_train.make_optimizer()
    params = _params(cfg, "train")
    state = pt_train.TrainState(params, optimizer.init(params), 0)
    state, _ = pt_train.train_step(
        state, _tokens(dryrun["train"], "train", cfg.vocab_size), cfg=cfg,
        optimizer=optimizer)
    want = []
    for batch in _tokens(dryrun["scan"], "scan", cfg.vocab_size):
        state, loss = pt_train.train_step(state, batch, cfg=cfg,
                                          optimizer=optimizer)
        want.append(loss.item())
    np.testing.assert_allclose(dryrun["scan"]["losses"], want, atol=LOSS_ATOL,
                               rtol=0)


def test_dryrun_serving_tokens_equal_plain_generate(dryrun):
    cfg = pt_llama.LlamaConfig.tiny()
    rep = dryrun["serve"]
    want = pt_decode.generate(_params(cfg, "serve"),
                              _tokens(rep, "serve", cfg.vocab_size), cfg,
                              max_new_tokens=4, max_len=16)
    assert rep["batch"] == [N, 8]
    assert rep["tokens"] == want.tolist()


# ---------------------------------------------------------------------------
# dryrun_multichip_multiprocess from a daemon-written bootstrap.json
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _daemon_domain_dir(tmp_path) -> str:
    """Two ComputeDomain daemons register over the fake kube; daemon 0
    writes members.json and bootstrap.json into its domain dir, on a
    free coordinator port. Returns the bootstrap.json's path."""
    from k8s_dra_driver_gpu_tpu.computedomain.controller.controller import (
        ComputeDomainController)
    from k8s_dra_driver_gpu_tpu.computedomain.daemon.main import (
        Daemon, DaemonConfig)
    from k8s_dra_driver_gpu_tpu.pkg.kubeclient import FakeKubeClient
    from tests.test_computedomain import make_cd

    kube = FakeKubeClient()
    for node in ("node-0", "node-1"):
        kube.create("", "v1", "nodes",
                    {"kind": "Node", "metadata": {"name": node}})
    controller = ComputeDomainController(kube)
    coordinator_port = _free_port()
    daemons = []
    try:
        cd = make_cd(kube, topology="2x2x2")  # 2 hosts
        controller.reconcile(cd)
        for node, port in (("node-0", _free_port()),
                           ("node-1", _free_port())):
            daemons.append(Daemon(DaemonConfig(env={
                "COMPUTE_DOMAIN_UUID": cd["metadata"]["uid"],
                "COMPUTE_DOMAIN_NAME": "cd1",
                "COMPUTE_DOMAIN_NAMESPACE": "team-a",
                "CLIQUE_ID": "0", "NODE_NAME": node, "POD_IP": "127.0.0.1",
                "COMPUTE_DOMAIN_NUM_WORKERS": "2",
                "DOMAIN_STATE_DIR": str(tmp_path / node),
                "HOSTS_FILE": str(tmp_path / node / "hosts"),
                "COORDINATION_PORT": str(port),
                "JAX_COORDINATOR_PORT": str(coordinator_port)}), kube=kube))
        assert [d.registrar.register() for d in daemons] == [0, 1]
        for d in daemons:
            d.registrar.set_status("Ready")
        daemons[0].sync_once()
        return daemons[0].bootstrap_file
    finally:
        for d in daemons:
            d.process.stop()
        controller.queue.shutdown(wait=False)


def test_multiprocess_gang_from_a_daemon_bootstrap(tmp_path):
    boot_file = _daemon_domain_dir(tmp_path)
    with open(boot_file, encoding="utf-8") as f:
        boot = json.load(f)
    assert set(pt_entry.BOOTSTRAP_KEYS) <= set(boot)
    host, _, port = boot["coordinatorAddress"].rpartition(":")
    assert host == pt_entry.daemon_dns_name(0)  # resolved by members.json
    reports = pt_entry.dryrun_multichip_multiprocess(
        n_procs=5, local_devices=2, bootstrap_file=boot_file, timeout=300,
        device="cpu")  # the file's numProcesses (2) wins
    assert sorted(r["processId"] for r in reports) == [0, 1]
    for rep in reports:
        assert rep["globalDevices"] == 4 and rep["localDevices"] == 2
        assert rep["devSum"] == 4.0 and rep["rankSum"] == 2.0 * (1 + 2)
        assert rep["steps"] == 2 and rep["gang"] is True
        assert rep["env"]["TPU_COORDINATOR_ADDRESS"] == f"127.0.0.1:{port}"
        assert rep["env"]["TPU_WORKER_HOSTNAMES"] == "127.0.0.1,127.0.0.1"
    assert len({rep["loss"] for rep in reports}) == 1
