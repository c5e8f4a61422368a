"""The port's kubelet-plugin ``Driver`` against the JAX package's.

The scenarios of ``tests/test_driver_grpc.py`` (``TestResourceSlices``,
``TestPrepareFlow``, ``TestHealthTaints`` but its real-devfs case,
``TestCleanup``): the JAX ``Driver`` runs on ``Config.mock(topology=
"v5e-4", gates="")`` (whole chips), the port's on ``Config.mock(
topology="h100-4")``, through the same calls and the same mock health
injection. Compared up to the ``chip-<i>`` <-> ``gpu-<i>`` name map and
the driver names: publish stats, slice names, count and
``resourceSliceCount``, device names, counter keys, taints by key and
effect, prepare results and error classes, the claims the GC reaps.

Each scenario runs in two wirings: ``memory`` (each driver over its own
package's in-memory ``FakeKubeClient``) and ``crossed`` (each driver's
``KubeClient`` over HTTP to the other package's ``FakeApiServer``).
"""

import copy
import dataclasses
import random
import re
import threading

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import DRIVER_NAME as JAX_DRIVER
from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.pkg import fakeapiserver as jax_server
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_tpulib
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME as PT_DRIVER
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import cleanup as pt_cleanup
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.pkg import fakeapiserver as pt_server
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_tpulib
from tests.fake_kube import CountingKube, make_claim_dict

RC = ("resource.k8s.io", "v1", "resourceclaims")
RS = ("resource.k8s.io", "v1", "resourceslices")
SIDES = ("jax", "pt")
WIRINGS = ("memory", "crossed")


def neutral(text: str) -> str:
    """Device and driver names without their package: chip-i and gpu-i
    become #i, the driver names DRV (and so does the taint keys' prefix,
    the JAX driver's name)."""
    text = text.replace(JAX_DRIVER, "DRV").replace(PT_DRIVER, "DRV")
    return re.sub(r"\b(?:chip|gpu)-(\d+)", r"#\1", text)


@pytest.fixture(scope="module")
def servers():
    running = {"jax": jax_server.FakeApiServer().start(),
               "pt": pt_server.FakeApiServer().start()}
    yield running
    for server in running.values():
        server.stop()


class Side:
    """One package's driver stack over one kube client."""

    def __init__(self, name, root, kube, store):
        self.name, self.root, self.kube, self.store = name, root, kube, store
        self.ds = jax_ds if name == "jax" else pt_ds
        self.driver_mod = jax_driver if name == "jax" else pt_driver
        self.health = jax_health if name == "jax" else pt_health
        self.tpulib = jax_tpulib if name == "jax" else pt_tpulib
        self.driver_name = JAX_DRIVER if name == "jax" else PT_DRIVER
        self.drivers = []

    def dev(self, i: int) -> str:
        return f"chip-{i}" if self.name == "jax" else f"gpu-{i}"

    def config(self, sub="state", gpus=4, health_events=None):
        root = f"{self.root}/{sub}"
        if self.name == "jax":
            cfg = jax_ds.Config.mock(root=root, topology=f"v5e-{gpus}",
                                     gates="")
            opts = "tpulib_opts"
        else:
            cfg = pt_ds.Config.mock(root=root, topology=f"h100-{gpus}")
            opts = "gpulib_opts"
        if health_events:
            setattr(cfg, opts, dataclasses.replace(
                getattr(cfg, opts), health_events=health_events))
        return cfg

    def driver(self, node="node-a", kube=None, monitor=False, **kw):
        cfg = kw.pop("config", None) or self.config(**{
            k: kw.pop(k) for k in ("sub", "gpus", "health_events")
            if k in kw})
        # One layout on both sides, without either driver's sniff of the
        # server's version.
        kw.setdefault("publication_mode", "combined")
        d = self.driver_mod.Driver(cfg, kube or self.kube, node_name=node,
                                   enable_health_monitor=monitor, **kw)
        self.drivers.append(d)
        return d

    def put_claim(self, uid, indices, namespace="default", name=None,
                  request="req"):
        obj = make_claim_dict(uid, [self.dev(i) for i in indices],
                              namespace=namespace, name=name,
                              request=request, driver=self.driver_name)
        self.kube.create(*RC, obj, namespace=namespace)
        return obj

    def slices(self):
        return self.kube.list(*RS)

    def monitor(self, d, events):
        """The JAX test's monitor: the mock's injection string."""
        if self.name == "jax":
            lib, opts = d.state._tpulib, jax_tpulib.EnumerateOptions(
                mock_topology="v5e-4", health_events=events)
        else:
            lib, opts = pt_tpulib.load("python"), pt_tpulib.EnumerateOptions(
                mock_topology="h100-4", health_events=events)
        return self.health.ChipHealthMonitor(lib, opts, d._on_health_taints)

    def taint(self, dev, kind, effect):
        return self.health.DeviceTaint(device=self.dev(dev),
                                       key=f"tpu.dra.dev/{kind}",
                                       value="true", effect=effect)

    def cleanup_once(self, d):
        """One stale-claim GC pass: the JAX driver's manager, the port's
        function."""
        if self.name == "jax":
            return d.cleanup.cleanup_once()
        return pt_cleanup.cleanup_once(d.state, d.kube)

    def close(self):
        for d in self.drivers:
            d.stop()


@pytest.fixture(params=WIRINGS)
def sides(request, tmp_path, servers):
    """Both sides in one wiring: {"jax": Side, "pt": Side}."""
    out = {}
    for name in SIDES:
        kube_mod = jax_kube if name == "jax" else pt_kube
        if request.param == "memory":
            store = kube_mod.FakeKubeClient()
            kube = store
        else:
            server = servers["pt" if name == "jax" else "jax"]
            store = server.store
            with store._lock:
                store._store.clear()
                store._uid = 0
            store.version = {"major": "1", "minor": "34"}
            kube = kube_mod.KubeClient(host=server.url)
        out[name] = Side(name, str(tmp_path / name), kube, store)
    yield out
    for side in out.values():
        side.close()


def both(sides, fn):
    """``fn(side)`` on each side; the two results, neutral."""
    got = {name: fn(side) for name, side in sides.items()}
    return neutral(repr(got["jax"])), neutral(repr(got["pt"]))


def same(sides, fn):
    jax, pt = both(sides, fn)
    assert pt == jax
    return pt


def counters_by_chip(sets, set_key="name"):
    """The counters of a ``sharedCounters`` or ``consumesCounters`` block
    by the chip or GPU they count: the JAX layout's ``core-<i>-<k>`` and
    ``hbm-<i>`` of its one host set, the port's every counter of its set
    ``gpu-<i>-counter-set``."""
    out: dict[int, dict] = {}
    for c in sets:
        m = re.fullmatch(r"gpu-(\d+)-counter-set", c[set_key])
        for key, value in c["counters"].items():
            index = int(m.group(1)) if m else int(
                re.match(r"(?:core|hbm)-(\d+)", key).group(1))
            out.setdefault(index, {})[key] = value
    return out


def structure(slices):
    """What the comparison reads of a pool: per slice its name, count,
    generation, the chips its shared counters count, and per device its
    name, what it consumes of each chip's counters (all of them, or a
    part) and its taints by key and effect."""
    out = []
    for s in sorted(slices, key=lambda s: s["metadata"]["name"]):
        spec = s["spec"]
        shared = counters_by_chip(spec.get("sharedCounters", []))
        out.append((
            s["metadata"]["name"], spec["driver"], spec["nodeName"],
            spec["pool"]["resourceSliceCount"], spec["pool"]["generation"],
            sorted(shared),
            [(d["name"],
              [(i, "all" if used == shared.get(i) else "part")
               for i, used in sorted(counters_by_chip(
                   d.get("consumesCounters", []), "counterSet").items())],
              [(t["key"], t.get("effect")) for t in d.get("taints", [])])
             for d in spec["devices"]]))
    return out


# -- ResourceSlices ------------------------------------------------------


class TestResourceSlices:
    def test_combined_slice_published(self, sides):
        def run(side):
            d = side.driver()
            return d.publish_resources(), structure(side.slices())
        got = same(sides, run)
        assert "('#0', [(0, 'all')]" in got

    def test_construction_sends_no_request(self, tmp_path):
        """With its publication mode given, nothing asks the server's
        version: a driver costs no request until it publishes."""
        with pt_server.FakeApiServer() as server:
            d = pt_driver.Driver(
                pt_ds.Config.mock(str(tmp_path), topology="h100-4"),
                pt_kube.KubeClient(host=server.url), node_name="node-a",
                enable_health_monitor=False, publication_mode="combined")
            assert server.request_count() == 0
            d.publish_resources()
            assert server.requests == {"GET": 1, "POST": 1}

    @pytest.mark.parametrize("version, mode", [("34", "combined"),
                                               ("35", "split"),
                                               ("36+", "split")])
    def test_the_servers_version_chooses_the_mode(self, tmp_path, version,
                                                  mode):
        """Without a publication mode, one ``/version`` request chooses
        it, as the JAX driver's sniff does."""
        with pt_server.FakeApiServer() as server:
            server.store.version = {"major": "1", "minor": version}
            d = pt_driver.Driver(
                pt_ds.Config.mock(str(tmp_path), topology="h100-4"),
                pt_kube.KubeClient(host=server.url), node_name="node-a",
                enable_health_monitor=False)
            jax_mode = jax_driver.Driver(
                jax_ds.Config.mock(root=str(tmp_path / "jax"),
                                   topology="v5e-4", gates=""),
                jax_kube.KubeClient(host=server.url), node_name="node-a",
                enable_health_monitor=False).publication_mode
            assert (d.publication_mode, jax_mode) == (mode, mode)
            assert server.requests == {"GET": 2}
        with pytest.raises(ValueError, match="legacy .*§1b item 8"):
            pt_driver.Driver(pt_ds.Config.mock(str(tmp_path)),
                             pt_kube.FakeKubeClient(), "n",
                             enable_health_monitor=False,
                             publication_mode="legacy")

    @pytest.mark.parametrize("mode", ["split", "combined"])
    def test_mig_publication_has_the_references_structure(self, sides,
                                                          mode):
        """Whole devices and sub-devices (the JAX plugin's sub-slices on
        a v5p-8, the port's MIG devices on an h100-4 with MIG on): in
        split mode two slices, each counted in ``resourceSliceCount``,
        one of whole devices that each consume all of their chip's
        counters and one of sub-devices that each consume a part of
        theirs, or all of it for a carve-out of a whole chip (``ss-1x1x1``,
        ``7g.80gb``); in combined mode one slice of both."""
        def run(side):
            root = f"{side.root}/mig"
            if side.name == "jax":
                cfg = jax_ds.Config.mock(root=root, topology="v5p-8",
                                         gates="DynamicSubSlice=true")
            else:
                cfg = pt_ds.Config.mock(root, topology="h100-4",
                                        gates="DynamicSubSlice=true",
                                        mig_mode="enabled")
            stats = side.driver(config=cfg,
                                publication_mode=mode).publish_resources()
            out = []
            for s in sorted(side.slices(), key=lambda s: s["metadata"][
                    "name"]):
                spec = s["spec"]
                shared = counters_by_chip(spec["sharedCounters"])
                kinds = set()
                for d in spec["devices"]:
                    whole = bool(re.fullmatch(r"(chip|gpu)-\d+", d["name"]))
                    kinds |= {("whole" if whole else "sub",
                               "all" if u == shared[i] else "part")
                              for i, u in counters_by_chip(
                                  d["consumesCounters"],
                                  "counterSet").items()}
                name = re.sub(r"-(chips|gpus)$", "-WHOLE", re.sub(
                    r"-(partitions|mig)$", "-SUB", s["metadata"]["name"]))
                out.append((name, spec["pool"]["resourceSliceCount"],
                            sorted(kinds), sorted(shared)))
            return stats["writes"], out
        got = same(sides, run)
        sub = [("sub", "all"), ("sub", "part")]
        if mode == "split":
            assert got == neutral(repr((2, [
                ("node-a-DRV-WHOLE", 2, [("whole", "all")], [0, 1, 2, 3]),
                ("node-a-DRV-SUB", 2, sub, [0, 1, 2, 3])])))
        else:
            assert got == neutral(repr((1, [
                ("node-a-DRV", 1, sub + [("whole", "all")],
                 [0, 1, 2, 3])])))

    def test_republish_unchanged_is_write_free(self, sides):
        def run(side):
            d = side.driver()
            return [d.publish_resources() for _ in range(3)], structure(
                side.slices())
        got = same(sides, run)
        assert "'writes': 0, 'deletes': 0, 'skipped': 1, 'generation': 1" \
            in got

    def test_stale_split_slices_deleted_on_transition(self, sides):
        """A pool an earlier plugin published in the two-slice split
        layout: the publish writes the one combined slice at the next
        generation and deletes both stale ones."""
        def run(side):
            for suffix, devs in (("-chips", [0, 1, 2, 3]),
                                 ("-partitions", [0])):
                side.kube.create(*RS, {
                    "metadata": {"name": f"node-b-{side.driver_name}"
                                         f"{suffix}"},
                    "spec": {"driver": side.driver_name, "nodeName": "node-b",
                             "pool": {"name": "node-b", "generation": 3,
                                      "resourceSliceCount": 2},
                             "devices": [{"name": side.dev(i)}
                                         for i in devs]}})
            d = side.driver(node="node-b")
            return d.publish_resources(), structure(side.slices())
        got = same(sides, run)
        assert "'writes': 1, 'deletes': 2, 'skipped': 0, 'generation': 4" \
            in got

    def test_counters_name_each_device_and_its_memory(self, sides):
        def run(side):
            side.driver().publish_resources()
            spec = side.slices()[0]["spec"]
            shared = counters_by_chip(spec["sharedCounters"])
            memory = "hbm-{}" if side.name == "jax" else "memory"
            used = {d["name"]: counters_by_chip(d["consumesCounters"],
                                                "counterSet")
                    for d in spec["devices"]}
            return (sorted(shared),
                    [used[side.dev(i)][i][memory.format(i)]
                     == shared[i][memory.format(i)] for i in range(4)])
        assert same(sides, run) == repr(([0, 1, 2, 3], [True] * 4))


# -- sliceutil: the publish diff on scripted pools ------------------------


def _random_slices(rng, node="node-s"):
    """A desired pool of one to three slices of DRV on ``node``: names,
    devices and taints drawn from small sets, so that successive draws
    repeat, change content only, or change the inventory."""
    names = rng.sample(["a", "b", "c", "d"], rng.randint(1, 3))
    out = []
    for name in sorted(names):
        devices = []
        for i in sorted(rng.sample(range(6), rng.randint(0, 3))):
            dev = {"name": f"dev-{i}"}
            if rng.random() < 0.3:
                dev["taints"] = [{"key": "k", "value": rng.choice("xy")}]
            devices.append(dev)
        out.append({"apiVersion": "resource.k8s.io/v1",
                    "kind": "ResourceSlice",
                    "metadata": {"name": f"{node}-{name}"},
                    "spec": {"driver": "DRV", "nodeName": node,
                             "pool": {"name": node, "generation": 0,
                                      "resourceSliceCount": len(names)},
                             "devices": devices}})
    return out


def _live_pool(rng):
    """What a server may already hold: slices of the pool at one or at
    mixed generations, and slices of another node and another driver,
    which a publish must leave alone."""
    live = []
    for s in _random_slices(rng) if rng.random() < 0.8 else []:
        s["spec"]["pool"]["generation"] = rng.choice([1, 1, 4])
        live.append(s)
    other = _random_slices(rng, node="node-t")[0]
    foreign = _random_slices(rng)[0]
    foreign["metadata"]["name"] = "foreign"
    foreign["spec"]["driver"] = "OTHER"
    return live + [other, foreign]


@pytest.mark.parametrize("seed", range(16))
def test_publish_resource_slices_equals_the_references(seed):
    """The same live pool and the same six desired sets, each either the
    last one again, the last one with a taint changed, or a new draw,
    through both packages' ``publish_resource_slices``: the same stats
    and the same objects on the server after every publish."""
    from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_sliceutil
    from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_sliceutil

    rng = random.Random(seed)
    live = _live_pool(rng)
    steps, desired = [], _random_slices(rng)
    for _ in range(6):
        r = rng.random()
        if r < 0.3:
            desired = copy.deepcopy(desired)
        elif r < 0.6:
            desired = copy.deepcopy(desired)
            dev = rng.choice(desired)["spec"]["devices"] or [{}]
            dev[0]["taints"] = [{"key": "k", "value": str(r)}]
        else:
            desired = _random_slices(rng)
        steps.append(desired)
    got = {}
    for name, mod, kube_mod in (("jax", jax_sliceutil, jax_kube),
                                ("pt", pt_sliceutil, pt_kube)):
        kube = kube_mod.FakeKubeClient()
        for obj in live:
            kube.create(*RS, copy.deepcopy(obj))
        got[name] = [(mod.publish_resource_slices(kube, copy.deepcopy(d)),
                      sorted((o["metadata"]["name"], o["spec"])
                             for o in kube.list(*RS)))
                     for d in steps]
    assert got["pt"] == got["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_slice_content_hash_equals_the_references(seed):
    from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_sliceutil
    from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_sliceutil

    rng = random.Random(seed)
    for obj in _random_slices(rng) + _live_pool(rng):
        again = copy.deepcopy(obj)
        again["spec"]["pool"]["generation"] += 7
        again["metadata"]["resourceVersion"] = "9"
        assert pt_sliceutil.slice_content_hash(obj) == \
            jax_sliceutil.slice_content_hash(obj) == \
            pt_sliceutil.slice_content_hash(again)


# -- prepare -------------------------------------------------------------


def error_class(err: str) -> str:
    if not err:
        return ""
    for needle, name in (("UID mismatch", "uid-mismatch"),
                         ("overlaps with", "overlap"),
                         ("unknown device", "unknown-device")):
        if needle in err:
            return name
    if err.startswith("404"):
        return "not-found"
    return "other: " + err


def results(out: dict) -> dict:
    return {uid: ([(d["request_names"], d["pool_name"], d["device_name"],
                    len(d["cdi_device_ids"])) for d in devices],
                  error_class(err))
            for uid, (devices, err) in out.items()}


def ref(uid, namespace="default", name=None):
    return {"uid": uid, "namespace": namespace, "name": name or uid}


class TestPrepareFlow:
    def test_prepare_via_api_lookup(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0, 1], namespace="team-a")
            return results(d.prepare_resource_claims(
                [ref("u1", "team-a")]))
        got = same(sides, run)
        assert "'#0'" in got and "'#1'" in got

    def test_uid_mismatch_rejected(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0])
            return results(d.prepare_resource_claims(
                [ref("other-uid", name="u1")]))
        assert "uid-mismatch" in same(sides, run)

    def test_unprepare(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0])
            d.prepare_resource_claims([ref("u1")])
            return (d.unprepare_resource_claims([{"uid": "u1"}]),
                    d.unprepare_resource_claims([{"uid": "u1"}]),
                    d.state.prepared_claims())
        same(sides, run)

    def test_multi_claim_errors_stay_per_claim(self, sides):
        def run(side):
            d = side.driver()
            refs = []
            for i in range(3):
                side.put_claim(f"fan-{i}", [i])
                refs.append(ref(f"fan-{i}"))
            refs.append(ref("fan-bad", name="missing"))
            return results(d.prepare_resource_claims(refs)), sorted(
                d.state.prepared_claims())
        assert "not-found" in same(sides, run)

    def test_overlapping_claim_refused(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [2])
            side.put_claim("u2", [2, 3])
            # One call each: the JAX driver prepares the claims of one
            # call in a thread pool, so which of two overlapping claims
            # wins would be a race there.
            return (results(d.prepare_resource_claims([ref("u1")])),
                    results(d.prepare_resource_claims([ref("u2")])))
        assert "overlap" in same(sides, run)

    def test_unknown_device_refused(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [7])
            return results(d.prepare_resource_claims([ref("u1")])), \
                d.state.prepared_claims()
        assert "unknown-device" in same(sides, run)

    def test_repeat_prepare_gives_the_same_ids(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [1, 3])
            first = d.prepare_resource_claims([ref("u1")])
            return first == d.prepare_resource_claims([ref("u1")]), \
                results(first)
        assert same(sides, run).startswith("(True")

    def test_ids_grouped_by_request(self, sides):
        def run(side):
            d = side.driver()
            obj = make_claim_dict("u1", [], driver=side.driver_name)
            obj["status"]["allocation"]["devices"]["results"] = [
                {"request": req, "driver": side.driver_name, "pool": "p",
                 "device": side.dev(i)}
                for req, i in (("a", 0), ("b", 1), ("a", 2))]
            side.kube.create(*RC, obj, namespace="default")
            return results(d.prepare_resource_claims([ref("u1")]))
        got = same(sides, run)
        assert got.index("'#2'") < got.index("'#1'")


# -- health taints -------------------------------------------------------


class TestHealthTaints:
    @pytest.mark.parametrize("events", [
        "chip=1,kind=ici_link_down|chip=2,kind=thermal",
        "chip=0,kind=hbm_uncorrectable",
        "chip=3,kind=chip_lost|chip=3,kind=thermal_notice",
        "chip=2,kind=xid_94|chip=0,kind=clock_throttle",
        ""])
    def test_taints_republish(self, sides, events):
        def run(side):
            d = side.driver()
            d.publish_resources()
            taints = side.monitor(d, events).poll_once()
            d._on_health_taints(taints)
            return structure(side.slices())
        same(sides, run)

    def test_unmonitored_taint_when_health_disabled(self, sides):
        def run(side):
            side.driver(node="node-um").publish_resources()
            return structure(side.slices())
        assert "'DRV/unmonitored', None" in same(sides, run)

    def test_monitor_baseline_and_ignored_kinds(self, sides):
        def run(side):
            d = side.driver(
                monitor=True, health_events="chip=1,kind=ici_link_down|"
                "chip=2,kind=thermal|chip=0,kind=xid_13",
                additional_ignored_health_kinds=("thermal",))
            opts = d.health_monitor._opts
            return (opts.expected_chips, sorted(
                (t.device, t.key, t.effect)
                for t in d.health_monitor.poll_and_reconcile()))
        got = same(sides, run)
        assert "'0,1,2,3'" in got and "thermal'" not in got

    def test_unchanged_taint_republish_is_zero_kube_calls(self, sides):
        def run(side):
            counting = CountingKube(side.kube)
            d = side.driver(node="node-zh", kube=counting)
            d.publish_resources()
            taints = [side.taint(2, "thermal", "")]
            d._on_health_taints(taints)
            gen = side.slices()[0]["spec"]["pool"]["generation"]
            writes0, reads0 = counting.writes, counting.reads
            for _ in range(5):
                d._on_health_taints(taints)
            steady = (counting.writes - writes0, counting.reads - reads0)
            d._on_health_taints([])
            return (gen, steady, counting.writes - writes0,
                    structure(side.slices()))
        assert same(sides, run).startswith("(1, (0, 0), 1,")

    def test_unchanged_taints_cost_no_http_request(self, tmp_path):
        """Over the port's server: the steady state sends nothing."""
        with pt_server.FakeApiServer() as server:
            d = pt_driver.Driver(
                pt_ds.Config.mock(str(tmp_path), topology="h100-4"),
                pt_kube.KubeClient(host=server.url), node_name="node-a",
                enable_health_monitor=False)
            d.publish_resources()
            taints = [pt_health.DeviceTaint("gpu-1", "tpu.dra.dev/xid_94",
                                            "true", "")]
            d._on_health_taints(taints)
            count = server.request_count()
            for _ in range(5):
                d._on_health_taints(taints)
            assert server.request_count() == count

    def test_publish_recheck_repairs_external_slice_deletion(
            self, sides, monkeypatch):
        monkeypatch.setenv("TPU_DRA_PUBLISH_RECHECK_S", "0")

        def run(side):
            d = side.driver(node="node-rh")
            d.publish_resources()
            name = side.slices()[0]["metadata"]["name"]
            side.kube.delete(*RS, name)
            gone = side.slices()
            d._on_health_taints([])
            return gone, [s["metadata"]["name"] for s in side.slices()]
        same(sides, run)

    def test_fatal_taint_flip_is_one_write_at_the_same_generation(
            self, sides):
        def run(side):
            counting = CountingKube(side.kube)
            d = side.driver(kube=counting)
            d.publish_resources()
            w0 = counting.writes
            d._on_health_taints([side.taint(0, "chip_lost", "NoExecute")])
            raised = (counting.writes - w0, structure(side.slices()))
            w1 = counting.writes
            d._on_health_taints([])
            return raised, counting.writes - w1, structure(side.slices())
        got = same(sides, run)
        assert got.startswith("((1, ") and "'NoExecute')" in got

    def test_ignored_kinds(self):
        for mod, lib in ((jax_health, jax_tpulib), (pt_health, pt_tpulib)):
            assert mod.health_event_to_taints(lib.HealthEvent(
                chip=0, kind="thermal_notice", fatal=False)) == []


# -- cleanup -------------------------------------------------------------


class TestCleanup:
    def test_stale_claim_reaped(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0])
            d.prepare_resource_claims([ref("u1")])
            side.kube.delete(*RC, "u1", namespace="default")
            return side.cleanup_once(d), d.state.prepared_claims()
        assert same(sides, run) == "(['u1'], {})"

    def test_live_claim_kept(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0])
            d.prepare_resource_claims([ref("u1")])
            return side.cleanup_once(d), sorted(
                d.state.prepared_claims())
        assert same(sides, run) == "([], ['u1'])"

    def test_recreated_claim_uid_mismatch_reaped(self, sides):
        def run(side):
            d = side.driver()
            side.put_claim("u1", [0])
            d.prepare_resource_claims([ref("u1")])
            side.kube.delete(*RC, "u1", namespace="default")
            side.put_claim("u1-reborn", [1], name="u1")
            return side.cleanup_once(d)
        assert same(sides, run) == "['u1']"


# -- threads -------------------------------------------------------------


def test_start_and_stop_leave_no_thread(tmp_path):
    """The threads this driver starts (its sweep and its health monitor,
    by identity) are gone after ``stop()``, and so is the server's own.
    Threads of other tests' servers may start or end meanwhile: the
    process-wide set is not this test's to hold."""
    before = set(threading.enumerate())
    with pt_server.FakeApiServer() as server:
        cfg = pt_ds.Config.mock(str(tmp_path), topology="h100-2")
        cfg.gpulib_opts = dataclasses.replace(
            cfg.gpulib_opts, health_events="chip=1,kind=chip_lost")
        d = pt_driver.Driver(cfg, pt_kube.KubeClient(host=server.url),
                             node_name="node-a")
        d.health_monitor._interval = 0.01
        d.start()
        mine = [d.reconciler._thread, d.health_monitor._thread]
        served = server._thread
        assert all(t.is_alive() and t not in before for t in mine)
        deadline = threading.Event()
        for _ in range(200):
            devices = server.store.list(*RS)[0]["spec"]["devices"]
            if "taints" in devices[1]:
                break
            deadline.wait(0.01)
        d.stop()
        assert devices[1]["taints"] == [{"key": "tpu.dra.dev/chip_lost",
                                         "value": "true",
                                         "effect": "NoExecute"}]
        assert "taints" not in devices[0]
        assert not any(t.is_alive() for t in mine)
    assert not served.is_alive()
    assert not [t for t in threading.enumerate()
                if t in mine or t is served]


def test_nvml_host_publishes_taints_and_mounts_nvmls_driver(
        tmp_path, monkeypatch):
    """The NVML path over the fake ``libnvidia-ml.so.1`` (driver
    550.54.15): the monitor opens its own handle and closes it at stop;
    Xid taints reach the slice; a prepared claim's spec mounts the
    libraries of NVML's version only."""
    import ctypes

    from tests.test_torch_kubeletplugin_health import build_fake_nvml

    lib_path = build_fake_nvml(tmp_path / "nvml")
    ctypes.CDLL(lib_path).fake_reset()
    for var in ("FAKE_NVML_LOST", "FAKE_NVML_NO_PCI", "FAKE_NVML_INIT_RC"):
        monkeypatch.delenv(var, raising=False)
    opened = []

    def load(backend=None):
        opened.append(pt_tpulib.NvmlLib(lib_path))
        return opened[-1]

    monkeypatch.setattr(pt_ds, "load", load)
    monkeypatch.setattr(pt_driver, "load", load)
    root = tmp_path / "driver" / "usr" / "lib64"
    root.mkdir(parents=True)
    for lib in ("libcuda", "libnvidia-ml"):
        for version in ("550.54.15", "535.1"):
            (root / f"{lib}.so.{version}").write_text(version)
        (root / f"{lib}.so.1").symlink_to(f"{lib}.so.550.54.15")
    kube = pt_kube.FakeKubeClient()
    d = pt_driver.Driver(
        pt_ds.Config(root=str(tmp_path / "state"),
                     driver_root=str(tmp_path / "driver")),
        kube, node_name="node-a")
    assert len(opened) == 2 and opened[0]._lib is None  # enumerated, closed
    d.publish_resources()
    d._on_health_taints(d.health_monitor.poll_and_reconcile())
    devices = kube.list(*RS)[0]["spec"]["devices"]
    assert [(dev["name"], dev.get("taints")) for dev in devices] == [
        ("gpu-0", [{"key": "tpu.dra.dev/hbm_uncorrectable", "value": "true",
                    "effect": "NoExecute"}]),
        ("gpu-1", None), ("gpu-2", None),
        ("gpu-3", [{"key": "tpu.dra.dev/hbm_uncorrectable", "value": "true",
                    "effect": "NoExecute"},
                   {"key": "tpu.dra.dev/xid_94", "value": "true"}])]
    kube.create(*RC, make_claim_dict("c1", ["gpu-1"], driver=PT_DRIVER),
                namespace="default")
    assert d.prepare_resource_claims([ref("c1")])["c1"][1] == ""
    mounts = d.state._cdi.read_spec("c1")["containerEdits"]["mounts"]
    assert [(m["hostPath"], m["containerPath"]) for m in mounts] == [
        (f"{root}/{lib}.so.550.54.15", f"/usr/lib64/{name}")
        for lib in ("libcuda", "libnvidia-ml")
        for name in (f"{lib}.so.550.54.15", f"{lib}.so.1")]
    d.stop()
    assert opened[1]._lib is None  # the monitor closed its handle
