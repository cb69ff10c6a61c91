"""The port's reporting hooks, memory tracking and logger against the
reference's (``raft_tpu.observability.hooks``, ``raft_tpu.core.memory``,
``raft_tpu.core.logger``) on the CPU.

The same seeded sequence of hook and ``MemoryTracker`` calls goes to both
packages, each into a fresh process-global registry, and the two
Prometheus texts are byte-equal. One difference is by design and held
here: ``record_collective`` takes the port's tensors (a collective call's
payload) as the reference takes arrays, and the port's ``MeshComms``
counts once a call where the reference counts once a trace. Off a card
the port's ``ResourceMonitor`` samples 0 bytes attributed to the active
range and ``device_memory_stats`` is ``{}``, as the reference's off a
TPU.
"""

import io
import logging
import time

import numpy as np
import pytest
import torch

from raft_tpu.core import logger as jlogger
from raft_tpu.core import memory as jmemory
from raft_tpu.observability import exporters as jexp
from raft_tpu.observability import hooks as jhooks
from raft_tpu.observability import metrics as jmetrics
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import logger, memory, nvtx
from raft_tpu_torch.observability import exporters, hooks, metrics


@pytest.fixture()
def registries():
    jprev = jmetrics.set_registry(jmetrics.MetricsRegistry())
    prev = metrics.set_registry(metrics.MetricsRegistry())
    obs.reset()
    yield
    jmetrics.set_registry(jprev)
    metrics.set_registry(prev)
    obs.reset()


def _script(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(120):
        kind = rng.choice(["collective", "cache", "alloc", "free", "bench"])
        if kind == "collective":
            n = int(rng.integers(1, 64))
            out.append(("collective", str(rng.choice(["allreduce",
                                                       "allgather", "bcast"])),
                        rng.normal(size=(n, 3)).astype(np.float32),
                        str(rng.choice(["x", "y", ""]))))
        elif kind == "cache":
            out.append(("cache", bool(rng.integers(2))))
        elif kind in ("alloc", "free"):
            out.append((kind, int(rng.integers(1, 1 << 20))))
        else:
            out.append(("bench", f"b{int(rng.integers(3))}",
                        float(rng.choice([1e-3, 2.5e-2, 0.75])),
                        float(rng.integers(1, 1000))))
    return out


def _drive(h, tracker, script, torch_payload):
    for step in script:
        if step[0] == "collective":
            x = torch.from_numpy(step[2]) if torch_payload else step[2]
            h.record_collective(step[1], x, step[3])
        elif step[0] == "cache":
            h.record_cache(step[1])
        elif step[0] == "alloc":
            tracker.allocate(step[1])
        elif step[0] == "free":
            tracker.deallocate(step[1])
        else:
            h.record_benchmark(step[1], {"seconds": step[2]},
                               nbytes=step[3])


@pytest.mark.parametrize("torch_payload", [False, True])
def test_hooks_and_tracker_leave_the_reference_prometheus_text(
        registries, torch_payload):
    script = _script(7)
    _drive(jhooks, jmemory.MemoryTracker(), script, False)
    _drive(hooks, memory.MemoryTracker(), script, torch_payload)
    assert exporters.export_prometheus(metrics.get_registry()) == \
        jexp.export_prometheus(jmetrics.get_registry())


def test_adaptors_count_as_the_reference(registries):
    seen = {"p": [], "j": []}
    for mod, key in ((memory, "p"), (jmemory, "j")):
        st = mod.StatisticsAdaptor(upstream=lambda n: bytearray(n))
        buf = st.allocate(100)
        st.allocate(50)
        st.deallocate(buf, 100)
        nt = mod.NotifyingAdaptor(on_allocate=seen[key].append,
                                  on_deallocate=lambda n: seen[key].append(-n))
        nt.allocate(7)
        nt.deallocate(None, 7)
        s = st.stats
        seen[key] += [s.current_bytes, s.peak_bytes, s.total_bytes,
                      s.current_count, s.peak_count, s.total_count,
                      len(buf)]
    assert seen["p"] == seen["j"]
    assert exporters.export_prometheus(metrics.get_registry()) == \
        jexp.export_prometheus(jmetrics.get_registry())


def test_collective_counted_a_call_from_mesh_comms(registries):
    """The port's MeshComms reports each collective call through
    ``record_collective`` (once a call, the reference once a trace)."""
    from raft_tpu_torch.comms import MeshComms
    from raft_tpu_torch.parallel import make_mesh, spmd

    mesh = make_mesh({"x": 2}, devices=["cpu"] * 2)

    def rank_fn(comms):
        x = torch.ones(4, 3) * (comms.get_rank() + 1)
        comms.allreduce(x)
        comms.allreduce(x)
        return comms.allgather(x)

    spmd(mesh, rank_fn)
    reg = metrics.get_registry()
    calls = {m.labels["collective"]: m.value for m in reg.collect()
             if m.name == hooks.COMMS_CALLS}
    nbytes = {m.labels["collective"]: m.value for m in reg.collect()
              if m.name == hooks.COMMS_BYTES}
    assert calls == {"allreduce": 2.0, "allgather": 1.0}
    assert nbytes == {"allreduce": 96.0, "allgather": 48.0}
    assert MeshComms is not None


def test_resource_monitor_attributes_to_the_active_range():
    out = io.StringIO()
    with memory.ResourceMonitor(out, period_s=0.001) as mon:
        with nvtx.annotate("distance.prepare_knn_index"):
            time.sleep(0.03)
    peaks = mon.peak_by_range()
    assert "distance.prepare_knn_index" in peaks
    assert all(v == 0 for v in peaks.values())      # no card: 0 bytes
    assert len(out.getvalue().splitlines()) == len(mon.samples) > 0
    assert memory.device_memory_stats() == {} == \
        memory.device_memory_stats("cpu")


@pytest.mark.parametrize("name", ["trace", "RAFT_LEVEL_DEBUG", "warn", "ERR",
                                  "off", "info", "nonsense"])
def test_logger_levels_as_the_reference(name):
    assert logger._level_from_name(name) == jlogger._level_from_name(name)


def test_logger_env_alias_and_levels(monkeypatch, caplog):
    monkeypatch.delenv("RAFT_TPU_LOG_LEVEL", raising=False)
    monkeypatch.setenv("RAFT_LOG_ACTIVE_LEVEL", "RAFT_LEVEL_TRACE")
    assert logger._env_level() == logger.TRACE == jlogger._env_level()
    monkeypatch.setenv("RAFT_TPU_LOG_LEVEL", "error")
    assert logger._env_level() == logging.ERROR
    lg = logger.default_logger()
    assert lg.name == "raft_tpu_torch" and lg.handlers
    old = lg.level
    try:
        logger.set_level("TRACE")
        with caplog.at_level(logger.TRACE, logger="raft_tpu_torch"):
            logger.log_trace("t %d", 1)
            logger.log_debug("d")
            logger.log_info("i")
            logger.log_critical("c")
        assert [r.getMessage() for r in caplog.records] == ["t 1", "d", "i",
                                                            "c"]
    finally:
        lg.setLevel(old)


def test_resource_monitor_samples_a_range_shorter_than_its_period():
    """The monitored thread samples as it enters and leaves each range,
    so a call far shorter than the period still has its samples; another
    thread's ranges are not the monitored thread's."""
    import threading

    with memory.ResourceMonitor(None, period_s=10.0) as mon:
        with nvtx.annotate("short.call"):
            pass
        t = threading.Thread(target=lambda: nvtx.push_range("other") or
                             nvtx.pop_range())
        t.start()
        t.join()
    tags = [s[2] for s in mon.samples]
    assert tags.count("short.call") == 2 and "other" not in tags
    assert not nvtx._range_hooks
