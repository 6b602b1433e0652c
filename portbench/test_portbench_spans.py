"""The port's spans in a traced window (`port_spans`) and the metrics that
read them or the port's new records, on synthetic events and in traced CPU
runs."""
import dataclasses

import pytest
from torch.autograd import DeviceType

from portbench import harness, port_spans, tracing

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
NEW = ("loop_idle_ms_per_superstep", "host_reads_per_superstep",
       "ingress_csr_s")
MAIN = 7


@dataclasses.dataclass
class Event:
    """The part of a profiler event that the reductions read."""

    n: str
    start: int
    dur: int
    dev: DeviceType = DeviceType.CPU
    corr: int = 0
    tid: int = MAIN

    def name(self):
        return self.n

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def device_type(self):
        return self.dev

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid


def span(name, start, end):
    return Event(name, start, end - start)


def kernel(name, start, end, corr):
    return Event(name, start, end - start, dev=DeviceType.CUDA, corr=corr)


def launch(start, corr):
    return Event("cudaLaunchKernel", start, 5, corr=corr)


def base_events():
    """One traced window (0-1000 ns): a job whose loop launches a gather,
    a message kernel and the combine, a halt test that reads, then apply;
    the benchmark's own spans around the job, also on the device timeline
    as user annotations."""
    return [span(tracing.WINDOW, 0, 1000),
            span("portbench.job.run", 10, 890),
            Event("portbench.job.run", 100, 700, dev=DeviceType.CUDA),
            launch(30, 1), launch(60, 2), launch(90, 3), launch(400, 4),
            # an op's correlation id lies in another space: never a launch
            Event("aten::index_select", 28, 20, corr=99),
            kernel("indexSelectLargeIndex", 100, 300, 1),
            kernel("elementwise_kernel", 300, 350, 2),
            kernel("combine_d1_kernel", 350, 420, 3),
            kernel("reduce_kernel", 500, 520, 4),
            kernel("elementwise_kernel", 700, 800, 99)]


def port_events():
    """The spans the port opens around the same work (host events only)."""
    return [span("gre.run", 20, 880), span("gre.superstep", 25, 870),
            span("gre.scatter_combine", 26, 100),
            span("gre.gather", 27, 50), span("gre.message", 55, 80),
            span("gre.combine", 85, 99), span("gre.apply", 390, 860),
            span("gre.halt_test", 510, 690), span("gre.superstep", 875, 879)]


def test_port_spans_leave_the_summary_bit_identical():
    """The existing per-layer metrics read the same trace with and without
    the port's spans."""
    plain = tracing.summarise(base_events(), 4000, 3)
    spanned = tracing.summarise(base_events() + port_events(), 4000, 3)
    for field in ("window_s", "busy_s", "by_group_s", "k1_least_s",
                  "idle_by_span_s", "queries"):
        assert getattr(spanned, field) == getattr(plain, field), field


def test_reduction_has_the_summarys_busy_time_and_gaps():
    events = base_events() + port_events()
    summary = tracing.summarise(events, 0, 1)
    spans = port_spans.reduce(events)
    assert spans.busy_s == summary.busy_s
    assert sum(spans.idle_by_span_s.values()) == pytest.approx(
        sum(summary.idle_by_span_s.values()), abs=1e-15)
    assert spans.device_annotations == 0


def test_gap_inside_halt_test_is_labelled_by_it():
    spans = port_spans.reduce(base_events() + port_events())
    # the gap 520-700 has its middle (610) inside gre.halt_test
    assert spans.idle_by_span_s["gre.halt_test"] == pytest.approx(180e-9)
    assert "portbench.job.run" not in spans.idle_by_span_s
    # and 0-100 inside gre.gather, 420-500 inside gre.apply
    assert spans.idle_by_span_s["gre.gather"] == pytest.approx(100e-9)
    assert spans.idle_by_span_s["gre.apply"] == pytest.approx(80e-9)
    assert spans.idle_in_s["gre.run"] == pytest.approx(360e-9)
    assert spans.idle_in_s["gre.superstep"] == pytest.approx(360e-9)
    assert spans.idle_by_span_s[port_spans.OUTSIDE] == pytest.approx(200e-9)
    assert spans.idle_in_s["portbench.job.run"] == spans.idle_in_s["gre.run"]
    assert spans.counts["gre.superstep"] == 2 and spans.counts["gre.run"] == 1


def test_kernel_is_charged_to_the_span_of_its_launch():
    spans = port_spans.reduce(base_events() + port_events())
    got = spans.device_by_span_s
    assert got["gre.gather"] == pytest.approx(200e-9)
    assert got["gre.message"] == pytest.approx(50e-9)
    assert got["gre.combine"] == pytest.approx(70e-9)
    assert got["gre.apply"] == pytest.approx(20e-9)
    assert got[port_spans.UNATTRIBUTED] == pytest.approx(100e-9)


def test_device_annotations_of_the_port_are_no_operations():
    events = base_events() + port_events() + [
        Event("gre.message", 300, 50, dev=DeviceType.CUDA)]
    spans = port_spans.reduce(events)
    assert spans.device_annotations == 1
    assert spans.busy_s == port_spans.reduce(base_events()).busy_s


def test_launch_on_another_thread_reads_its_own_spans():
    events = base_events() + port_events()
    events[3] = dataclasses.replace(events[3], tid=MAIN + 1)
    got = port_spans.reduce(events).device_by_span_s
    assert got[port_spans.OUTSIDE] == pytest.approx(200e-9)
    assert "gre.gather" not in got


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reads_the_port(cell):
    res = harness.run_cell(cell, 2**31 + 17, 0.5, True, device="cpu",
                           overrides={"scale": 8})
    assert res["correct"], res["checks"]
    got = res["metrics"]
    want = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "per_layer")}
    assert {"host_reads_per_superstep", "ingress_csr_s"} <= want
    assert got["host_reads_per_superstep"]["value"] >= 1.0
    assert got["ingress_csr_s"]["value"] > 0
    phases = res["record"].snapshots["ingress_csr_s"][0]
    assert tuple(phases) == ("fill", "sort_dst", "csr", "upload")
    # the device's readers find no device operation on the CPU
    assert "loop_idle_ms_per_superstep" not in got
    spans = res["record"].snapshots["loop_idle_ms_per_superstep"][1]
    steps = sum(r.supersteps for r in res["record"].completed)
    assert spans.counts["gre.superstep"] >= steps > 0
    assert spans.device_by_span_s == {} and spans.busy_s == 0


def test_untraced_run_reads_no_spans():
    res = harness.run_cell(CELLS[0], 2**31 + 19, 0.2, False, device="cpu",
                           overrides={"scale": 8})
    assert res["record"].snapshots["loop_idle_ms_per_superstep"] == (
        None, None)


def test_port_without_the_records_reads_nothing(monkeypatch):
    """Against a port that lacks the halt test's counter and the ingress
    record, the new readers read nothing and raise nothing."""
    import sys
    import types

    from repro_torch.core.engine import DevicePartition
    # the program keeps its own references to the loop's module
    monkeypatch.setitem(sys.modules, "repro_torch.core.plan",
                        types.ModuleType("repro_torch.core.plan"))
    build = DevicePartition.from_graph

    def unrecorded(*args, **kwargs):
        part = build(*args, **kwargs)
        del part.ingress_s
        return part
    monkeypatch.setattr(DevicePartition, "from_graph",
                        staticmethod(unrecorded))
    res = harness.run_cell(CELLS[1], 2**31 + 23, 0.5, True, device="cpu",
                           overrides={"scale": 8})
    assert res["correct"]
    for name in NEW:
        assert name not in res["metrics"]
