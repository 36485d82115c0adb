"""The reduction of the program's spans (``harness/spans.py``) on a
made-up trace of two threads: kernels given to the innermost span across
threads, kernels under no span, sync idle, and the spans against the
kernel-name stems; then ``spans_report.py`` on a real traced run of the
small cells on the CPU."""

from __future__ import annotations

import pathlib
import sys
import time

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path[:0] = [str(HERE), str(BENCH), str(ROOT)]

import spans_report  # noqa: E402
import tiny  # noqa: E402
from harness import readers, spans, trace  # noqa: E402

MS = 1_000_000
MAIN, ENGINE = 1, 2                 # the main thread, the autograd engine's
# the spans each cell's program opens that its stages are read by
SPANS = {"gmflow.train-b16": ("ofd.train.forward", "ofd.train.loss",
                              "ofd.train.backward", "ofd.sync.nan_check",
                              "ofd.train.optimizer"),
         "raft-basic.infer-b8": ("ofd.infer.upload", "ofd.raft.fnet",
                                 "ofd.raft.cnet", "ofd.raft.corr_pyramid",
                                 "ofd.raft.update", "ofd.raft.upsample",
                                 "ofd.sync.download")}


class _E:
    """A kineto event: kind, name, start and end in ms, on the card or on
    a host thread, with its correlation ids."""

    def __init__(self, kind, name, start, end, cuda=False, tid=MAIN,
                 corr=0, linked=0):
        self._k, self._n = kind, name
        self._s, self._e = int(start * MS), int(end * MS)
        self._d = "DeviceType.CUDA" if cuda else "DeviceType.CPU"
        self._tid, self._corr, self._linked = tid, corr, linked

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def _span(name, start, end, tid=MAIN, corr=0):
    return _E("user_annotation", name, start, end, tid=tid, corr=corr)


def _launch(start, corr, tid=MAIN):
    return _E("cuda_runtime", "cudaLaunchKernel", start, start + 0.1,
              tid=tid, corr=corr)


def _kernel(name, start, end, corr, linked=0, kind="kernel"):
    return _E(kind, name, start, end, cuda=True, corr=corr, linked=linked)


def _frame():
    """The window, one unit, and the benchmark's own spans."""
    return [_span(trace.WINDOW, 0, 100), _span(trace.UNIT, 0, 100)]


def _step():
    """One training step: the forward's gemm (linked to its op), a flash
    backward kernel launched on the engine thread inside its op span, a
    convolution backward on the engine thread outside any span of its own,
    the NaN check's copy, an Adam kernel linked by its runtime call alone,
    a kernel launched after every span closed, a memset linked to
    nothing."""
    return _frame() + [
        _span("ofd.train.forward", 0, 20, corr=1),
        _span("ofd.train.backward", 20, 60, corr=2),
        _span("ofd.sync.nan_check", 60, 65, corr=3),
        _span("ofd.train.optimizer", 65, 90, corr=4),
        _span("ofd.op.flash_bwd", 30, 41, tid=ENGINE, corr=21),
        _E("cpu_op", "aten::mm", 2, 4, corr=11),
        _launch(3, 101),
        _kernel("sm90_gemm", 5, 15, 101, linked=11),
        _launch(31, 102, tid=ENGINE),
        _kernel("void sm90::flash_bwd_dq_wgmma<128>", 32, 40, 102,
                linked=21),
        _E("cpu_op", "aten::convolution_backward", 44, 46, tid=ENGINE,
           corr=12),
        _launch(45, 103, tid=ENGINE),
        _kernel("cudnn_conv_bwd", 45, 55, 103, linked=12),
        _E("cuda_runtime", "cudaMemcpyAsync", 60.2, 61.2, corr=104),
        _kernel("Memcpy DtoH (Device -> Pageable)", 60.3, 61, 104,
                kind="gpu_memcpy"),
        _launch(69, 105),
        _kernel("multi_tensor_apply_kernel", 70, 80, 105),
        _launch(92, 106),
        _kernel("stray", 92.5, 95, 106),
        _kernel("Memset (Device)", 96, 96.5, 999, kind="gpu_memset")]


def test_bench_spans_give_kernels_to_the_innermost_span_across_threads():
    sp = spans.Spans(_step())
    assert sp.found and sp.spans["ofd.train.backward"] == 1
    assert dict(sp.links) == {"op": 3, "runtime": 3, "none": 1}
    assert sp.under["ofd.train.forward"] == pytest.approx(0.010)
    # the engine thread's flash kernel is its op's and under the main
    # thread's backward; the convolution, launched on the engine thread
    # with no span open there, goes to the backward on the main thread
    assert sp.under["ofd.train.backward"] == pytest.approx(0.018)
    assert sp.own["ofd.op.flash_bwd"] == pytest.approx(0.008)
    assert sp.own["ofd.train.backward"] == pytest.approx(0.010)
    assert sp.under["ofd.sync.nan_check"] == pytest.approx(0.0007)
    assert sp.own["ofd.train.optimizer"] == pytest.approx(0.010)
    assert sp.under_s("ofd.train.forward", "ofd.train.backward") \
        == pytest.approx(0.028)
    assert sp.under_s("ofd.raft.update") is None


def test_bench_spans_count_kernels_under_no_span_as_unattributed():
    sp = spans.Spans(_step())
    # the kernel launched after the optimizer closed, and the memset that
    # no host call launched
    assert sp.unattributed_s == pytest.approx(0.0025 + 0.0005)
    assert sum(sp.own.values()) + sp.unattributed_s == pytest.approx(
        trace.Summary(_step()).busy_s)


def test_bench_spans_take_the_linked_range_only_where_it_holds_the_launch():
    """A linked id that names a host range started after the kernel (the
    op ids and the runtime's count apart) is not a link: the runtime's
    call is, and its thread's spans."""
    ev = _frame() + [_span("ofd.a", 0, 50, corr=1),
                     _span("ofd.b", 60, 90, corr=2),
                     _launch(10, 7),
                     _kernel("k", 11, 20, 7, linked=2)]
    sp = spans.Spans(ev)
    assert dict(sp.links) == {"runtime": 1}
    assert sp.own == {"ofd.a": pytest.approx(0.009)}


def test_bench_sync_idle_counts_only_gaps_opening_inside_a_sync_span():
    sp = spans.Spans(_step())
    # 61 -> 70 opens in the NaN check; 0 -> 5 and 15 -> 32 (forward), 40
    # -> 45 and 55 -> 60.3 (backward), 80 -> 92.5 (optimizer), 95 -> 96
    # and 96.5 -> 100 (no span) do not
    assert sp.sync_idle_s == pytest.approx(0.009)
    no_sync = [e for e in _step() if e.name() != "ofd.sync.nan_check"]
    assert spans.Spans(no_sync).sync_idle_s == 0.0


def test_bench_spans_find_nothing_without_program_spans():
    """A trace without ``ofd.*`` spans (a program that opens none) holds
    no span, and the report reads null for it."""
    bare = [e for e in _step() if not e.name().startswith("ofd.")]
    sp = spans.Spans(bare)
    assert not sp.found and sp.under_s("ofd.train.forward") is None
    assert spans_report.report(bare, 2) is None


def test_bench_spans_against_stems():
    """The kernels under an op's span against ``readers``' stems: the same
    set here, and what each side alone holds where they differ."""
    sp = spans.Spans(_step())
    same = sp.against_stems("ofd.op.flash_bwd", readers.FLASH_BWD)
    assert same["span_s"] == same["stem_s"] == pytest.approx(0.008)
    assert same["span_only"] == {} and same["stem_only"] == {}
    other = sp.against_stems("ofd.train.backward", ("cudnn",))
    assert other["stem_s"] == pytest.approx(0.010)
    assert set(other["span_only"]) == {"void sm90::flash_bwd_dq_wgmma<128>"}
    assert other["stem_only"] == {}
    assert sp.against_stems("ofd.train.forward", ("flash_fwd_",)) == {
        "span_s": pytest.approx(0.010), "stem_s": 0,
        "span_only": {"sm90_gemm": [pytest.approx(0.010), 1]},
        "stem_only": {}}


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_bench_spans_in_a_traced_cpu_run(tmp_path, workload):
    """The small cell traced on the CPU: the program opens the spans its
    stages are read by, inside the window, and the report reads them (0:
    no kernels on a CPU); the run's own line is whole."""
    root = tiny.make_tree(tmp_path)
    result, summary, events = spans_report.traced(
        root, workload, 5, 0.5, "cpu", time.perf_counter())
    assert result["correct"]
    line = spans_report.report(events, summary.units * 2)
    for name in SPANS[workload]:
        assert line["opened"][name] >= summary.units, name
        assert line["under_ms_per_pair"].get(name, 0.0) == 0.0, name
    assert line["sync_idle_ms_per_pair"] == 0.0
