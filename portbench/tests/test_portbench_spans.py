"""portbench/spans.py's hooks around one traced run of the harness, on
the CPU at 16 x 16: the counters of the window and of the traced
stretch, the program's spans in the profile, and no device readings
without a card; the harness's own objects are back in place after."""
from portbench import harness, spans, trace
from portbench.tests.helpers import run_cpu, tiny_copy


def test_capture_reads_a_traced_run(tmp_path):
    root = tiny_copy(tmp_path)
    host_load, read = harness.HostLoad, trace.from_profiler
    cap = spans.Capture()
    undo = cap.install(harness)
    try:
        out = run_cpu(root, "cavity128_Re1000.newton", trace=True)
    finally:
        undo()
    assert harness.HostLoad is host_load and trace.from_profiler is read
    window = spans.diff(cap.marks["window_end"], cap.marks["window_start"])
    traced = spans.diff(cap.marks["trace_end"], cap.marks["window_end"])
    assert window["hymls.compute.calls"] == window["hymls.refine.solves"] \
        >= 1
    assert traced["hymls.compute.calls"] == 3             # trace_calls
    assert cap.pt is not None and not cap.pt.device
    assert spans.n_spans(cap.pt, "hymls.compute") == 3
    assert spans.n_spans(cap.pt, "hymls.apply") >= 3
    spans.annotate(out, cap, "newton")
    assert out["metrics"]["refine_passes.newton"]["value"] >= 1
    assert not {"apply_device_us.newton", "factor_syncs.newton",
                "syncs_per_iter.newton"} & set(out["metrics"])
    assert out["metrics"]["refine_passes.newton"]["value"] == \
        window["hymls.refine.passes"] / window["hymls.refine.solves"]
    assert out["correct"]
