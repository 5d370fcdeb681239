"""The port's profiling scopes, function tracing, memory ledger and
timing fence (hymls_tpu_torch/utils/timings.py): tests/test_timings.py
on the port, `sync` on a nested tree of tensors, and the device report
of a process that never used a card."""
import pytest
import torch

from hymls_tpu_torch.utils import timings


def test_prof_scope_accumulates():
    with timings.prof("unit-test-scope", level=1):
        pass
    t = timings._prof_timer()
    assert t.count("unit-test-scope") >= 1
    assert "unit-test-scope" in timings.print_timing()


def test_prof_level_gating(monkeypatch):
    monkeypatch.setattr(timings, "TIMING_LEVEL", 1)
    monkeypatch.setattr(timings, "FUNCTION_TRACING", False)
    before = timings._prof_timer().count("gated-scope")
    with timings.prof("gated-scope", level=3):
        pass
    assert timings._prof_timer().count("gated-scope") == before


def test_function_tracing_prints(monkeypatch, capsys):
    monkeypatch.setattr(timings, "FUNCTION_TRACING", True)

    @timings.profiled("traced-fn", level=1)
    def f():
        return 7

    assert f() == 7
    err = capsys.readouterr().err
    assert ">> traced-fn" in err and "<< traced-fn" in err


def test_sync_fences_nested_trees():
    """sync() walks dicts, lists and tuples, skips CPU tensors, empty
    tensors and non-tensors, and returns its argument."""
    tree = {"a": torch.ones(3, 2),
            "b": [torch.zeros(4), None, 7, "s", (torch.arange(3),)],
            "empty": torch.zeros(0),
            "levels": [{"A11inv": torch.eye(2)}]}
    assert timings.sync(tree) is tree
    x = torch.arange(5.0)
    assert timings.sync(x) is x
    assert timings.sync(None) is None


def test_sync_waits_for_the_card(monkeypatch):
    """Each CUDA device of the tree is synchronized once; CPU leaves
    ask for nothing (a stand-in tensor class plays the CUDA tensor)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))

    class FakeCuda(torch.Tensor):
        is_cuda = True

        @property
        def device(self):
            return torch.device("cuda", 0)

    a = torch.ones(2).as_subclass(FakeCuda)
    b = torch.ones(3).as_subclass(FakeCuda)
    tree = {"f": [a, {"g": (b, torch.ones(1))}]}
    assert timings.sync(tree) is tree
    assert calls == [torch.device("cuda", 0)]
    calls.clear()
    timings.sync({"cpu": torch.ones(4)})
    assert calls == []


@pytest.mark.cuda
def test_sync_and_scope_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2048, 2048, device="cuda")
    t = timings.Timer("card")
    with t.scope("matmul"):
        y = x @ x
    assert timings.sync({"y": [y]})["y"][0] is y
    assert t.count("matmul") == 1
    assert "cuda:0" in timings.device_memory_report()


def test_host_memory_ledger():
    timings.start_memory("phase-x")
    blob = bytearray(8 << 20)          # ~8 MB
    timings.stop_memory("phase-x")
    rep = timings.host_memory_report()
    assert "RSS" in rep and "phase-x" in rep
    del blob


def test_device_report_without_a_card_in_use(monkeypatch):
    """A process that never initialized CUDA gets a line saying so, and
    the report initializes nothing."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    rep = timings.device_memory_report()
    assert rep == "Device memory:\n  no CUDA device in use by this process"
