"""The V-cycle apply's reader, `gather_kernel_share`, on synthetic
counter snapshots: nothing without the program's gather counters, else
the kernel's share of all gathers."""
import os
import sys
import types

import pytest

from portbench.harness import reader
from portbench.tests.helpers import ROOT

KEY = "hymls_tpu_torch.utils.timings"
NAME = "gather_kernel_share.resolve"


def snapshot(counts):
    return types.SimpleNamespace(counter_snapshot=lambda: dict(counts))


def test_reads_nothing_without_the_counters(monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), NAME)
    monkeypatch.delitem(sys.modules, KEY, raising=False)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, KEY, types.SimpleNamespace())
    assert read(None) is None
    # the parent's counters: generic applies, no gather counters
    monkeypatch.setitem(sys.modules, KEY, snapshot(
        {"hymls.apply.generic": 90, "hymls.apply.graph_replays": 89}))
    assert read(None) is None


@pytest.mark.parametrize("counts,share", [
    ({"hymls.gather.kernel": 260, "hymls.apply.generic": 90}, 1.0),
    ({"hymls.gather.kernel": 30, "hymls.gather.plain": 10}, 0.75),
    ({"hymls.gather.plain": 27}, 0.0)])
def test_share_of_a_snapshot(counts, share, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), NAME)
    monkeypatch.setitem(sys.modules, KEY, snapshot(counts))
    assert read(None) == share
