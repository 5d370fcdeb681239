"""The coarse solve's reader, `coarse_inv_share`, on synthetic counter
snapshots: nothing without the program's coarse counters, else the
inverse's share of the coarse factorizations."""
import os
import sys
import types

import pytest

from portbench.harness import reader
from portbench.tests.helpers import ROOT

KEY = "hymls_tpu_torch.utils.timings"


def snapshot(counts):
    return types.SimpleNamespace(counter_snapshot=lambda: dict(counts))


@pytest.mark.parametrize("name", ["coarse_inv_share.newton",
                                  "coarse_inv_share.resolve"])
def test_reads_nothing_without_the_counters(name, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), name)
    monkeypatch.delitem(sys.modules, KEY, raising=False)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, KEY, types.SimpleNamespace())
    assert read(None) is None
    monkeypatch.setitem(sys.modules, KEY, snapshot(
        {"hymls.apply.eager": 3, "hymls.compute.calls": 2}))
    assert read(None) is None


@pytest.mark.parametrize("counts,share", [
    ({"hymls.coarse.inverse": 4}, 1.0),
    ({"hymls.coarse.inverse": 3, "hymls.coarse.lu": 3}, 0.5),
    ({"hymls.coarse.lu": 2}, 0.0)])
def test_share_of_a_snapshot(counts, share, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), "coarse_inv_share.resolve")
    monkeypatch.setitem(sys.modules, KEY, snapshot(counts))
    assert read(None) == share
