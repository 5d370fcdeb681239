"""The Krylov layer's reader, `gmres_graph_share`, on synthetic counter
snapshots: nothing without the program's GMRES graph counters, else the
replayed iterations' share of all iterations."""
import os
import sys
import types

import pytest

from portbench.harness import reader
from portbench.tests.helpers import ROOT

KEY = "hymls_tpu_torch.utils.timings"
NAMES = ["gmres_graph_share.newton", "gmres_graph_share.resolve"]


def snapshot(counts):
    return types.SimpleNamespace(counter_snapshot=lambda: dict(counts))


@pytest.mark.parametrize("name", NAMES)
def test_reads_nothing_without_the_counters(name, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), name)
    monkeypatch.delitem(sys.modules, KEY, raising=False)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, KEY, types.SimpleNamespace())
    assert read(None) is None
    # the parent's counters: iterations and applies, no GMRES graphs
    monkeypatch.setitem(sys.modules, KEY, snapshot(
        {"hymls.gmres.iters": 90, "hymls.apply.graph_replays": 91}))
    assert read(None) is None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counts,share", [
    ({"hymls.gmres.graph_replays": 90, "hymls.gmres.graph_captures": 30},
     1.0),
    ({"hymls.gmres.graph_replays": 90, "hymls.gmres.eager": 30}, 0.75),
    ({"hymls.gmres.eager": 12, "hymls.gmres.iters": 12}, 0.0)])
def test_share_of_a_snapshot(name, counts, share, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), name)
    monkeypatch.setitem(sys.modules, KEY, snapshot(counts))
    assert read(None) == share
