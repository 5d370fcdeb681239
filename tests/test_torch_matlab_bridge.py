"""The port's MATLAB bridge (hymls_tpu_torch/matlab_bridge.py), driven
through its file-RPC protocol as matlab/HYMLS.m drives it, with the
server in a subprocess on the CPU: init, apply, an unknown command,
set_border, compute and free, each apply against the JAX package's
in-process preconditioner to 1e-10.

A torch server starts in a few seconds, so this runs in tier-1.  Every
wait is bounded (the client's, the process waits) and the server is
killed on the way out, so the test cannot hang the suite."""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio

import hymls_tpu as H
from hymls_tpu_torch.config import Params, save_xml
from hymls_tpu_torch.matlab_bridge import BridgeClient
from hymls_tpu_torch.stencils import create_matrix, create_testvector

from _torch_parity import rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60


@pytest.fixture
def bridge(tmp_path):
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 16, "ny": 16},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": 2},
    })
    K = create_matrix(params).tocsr()
    sio.mmwrite(str(tmp_path / "A.mtx"), K)
    save_xml(params, str(tmp_path / "params.xml"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hymls_tpu_torch.matlab_bridge",
         str(tmp_path), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        cli = BridgeClient(str(tmp_path), proc, timeout=WAIT_S)
        cli.wait(str(tmp_path / "server.ready"))
        yield cli, params, K
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_bridge_session_matches_reference(bridge):
    cli, params, K = bridge
    n = K.shape[0]
    resp = cli.rpc({"cmd": "init", "matrix": "A.mtx",
                    "params": "params.xml"})
    assert resp["n"] == n and resp["nnz"] == K.nnz

    # the reference: the same matrix, parameters and test vector
    hp = H.Params(params.to_dict())
    P = H.Preconditioner(K, hp, testvector=create_testvector(params, K))
    P.compute()

    def ref_apply(X):
        return np.stack([np.asarray(P.apply_inverse(X[:, j]))
                         for j in range(X.shape[1])], axis=1)

    X = np.random.default_rng(0).standard_normal((n, 2))
    Y = cli.apply(X)
    assert Y.shape == X.shape
    assert rel(ref_apply(X), Y) <= 1e-10

    # an unknown command reports an error and the server keeps serving
    bad = cli.send({"cmd": "nope"})
    assert not bad["ok"] and "nope" in bad["error"]

    # a border (the constant vector): applies solve with a zero border
    # right-hand side, as the reference's
    v = np.ones((n, 1)) / np.sqrt(n)
    sio.mmwrite(os.path.join(cli.dir, "v.mtx"), v)
    cli.rpc({"cmd": "set_border", "v": "v.mtx"})
    P.set_border(v)
    P.compute()
    assert rel(ref_apply(X), cli.apply(X)) <= 1e-10

    # new values, same pattern
    K2 = (K * 1.5).tocsr()
    sio.mmwrite(os.path.join(cli.dir, "A2.mtx"), K2)
    cli.rpc({"cmd": "compute", "matrix": "A2.mtx"})
    P.compute(K2)
    assert rel(ref_apply(X), cli.apply(X)) <= 1e-10

    assert cli.rpc({"cmd": "free"})["bye"] is True
    assert cli.proc.wait(timeout=WAIT_S) == 0


def test_bridge_refuses_a_missing_card(tmp_path, monkeypatch, capsys):
    """Without a card and without --device cpu the server exits non-zero
    and names the device; it does not fall back to the CPU."""
    import torch
    from hymls_tpu_torch.matlab_bridge import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([str(tmp_path)]) != 0
    err = capsys.readouterr().err
    assert "'cuda'" in err and "--device cpu" in err
    assert not (tmp_path / "server.ready").exists()
