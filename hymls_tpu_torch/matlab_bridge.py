"""MATLAB bindings bridge (reference matlab/HYMLS.m + HYMLS_init/
apply/set_border/free MEX files, reference matlab/HYMLS_init.cpp:14-91).

The reference builds MEX binaries against a serial Epetra; here the
same four-call API (init / apply / set_border / free) is served by a
persistent Python process speaking a file-based RPC protocol, so the
MATLAB side needs no compiled extension — matlab/HYMLS.m writes the
sparse matrix via MatrixMarket and polls for responses.

Protocol (one session directory per HYMLS object):
  client writes  <seq>.req.json   {"cmd": ..., ...}   (after data files)
  server writes  <seq>.resp.json  {"ok": true, ...}   (after data files)

Commands:
  init       {"matrix": "A.mtx", "params": "params.xml"} -> handle
  apply      {"x": "x.mtx", "y": "y.mtx"}   y = P^{-1} x  (multi-vector)
  set_border {"v": "v.mtx", "w": "w.mtx"?}
  compute    {"matrix": "A2.mtx"?}          re-factor (same pattern)
  free       {}                             shuts the server down

Start:  python -m hymls_tpu_torch.matlab_bridge <session_dir> [--device cpu]

Torch counterpart of hymls_tpu/matlab_bridge.py: the same protocol and
commands; the preconditioner lives on the card unless `--device cpu`
asks for the CPU, and `apply` returns host (numpy) arrays to the client.
matlab/HYMLS.m starts hymls_tpu.matlab_bridge; point its server command
at this module to serve from the card.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch


POLL_S = 0.02


class BridgeServer:
    def __init__(self, session_dir: str, device="cuda"):
        self.dir = session_dir
        self.device = torch.device(device)
        self.precond = None
        self.params = None
        self.K = None

    # -- command handlers ---------------------------------------------------
    def cmd_init(self, req):
        import scipy.sparse as sp

        from .config import Params
        from .core.preconditioner import Preconditioner
        from .stencils import create_testvector
        from .utils.io import read_matrix

        K = read_matrix(os.path.join(self.dir, req["matrix"])).tocsr()
        pfile = req.get("params")
        if pfile:
            p = pfile if os.path.isabs(pfile) else \
                os.path.join(self.dir, pfile)
            from .config import load_xml
            self.params = load_xml(p)
        else:
            self.params = Params({})
        self.K = K
        tv = create_testvector(self.params, K)
        self.precond = Preconditioner(K, self.params, testvector=tv,
                                      device=self.device).compute()
        return {"n": K.shape[0], "nnz": int(K.nnz)}

    def cmd_apply(self, req):
        from .utils.io import read_multivector, write_multivector

        x = read_multivector(os.path.join(self.dir, req["x"]))
        x = np.atleast_2d(np.asarray(x))
        if x.shape[0] == 1 and self.K.shape[0] != 1:
            x = x.T
        cols = [self.precond.apply_inverse(x[:, j]).cpu().numpy()
                for j in range(x.shape[1])]
        y = np.stack(cols, axis=1)
        write_multivector(os.path.join(self.dir, req["y"]), y)
        return {}

    def cmd_set_border(self, req):
        from .utils.io import read_multivector

        v = np.asarray(read_multivector(os.path.join(self.dir, req["v"])))
        w = None
        if req.get("w"):
            w = np.asarray(read_multivector(
                os.path.join(self.dir, req["w"])))
        self.precond.set_border(v, w)
        self.precond.compute()
        return {}

    def cmd_compute(self, req):
        from .utils.io import read_matrix

        K = None
        if req.get("matrix"):
            K = read_matrix(os.path.join(self.dir, req["matrix"])).tocsr()
            self.K = K
        self.precond.compute(K)
        return {}

    def cmd_free(self, req):
        self.precond = None
        return {"bye": True}

    # -- server loop --------------------------------------------------------
    def serve(self):
        os.makedirs(self.dir, exist_ok=True)
        # readiness marker for the client
        with open(os.path.join(self.dir, "server.ready"), "w") as f:
            f.write(str(os.getpid()))
        seq = 0
        while True:
            req_path = os.path.join(self.dir, f"{seq}.req.json")
            while not os.path.exists(req_path):
                time.sleep(POLL_S)
            # the writer creates "<seq>.req.done" after the json is
            # fully written (file appearance is not atomic on all
            # filesystems MATLAB runs on)
            done = os.path.join(self.dir, f"{seq}.req.done")
            while not os.path.exists(done):
                time.sleep(POLL_S)
            with open(req_path) as f:
                req = json.load(f)
            cmd = req.get("cmd", "")
            try:
                handler = getattr(self, f"cmd_{cmd}", None)
                if handler is None:
                    raise ValueError(f"unknown command {cmd!r}")
                out = handler(req)
                out["ok"] = True
            except Exception as e:          # report, keep serving
                out = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
            resp = os.path.join(self.dir, f"{seq}.resp.json")
            with open(resp + ".tmp", "w") as f:
                json.dump(out, f)
            os.replace(resp + ".tmp", resp)
            if cmd == "free":
                return
            seq += 1


class BridgeClient:
    """The client side of the protocol, as matlab/HYMLS.m speaks it, for
    Python callers.  `proc` is the server's Popen with its output piped:
    its exit ends a wait early, and every wait gives up after `timeout`
    seconds."""

    def __init__(self, session_dir: str, proc, timeout: float = 300.0,
                 poll: float = 0.005):
        self.dir, self.proc = session_dir, proc
        self.timeout, self.poll, self.seq = timeout, poll, 0

    def wait(self, path: str) -> None:
        t0 = time.monotonic()
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                raise RuntimeError(f"bridge server exited "
                                   f"({self.proc.returncode}) before "
                                   f"writing {path}:\n"
                                   f"{self.proc.stdout.read()[-4000:]}")
            if time.monotonic() - t0 > self.timeout:
                raise TimeoutError(f"bridge: no {path} after "
                                   f"{self.timeout} s")
            time.sleep(self.poll)

    def send(self, req: dict) -> dict:
        """One request; its response, whether it succeeded or not."""
        base = os.path.join(self.dir, str(self.seq))
        with open(base + ".req.json", "w") as f:
            json.dump(req, f)
        open(base + ".req.done", "w").close()
        self.wait(base + ".resp.json")
        with open(base + ".resp.json") as f:
            resp = json.load(f)
        self.seq += 1
        return resp

    def rpc(self, req: dict) -> dict:
        """One request; raises with the server's error unless it
        succeeded."""
        resp = self.send(req)
        if not resp.get("ok"):
            raise RuntimeError(f"bridge {req.get('cmd')}: "
                               f"{resp.get('error')}\n"
                               f"{resp.get('traceback', '')}")
        return resp

    def apply(self, x, name: str = "x.mtx", out: str = "y.mtx"):
        """y = P^{-1} x through the files `name` and `out`."""
        import scipy.io as sio
        sio.mmwrite(os.path.join(self.dir, name), x)
        self.rpc({"cmd": "apply", "x": name, "y": out})
        return np.asarray(sio.mmread(os.path.join(self.dir, out)))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m hymls_tpu_torch.matlab_bridge",
        description="Serve one HYMLS object to matlab/HYMLS.m through "
                    "files in a session directory.")
    ap.add_argument("session_dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the preconditioner (default: "
                         "cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"ERROR: device {args.device!r} requested, but no CUDA "
              f"device is available; pass --device cpu to serve from "
              f"the CPU", file=sys.stderr)
        return 2
    BridgeServer(args.session_dir, args.device).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
