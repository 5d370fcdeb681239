"""The benchmark's frozen generator copies equal the port's generators,
and each configuration file keeps its upstream XML but for what it lists
under `assumed`."""
import json
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from hymls_tpu_torch import Params
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian
from portbench.matrices import stokes_c_2d as frozen
from portbench.tests.helpers import ROOT


def same(A, B):
    return (np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices)
            and np.array_equal(A.data, B.data))


@pytest.mark.parametrize("nx", [16, 32])
@pytest.mark.parametrize("re", [0.0, 1000.0])
def test_cavity_jacobian_equals_the_ports(nx, re):
    assert same(frozen.cavity_jacobian(nx, nx, re),
                cavity_jacobian(nx, nx, re=re).tocsr())


@pytest.mark.parametrize("nx", [16, 32])
def test_stokes_and_testvector_equal_the_ports(nx):
    p = Params({"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                            "nx": nx, "ny": nx}})
    K = create_matrix(p)
    assert same(frozen.stokes2d(nx, nx), K)
    np.testing.assert_array_equal(frozen.testvector(K),
                                  create_testvector(p, K))


@pytest.mark.parametrize("re", [0.0, 1000.0])
def test_family_spans_the_jacobians(re):
    fam = frozen.family({"nx": 16, "ny": 16, "reynolds": re})
    K = frozen.cavity_jacobian(16, 16, re)
    np.testing.assert_array_equal(fam["indices"], K.indices)
    np.testing.assert_allclose(fam["v0"] + re * fam["v1"], K.data,
                               rtol=1e-14, atol=1e-12)
    K0 = frozen.cavity_jacobian(16, 16, 0.0)
    rows = np.repeat(np.arange(fam["n"]), np.diff(fam["indptr"]))
    dense0 = np.zeros((fam["n"], fam["n"]))
    dense0[rows, fam["indices"]] = fam["v0"]
    np.testing.assert_array_equal(dense0, K0.toarray())


def xml_lists(path):
    """{list name: {parameter: value}} of the XML's top-level lists, the
    values in their declared types."""
    conv = {"int": int, "double": float, "bool": lambda v: v == "true",
            "string": str}

    def read(el):
        out = {}
        for ch in el:
            if ch.tag == "ParameterList":
                out[ch.get("name")] = read(ch)
            else:
                out[ch.get("name")] = conv[ch.get("type")](ch.get("value"))
        return out
    return read(ET.parse(path).getroot())


@pytest.mark.parametrize("name", ["cavity128_Re1000", "stokes2_128_L3"])
def test_config_is_its_xml_but_for_what_it_assumes(name):
    d = os.path.join(ROOT, "portbench", "configs")
    with open(os.path.join(d, name + ".json")) as f:
        cfg = json.load(f)
    src = xml_lists(os.path.join(d, cfg["upstream_xml"]))
    assumed = set(cfg["assumed"])

    def walk(a, b):
        for k in set(a) | set(b):
            if k in assumed:
                continue
            assert k in a and k in b, k
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert a[k] == b[k], k
    walk({k: src[k] for k in cfg["params"]}, cfg["params"])
    assert cfg["matrix"]["nx"] == src["Problem"]["nx"]
    assert cfg["reduced"] == []
