"""The benchmark's arithmetic: rates over the window, percentiles over
every sample, K1's bytes and the idle union, on synthetic inputs."""
import numpy as np
import pytest

from portbench import harness, kernels, stats, trace


def test_percentile_takes_every_sample():
    rng = np.random.default_rng(3)
    for n in (1, 2, 9, 100, 101):
        v = rng.exponential(size=n).tolist()
        for q in (50, 90, 95):
            assert stats.percentile(v, q) == pytest.approx(
                np.percentile(v, q), rel=1e-15)
    v = [1.0] * 90 + [5.0] * 10
    assert stats.percentile(v, 90) == pytest.approx(1.4)
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_rate_is_window_over_count():
    assert stats.rate_s(10.0, 4) == 2.5
    with pytest.raises(ValueError):
        stats.rate_s(10.0, 0)


def test_end_to_end_names():
    d = [0.1 * i for i in range(1, 11)]
    assert harness.end_to_end("step_s", "step", 12.0, d) == 1.2
    assert harness.end_to_end("step_p90_s", "step", 12.0, d) == \
        pytest.approx(np.percentile(d, 90))
    assert harness.end_to_end("solve_p50_s", "solve", 1.0, d) == \
        pytest.approx(np.percentile(d, 50))
    for bad in ("solve_s", "step_px_s", "step_p90"):
        with pytest.raises(KeyError):
            harness.end_to_end(bad, "step", 1.0, d)


def test_k1_bytes_and_bands():
    assert kernels.k1_bytes(49152, 19, 4) == 19 * 49152 * 4 + 76 + \
        2 * 49152 * 4
    assert kernels.k1_bytes(10, 3, 8) == 240 + 12 + 160
    from portbench.matrices import stokes_c_2d
    from hymls_tpu_torch.ops.spmv import make_operator
    K = stokes_c_2d.cavity_jacobian(16, 16, 1000.0)
    op = make_operator(K, dtype=__import__("torch").float64, device="cpu")
    assert kernels.dia_bands(K.indptr, K.indices) == len(op.offsets)


def test_k1_rate_is_bytes_over_device_time():
    from types import SimpleNamespace
    from portbench.harness import reader
    from portbench.tests.helpers import ROOT
    read = reader(ROOT + "/portbench", "k1_gbps.resolve")
    dev = [(0, 2000, "void dia_spmv_kernel<float, 4>(...)"),
           (5000, 9000, "void dia_spmv_kernel<double, 4>(...)"),
           (9000, 99000, "sgemm")]
    rec = SimpleNamespace(trace=trace.Trace(dev, {}, 0, 99000), cuda=True,
                          k1={"n": 1000, "bands": 5})
    nbytes = kernels.k1_bytes(1000, 5, 4) + kernels.k1_bytes(1000, 5, 8)
    assert read(rec) == pytest.approx(nbytes / 6000)  # bytes/ns = GB/s
    rec.trace = trace.Trace(dev[2:], {}, 0, 99000)
    assert read(rec) is None


def test_idle_union_and_gaps():
    dev = [(10, 20, "a"), (15, 30, "b"), (40, 50, "a"), (95, 120, "c")]
    assert trace.merged(dev, 0, 100) == [(10, 30), (40, 50), (95, 100)]
    assert trace.busy_ns(dev, 0, 100) == 20 + 10 + 5
    assert trace.gaps(dev, 0, 100) == [(0, 10), (30, 40), (50, 95)]
    assert trace.busy_ns([], 0, 100) == 0
    tr = trace.Trace(dev, {"call": [(0, 100)], "solve": [(25, 100)],
                           "apply": [(30, 45)]}, 0, 100)
    idle = trace.idle_by_span(tr)
    # gap (0, 10): call; (30, 40): apply; (50, 95): solve
    assert idle == pytest.approx({"call": 10e-9, "apply": 10e-9,
                                  "solve": 45e-9})
    assert trace.top_ops(tr)[0] == ["a", pytest.approx(20e-9)]
    assert [n for n, _ in trace.top_ops(tr)] == ["a", "b", "c"]


def test_every_seed_gets_the_same_set_in_its_own_order():
    from portbench import inputs
    from portbench.matrices import stokes_c_2d
    fam = stokes_c_2d.family({"nx": 8, "ny": 8, "reynolds": 1000.0})
    mix = {"factor": "compute", "theta_range": [0.95, 1.05], "set_size": 5,
           "set_seed": 3}
    a, b = inputs.Pool(fam, mix, 1), inputs.Pool(fam, mix, 2 ** 31 + 9)
    ka = [a.index(k) for k in range(15)]
    kb = [b.index(k) for k in range(15)]
    assert ka != kb
    for p in range(3):  # each pass is a permutation of the set
        assert sorted(ka[5 * p:5 * p + 5]) == list(range(5))
    assert sorted(a.set_thetas) == sorted(b.set_thetas)
    assert ka == [inputs.Pool(fam, mix, 1).index(k) for k in range(15)]
    for k in range(5):
        K = a.mat(k)
        assert np.allclose(K.toarray(), a.matrix(a.set_thetas[ka[k]])
                           .toarray())
        x = np.linalg.lstsq(K.toarray(), a.rhs(k), rcond=None)[0]
        assert np.linalg.norm(K @ x - a.rhs(k)) < 1e-8 * np.linalg.norm(
            a.rhs(k))
    assert 950 <= min(a.set_thetas) and max(a.set_thetas) <= 1050


def test_solves_and_scales_of_a_mix():
    from portbench import inputs
    from portbench.matrices import stokes_c_2d
    fam = stokes_c_2d.family({"nx": 8, "ny": 8, "reynolds": 1000.0})
    mix = {"factor": "compute", "solves": 2, "scales": [1.0, 0.5],
           "theta_range": [0.95, 1.05], "set_size": 3, "set_seed": 3}
    p = inputs.Pool(fam, mix, 7)
    for k in range(6):
        th, s = p.set_thetas[p.index(k)], [1.0, 0.5][k % 2]
        K = p.mat(k)
        assert np.allclose(K.toarray(), s * p.matrix(th).toarray())
        b0, b1 = p.rhs(k, 0), p.rhs(k, 1)
        assert not np.allclose(b0, b1)
        for b in (b0, b1):  # b lies in K's range: b = K x
            x = np.linalg.lstsq(K.toarray(), b, rcond=None)[0]
            assert np.linalg.norm(K @ x - b) < 1e-8 * np.linalg.norm(b)
    # factored once in set-up: one matrix, at the configuration's theta
    q = inputs.Pool(fam, dict(mix, factor="setup"), 7)
    assert all(q.mat(k) is q.setup_matrix() for k in range(6))
    assert np.allclose(q.setup_matrix().toarray(),
                       q.matrix(fam["theta"]).toarray())
    with pytest.raises(ValueError):
        inputs.Pool(fam, dict(mix, factor="sometimes"), 7)
