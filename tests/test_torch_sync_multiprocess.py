"""The port's sync in a real world of two processes: gloo on the CPU.

Two OS processes (``tests/torch_sync_worker.py``) join one ``torch.distributed`` world and drive
the production path: ``Metric.compute`` -> ``sync`` -> ``process_sync`` -> ``gather_all_arrays``
-> the gloo all-gather, and ``sync_state``'s collectives. Modelled on the JAX package's
``tests/unittests/bases/test_multiprocess_sync.py`` (its six cases, ``:69-93``), plus an idle rank,
``sync_state``, Pearson through ``compute()``, path A's collection with its compute group, and
``MeanMetric``'s weighted mean. Each worker's process group times out after 60 s, and the harness
kills both workers and fails after 120 s, so a hang costs one test; ``test_a_dead_worker_fails_fast``
shows that a world whose rank 1 dies ends well inside that limit.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

WORLD = 2
LIMIT_S = 120
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sync_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(mode: str):
    """Run both ranks; ``[(returncode, stdout, stderr)]`` by rank. Kills both and fails the test
    when they have not ended after ``LIMIT_S`` seconds."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, _WORKER, address, str(rank), str(WORLD), mode], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True) for rank in range(WORLD)]
    deadline = time.monotonic() + LIMIT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        pytest.fail(f"the two-process sync world did not end within {LIMIT_S} s; both workers killed")
    return outs


@pytest.fixture(scope="module")
def results():
    outs = run_world("all")
    by_rank = {}
    for code, out, err in outs:
        if code != 0:
            pytest.fail(f"worker failed rc={code}\nstdout:\n{out}\nstderr:\n{err[-4000:]}")
        line = next(line for line in out.splitlines() if line.startswith("RESULT "))
        r = json.loads(line[len("RESULT "):])
        by_rank[r["rank"]] = r
    return by_rank


def test_world_formed(results):
    assert set(results) == {0, 1}
    for r in results.values():
        assert r["world"] == WORLD and r["available"] is True


def test_gather_uneven_shapes(results):
    for r in results.values():
        assert r["gather_uneven"] == [[0.0], [10.0, 11.0]]
        assert r["shapes"] == [[1, 2], [2, 2]]


def test_gather_even_shapes_scalars_and_bools(results):
    for r in results.values():
        assert r["gather_even"] == [[0.0, 0.0], [1.0, 1.0]]
        assert r["gather_scalar"] == [0.0, 1.0]
        assert r["gather_bool"] == [[True, False], [True, True]]


def test_gather_ranks_of_different_ndim(results):
    """An empty (0,) float32 placeholder against (3, 8) int64: the empty piece takes the dtype and
    trailing shape of the rank that has rows."""
    for r in results.values():
        assert r["gather_ndim"] == [[[0, 8], "torch.int64"], [[3, 8], "torch.int64"]]


def test_sum_state_reduces(results):
    for r in results.values():
        assert r["sum_metric"] == 3.0
        assert r["sum_cached"] == 3.0
        assert r["sum_local_after"] == float(r["rank"] + 1)  # unsync put the local state back


def test_uneven_cat_state(results):
    for r in results.values():
        assert r["cat_metric"] == [0.0, 1.0, 100.0, 101.0, 102.0]


def test_idle_rank(results):
    """Rank 1 never updated: it still joins every gather, and both ranks see rank 0's data."""
    for r in results.values():
        assert r["idle_cat"] == [1.0, 2.0, 3.0]
        np.testing.assert_allclose(r["map"], r["map_full"], rtol=1e-5)


def test_sharded_accuracy_matches_full_pass(results):
    for r in results.values():
        np.testing.assert_allclose(r["accuracy"], r["accuracy_full"], atol=1e-6)
    assert results[0]["accuracy"] == results[1]["accuracy"]


def test_collection_with_compute_group(results):
    for r in results.values():
        assert r["groups"] == [["MulticlassAccuracy", "MulticlassPrecision", "MulticlassF1Score"]]
        assert r["world_consistent"] == "full"
        for k, v in r["collection_full"].items():
            np.testing.assert_allclose(r["collection"][k], v, rtol=1e-6)
    assert results[0]["collection"] == results[1]["collection"]


def test_pearson_through_compute(results):
    for r in results.values():
        np.testing.assert_allclose(r["pearson"], r["pearson_full"], rtol=1e-5)
    assert results[0]["pearson"] == results[1]["pearson"]


def test_mean_metric_weighted_mean(results):
    for r in results.values():
        assert r["mean"] == 4.0


def test_sync_state(results):
    for r in results.values():
        s = r["sync_state"]
        assert s["counts"] == [3, 30] and r["sync_state_dtypes"]["counts"] == "torch.int64"
        np.testing.assert_allclose(s["total"], [0.3, 5.0], rtol=1e-6)
        assert s["avg"] == 0.5
        assert s["hi"] == [1, 0] and r["sync_state_dtypes"]["hi"] == "torch.int32"
        assert s["lo"] == [0.0, -1.0]
        assert s["seen"] == [0, 1, 2, 3]
        assert s["stack"] == [[0.0, 5.0], [1.0, 5.0]]
        assert s["folded"] == [2.0, 1.0]
        assert s["flags"] == [True, True] and r["sync_state_dtypes"]["flags"] == "torch.bool"
        assert s["entries"] == [[0, 10, 1, 11]]
        assert s["none"] == []
        assert r["sync_state_input_kept"]


def test_a_dead_worker_fails_fast():
    """Rank 1 exits after joining: rank 0's first collective raises, and the world ends well
    inside the harness's limit instead of hanging."""
    t0 = time.monotonic()
    outs = run_world("die")
    assert time.monotonic() - t0 < LIMIT_S
    assert outs[1][0] == 3
    assert outs[0][0] != 0 and "RESULT" not in outs[0][1]
