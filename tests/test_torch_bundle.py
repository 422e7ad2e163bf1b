"""The port's post-mortem bundles (``obs/bundle.py``) against the JAX package's.

- Every required section and the metric context, and their round trip through the container.
- A section CRC violation, a container flip and a file that is not a bundle, each refused with JAX's words.
- The disabled switch, pruning to ``TM_TPU_BUNDLE_KEEP``, ``capture_dir`` and ``last_bundle_path``.
- The CLI's exit codes and output (``inspect``, ``validate``, ``diff``, ``merge-fleet``); a failed capture is a
  counted warning, never an exception; two captures inside one window share an incident; the fleet merge.
- Both ways across the packages: a bundle the port writes passes JAX's ``validate_bundle`` and ``load_bundle``,
  and one JAX writes passes the port's.
- A journal recovered through a bundle's path as cursor, in the port and in JAX on the same batches, to the bits
  of the captured instant; the ``nan_policy="raise"`` and ``journal_corrupt`` seams land bundles.
"""
from __future__ import annotations

import os
import pickle
import struct
import warnings
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.obs import bundle
from torchmetrics_tpu_torch.parallel import sync
from torchmetrics_tpu_torch.robust import journal
from torchmetrics_tpu_torch.serve import ServeOptions
from torchmetrics_tpu_torch.utils.exceptions import BundleError, JournalError, NumericPoisonError


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu.obs import bundle as jbundle
    from torchmetrics_tpu.robust import journal as jjournal
    from torchmetrics_tpu.serve import ServeOptions as JServeOptions

    return SimpleNamespace(top=jt, obs=jobs, bundle=jbundle, journal=jjournal, ServeOptions=JServeOptions)


def _capture(tmp_path, reason="test", metric=None):
    path = bundle.capture_bundle(reason, metric=metric, directory=str(tmp_path))
    assert path is not None
    return path


def _batches(n=8, seed=0, rows=16, classes=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, classes).astype(np.float32), rng.randint(0, classes, rows)) for _ in range(n)]


def _bits(m):
    return {k: v.numpy().tobytes() for k, v in m._state.tensors.items()}


def test_round_trip_has_required_sections(tmp_path):
    m = port.classification.MulticlassConfusionMatrix(num_classes=5, device="cpu")
    m.update(*(torch.from_numpy(a) for a in _batches(1)[0]))
    # the health section reads the process-global rank ledger and gather latencies: start them empty
    sync.reset_health_state()
    sync.reset_skew_state()
    path = _capture(tmp_path, metric=m)
    doc = bundle.load_bundle(path)
    assert set(bundle.REQUIRED_SECTIONS) <= set(doc["sections"])
    assert doc["format"] == bundle.FORMAT and doc["version"] == bundle.VERSION and doc["reason"] == "test"
    section = doc["sections"]["metric"]
    assert section["class"] == "MulticlassConfusionMatrix" and section["update_count"] == 1
    assert section["states"]["confmat"] == {"shape": (5, 5), "dtype": "int64"}
    env = doc["sections"]["env"]
    assert env["torch_version"] == torch.__version__ and env["backend"] == "cpu" and env["device_count"] == 0
    assert doc["sections"]["health"] == {"ranks": {}, "skew": None, "gather_stats": None}
    assert doc["sections"]["memory"] == {"rows": [], "totals": {}}
    summary = bundle.validate_bundle(path)
    assert summary["valid"] and summary["sections"] == sorted(doc["sections"])
    # sections hold plain Python, never tensors: the JAX package's reader needs no torch type
    assert b"torch._utils" not in open(path, "rb").read()


def test_dump_diagnostics_public_api(tmp_path):
    m = port.SumMetric(device="cpu")
    m.update(torch.ones(3))
    path = m.dump_diagnostics(directory=str(tmp_path))
    assert bundle.validate_bundle(path)["reason"] == "manual"
    assert bundle.load_bundle(path)["sections"]["metric"]["class"] == "SumMetric"


def _rewrite_with_flipped_section(path, name):
    doc = bundle.load_bundle(path)
    packed = {n: {"crc": zlib.crc32(pickle.dumps(o)) & 0xFFFFFFFF, "data": pickle.dumps(o)}
              for n, o in doc["sections"].items()}
    bad = bytearray(packed[name]["data"])
    bad[-1] ^= 0xFF
    packed[name]["data"] = bytes(bad)
    payload = pickle.dumps({**{k: v for k, v in doc.items() if k != "sections"}, "sections": packed})
    with open(path, "wb") as fh:
        fh.write(bundle.BUNDLE_MAGIC + struct.Struct("<IQ").pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
                 + payload)


def _message(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value).__name__, str(info.value)


def test_section_crc_violation_named_as_jax_names_it(jax, tmp_path):
    path = _capture(tmp_path)
    _rewrite_with_flipped_section(path, "flight")
    ours = _message(bundle.validate_bundle, path)
    assert ours == _message(jax.bundle.validate_bundle, path)
    assert "corrupt section(s) ['flight']" in ours[1] and "section checksum mismatch" in ours[1]
    lenient = bundle.load_bundle(path, strict=False)
    assert lenient["_section_errors"] == {"flight": "section checksum mismatch"}
    assert "DAMAGED" in bundle.inspect_bundle(path)


@pytest.mark.parametrize("damage", ["not_a_bundle", "container_flip", "truncated"])
def test_damaged_files_refused_as_jax_refuses_them(jax, tmp_path, damage):
    path = _capture(tmp_path)
    raw = bytearray(open(path, "rb").read())
    if damage == "not_a_bundle":
        raw = bytearray(b"hello, not a bundle")
    elif damage == "container_flip":
        raw[len(raw) // 2] ^= 0x01
    else:
        raw = raw[:-5]
    with open(path, "wb") as fh:
        fh.write(raw)
    ours, theirs = _message(bundle.validate_bundle, path), _message(jax.bundle.validate_bundle, path)
    assert ours[0] == theirs[0] == "BundleError" and ours[1] == theirs[1]


def test_disabled_switch_returns_none(tmp_path, monkeypatch):
    monkeypatch.setenv(bundle.ENV_BUNDLES, "0")
    assert obs.capture_bundle("off", directory=str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def test_capture_dir_scopes_and_last_path_tracks(tmp_path):
    with bundle.capture_dir(str(tmp_path / "scoped")):
        path = obs.capture_bundle("scoped-reason")
    assert path is not None and str(tmp_path / "scoped") in path and "scoped-reason" in os.path.basename(path)
    assert obs.last_bundle_path() == path


def test_pruning_keeps_newest(tmp_path, monkeypatch):
    monkeypatch.setenv(bundle.ENV_BUNDLE_KEEP, "3")
    paths = [_capture(tmp_path, reason=f"r{i}") for i in range(6)]
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith(".tmb"))
    assert len(names) == 3 and os.path.basename(paths[-1]) in names


def test_cli_exit_codes_and_output(tmp_path, capsys):
    good = _capture(tmp_path, reason="good")
    obs.telemetry.counter("test.bundle.moved").inc(3)
    later = _capture(tmp_path, reason="later")
    bad = str(tmp_path / "bad.tmb")
    with open(bad, "wb") as fh:
        fh.write(b"junk")
    assert bundle.main(["validate", good]) == 0
    assert bundle.main(["validate", good, bad]) == 1
    out = capsys.readouterr().out
    assert out.count("ok       ") == 2 and "INVALID  " in out and "reason='good'" in out
    assert bundle.main(["inspect", good, "--events", "5"]) == 0
    out = capsys.readouterr().out
    assert "reason:   good" in out and f"torch={torch.__version__}" in out and "sections:" in out
    assert bundle.main(["diff", good, later]) == 0
    out = capsys.readouterr().out
    assert "test.bundle.moved: 0 -> 3 (+3)" in out and "counters moved:" in out


def test_capture_failure_degrades_to_warning(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = obs.telemetry.counter("flight.bundle_capture_failures").value
    with pytest.warns(UserWarning, match="capture for reason 'doomed' failed"):
        assert obs.capture_bundle("doomed", directory=str(blocker / "sub")) is None
    assert obs.telemetry.counter("flight.bundle_capture_failures").value == before + 1


def test_incidents_shared_inside_one_window(tmp_path):
    obs.flightrec.clear_incidents()
    a = bundle.load_bundle(_capture(tmp_path, reason="first-seam"))
    b = bundle.load_bundle(_capture(tmp_path, reason="second-seam"))
    assert a["incident_id"] and a["incident_id"] == b["incident_id"]
    obs.flightrec.clear_incidents()
    c = bundle.load_bundle(_capture(tmp_path, reason="after-clear"))
    assert c["incident_id"] != a["incident_id"]


def test_merge_fleet_round_trip_and_cli(tmp_path, capsys):
    obs.flightrec.clear_incidents()
    for r in range(3):
        _capture(tmp_path / "ranks", reason=f"rank-{r}")
    out = obs.merge_fleet_bundles([str(tmp_path / "ranks")], output=str(tmp_path / "fleet.tmb"))
    summary = obs.validate_bundle(out)
    fleet = bundle.load_bundle(out)["sections"]["fleet"]
    assert summary["valid"] and len(fleet["bundles"]) == 3
    keys = [(e["peer"], e["seq"]) for e in fleet["timeline"]]
    assert keys == sorted(keys)
    assert bundle.main(["merge-fleet", str(tmp_path / "ranks"), "--output", str(tmp_path / "fleet2.tmb")]) == 0
    assert "fleet bundle written" in capsys.readouterr().out
    assert bundle.main(["merge-fleet", str(tmp_path / "nothing-here")]) == 1


def test_merged_view_gathers_every_rank(tmp_path):
    payloads = []

    def gather(payload):
        payloads.append(payload)
        return [payload, payload.replace('"rank": 0', '"rank": 1')]

    path = bundle.capture_bundle("merged", directory=str(tmp_path), merged=True, gather_fn=gather)
    ranks = bundle.load_bundle(path)["sections"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1] and len(payloads) == 1


def test_port_bundle_passes_jax_and_jax_bundle_passes_port(jax, tmp_path):
    m = port.SumMetric(device="cpu")
    m.update(torch.ones(4))
    ours = _capture(tmp_path / "port", metric=m)
    theirs_summary = jax.bundle.validate_bundle(ours)
    assert theirs_summary["valid"] and theirs_summary["reason"] == "test"
    doc = jax.bundle.load_bundle(ours)
    assert doc["sections"]["metric"]["class"] == "SumMetric" and "jax_version" not in doc["sections"]["env"]
    jm = jax.top.SumMetric()
    jm.update(np.ones(4, np.float32))
    theirs = jax.bundle.capture_bundle("from-jax", metric=jm, directory=str(tmp_path / "jax"))
    summary = bundle.validate_bundle(theirs)
    assert summary["valid"] and summary["reason"] == "from-jax"
    assert "jax=" in bundle.inspect_bundle(theirs)
    assert bundle.load_bundle(theirs)["sections"]["metric"]["class"] == "SumMetric"


def _served_journal(top, options_cls, journal_cls, device_kw, wal, batches, cut):
    """Serve ``batches`` into a journaled MulticlassConfusionMatrix, capture a bundle after ``cut`` of them."""
    m = top.classification.MulticlassConfusionMatrix(num_classes=5, **device_kw)
    eng = m.serve(options_cls(max_inflight=64), journal=journal_cls(wal))
    for b in batches[:cut]:
        m.update_async(*b)
    eng.quiesce()
    path = m.dump_diagnostics("cursor", directory=str(wal) + "-bundles")
    for b in batches[cut:]:
        m.update_async(*b)
    eng.quiesce()
    eng.close()
    return path


def test_journal_cursor_through_a_bundle_path_in_both_packages(jax, tmp_path):
    batches = _batches(9, seed=2)
    ours = _served_journal(port, ServeOptions, journal.Journal, {"device": "cpu"}, tmp_path / "port-wal", batches, 5)
    theirs = _served_journal(jax.top, jax.ServeOptions, jax.journal.Journal, {}, tmp_path / "jax-wal", batches, 5)
    assert bundle.validate_bundle(ours)["journal_cursor"]["last_seq"] == 4
    assert jax.bundle.validate_bundle(theirs)["journal_cursor"]["last_seq"] == 4
    ref = port.classification.MulticlassConfusionMatrix(num_classes=5, device="cpu")
    for b in batches[:5]:
        ref.update(*(torch.from_numpy(a) for a in b))
    # the port recovers each package's WAL through each package's bundle path
    for wal, path in ((tmp_path / "port-wal", ours), (tmp_path / "jax-wal", theirs)):
        rec = port.classification.MulticlassConfusionMatrix(num_classes=5, device="cpu")
        info = journal.recover(rec, wal, cursor=path)
        assert info["replayed"] == 5 and info["through_seq"] == 4
        assert _bits(rec) == _bits(ref)
    # and JAX recovers the port's WAL through the port's bundle path to the same counts
    jrec = jax.top.classification.MulticlassConfusionMatrix(num_classes=5)
    jax.journal.recover(jrec, tmp_path / "port-wal", cursor=ours)
    np.testing.assert_array_equal(np.asarray(jrec.compute()), ref.compute().numpy())


def test_unusable_cursor_raises(tmp_path):
    with pytest.raises(JournalError, match="Unusable journal cursor"):
        journal.recover(port.SumMetric(device="cpu"), tmp_path, cursor={"nothing": 1})
    with pytest.raises(BundleError, match="Cannot read bundle"):
        journal.recover(port.SumMetric(device="cpu"), tmp_path, cursor=str(tmp_path / "missing.tmb"))


def test_nan_policy_raise_captures_bundle(tmp_path):
    m = port.MeanMetric(nan_policy="raise", device="cpu")
    m.update(torch.tensor([1.0, float("nan")]))
    before = obs.last_bundle_path()
    with bundle.capture_dir(str(tmp_path)), pytest.raises(NumericPoisonError):
        m.compute()
    path = obs.last_bundle_path()
    assert path != before and path.startswith(str(tmp_path))
    doc = bundle.load_bundle(path)
    assert doc["reason"] == "nan_poison" and doc["sections"]["metric"]["nan_policy"] == "raise"
    kinds = [e["kind"] for e in doc["sections"]["flight"]["events"]]
    assert "nan.poison" in kinds


def test_corrupt_journal_record_captures_bundle(tmp_path):
    jr = journal.Journal(tmp_path / "wal")
    for i in range(3):
        jr.append((np.full(2, float(i), np.float32),))
    with open(jr._record_path(1), "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        last = fh.read(1)
        fh.seek(-1, os.SEEK_END)
        fh.write(bytes([last[0] ^ 0xFF]))
    with bundle.capture_dir(str(tmp_path / "bundles")), pytest.raises(JournalError, match="corrupt"):
        list(jr.read())
    path = obs.last_bundle_path()
    assert path.startswith(str(tmp_path / "bundles")) and bundle.validate_bundle(path)["reason"] == "journal_corrupt"


def test_serving_failure_seams_capture_bundles(tmp_path):
    """The drain's death and an abandoned window land bundles under JAX's reasons."""
    from torchmetrics_tpu_torch.robust.chaos import DrainThreadDeath, PreemptMidOverlap

    with bundle.capture_dir(str(tmp_path)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = port.SumMetric(device="cpu")
        eng = m.serve(ServeOptions(max_inflight=8))
        with DrainThreadDeath():
            m.update_async(np.ones(2, np.float32))
            eng.quiesce()
        eng.pause()
        m.update_async(np.ones(2, np.float32))
        PreemptMidOverlap().strike(m)
    reasons = sorted(bundle.load_bundle(os.path.join(tmp_path, n))["reason"] for n in os.listdir(tmp_path))
    assert reasons == ["chaos.drain_thread_death", "chaos.preempt_mid_overlap", "serve_abandoned",
                       "serve_drain_death"]
