"""The port's write-ahead update journal (``robust/journal.py``) against the JAX package's.

- A journal directory that the JAX package writes (a durable snapshot and a tail of records, its writer gone
  without a clean exit) recovers in the port (``recover``) to JAX's own ``recover`` and to the uninterrupted
  run.
- The writer lock (a live second writer refused, a dead writer's lock stolen with JAX's warning), a torn
  tail record (skipped with a warning), a corrupt record mid-stream (``JournalError``), the ``every_k``
  snapshot-and-truncate cycle, and the ``buffered`` seam with batches pending at the crash.
- A spawned child process that drives a journaled metric and kills itself with ``SIGKILL`` after a batch's
  append and before its apply: the parent recovers with ``resume=True`` and finishes, bit-equal to the
  uninterrupted run.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import signal
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.robust import journal
from torchmetrics_tpu_torch.utils.exceptions import BundleError, JournalError


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu.robust import journal as jj

    return SimpleNamespace(top=jt, journal=jj)


def _batches(n=10, seed=0, rows=16, classes=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, classes).astype(np.float32), rng.randint(0, classes, rows)) for _ in range(n)]


def _port_metric():
    return port.classification.MulticlassConfusionMatrix(num_classes=5, device="cpu")


def _tensors(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _uninterrupted(batches):
    m = _port_metric()
    for b in batches:
        m.update(*_tensors(b))
    return m


def _state_bits(m):
    return {k: v.numpy().tobytes() for k, v in m._state.tensors.items()}


def test_jax_journal_recovers_in_the_port(jax, tmp_path):
    batches = _batches()
    theirs = jax.top.classification.MulticlassConfusionMatrix(num_classes=5)
    jm = jax.journal.MetricJournal(theirs, tmp_path, every_k=4)
    for b in batches[:7]:
        jm.update(*b)  # 4 in the snapshot, 3 in the tail; no clean exit
    assert sorted(os.listdir(tmp_path)) == [".writer.lock", "000000000004.tmj", "000000000005.tmj",
                                            "000000000006.tmj", "snapshot.tmsnap"]
    ours = _port_metric()
    info = journal.recover(ours, tmp_path)
    assert info == {"snapshot_restored": True, "replayed": 3, "after_seq": 3, "through_seq": None}
    want = jax.top.classification.MulticlassConfusionMatrix(num_classes=5)
    jax.journal.recover(want, tmp_path)
    np.testing.assert_array_equal(ours.compute().numpy(), np.asarray(want.compute()))
    assert _state_bits(ours) == _state_bits(_uninterrupted(batches[:7]))
    # a cursor stops replay at a record: a sequence number, a cursor dict, a bundle document
    for cursor in (5, {"last_seq": 5}, {"sections": {"journal": {"cursor": {"last_seq": 5}}}}):
        part = _port_metric()
        assert journal.recover(part, tmp_path, cursor=cursor)["replayed"] == 2
        assert _state_bits(part) == _state_bits(_uninterrupted(batches[:6]))
    # a bundle path is a cursor too (obs/bundle): one that names no file is refused as JAX refuses it
    with pytest.raises(BundleError, match="Cannot read bundle"):
        journal.recover(_port_metric(), tmp_path, cursor=str(tmp_path / "x.tmb"))


def test_port_journal_replays_in_jax(jax, tmp_path):
    """The records are the JAX package's container, so the JAX package replays what the port writes."""
    batches = _batches(5, seed=1)
    ours = _port_metric()
    with ours.journal(tmp_path, every_k=100) as jm:
        for b in batches:
            jm.update(*_tensors(b))
    jrnl = jax.journal.Journal(tmp_path)
    for b in batches:
        jrnl.append(b)  # the tail after the port's final snapshot
    theirs = jax.top.classification.MulticlassConfusionMatrix(num_classes=5)
    replayed = [rec for rec in jax.journal.Journal(tmp_path).read()]
    assert len(replayed) == 5
    for _, args, kwargs in replayed:
        theirs.update(*args, **kwargs)
    np.testing.assert_array_equal(np.asarray(theirs.compute()), ours.compute().numpy())


def test_writer_lock(jax, tmp_path):
    m = _port_metric()
    jm = m.journal(tmp_path)
    with pytest.raises(JournalError, match=f"already has a live writer \\(pid {os.getpid()}\\)"):
        _port_metric().journal(tmp_path)
    jm.close()
    # a dead holder's lock is stale: stolen with JAX's warning
    (tmp_path / journal.LOCK_FILENAME).write_text("999999999:deadbeef")
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        lock = journal._WriterLock(os.fspath(tmp_path))
        lock.acquire()
    lock.release()
    (tmp_path / journal.LOCK_FILENAME).write_text("999999999:deadbeef")
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        jlock = jax.journal._WriterLock(os.fspath(tmp_path))
        jlock.acquire()
    jlock.release()
    steal = [str(w.message) for w in ours if "Stealing" in str(w.message)]
    assert steal and steal == [str(w.message) for w in theirs if "Stealing" in str(w.message)]
    assert journal.break_lock(tmp_path) is False


def test_torn_tail_and_corrupt_middle(jax, tmp_path):
    batches = _batches(4, seed=2)
    jr = journal.Journal(tmp_path)
    for b in batches:
        jr.append(_tensors(b))
    last = tmp_path / "000000000003.tmj"
    last.write_bytes(last.read_bytes()[:-7])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = _port_metric()
        assert journal.replay(m, tmp_path) == 3
    assert any("is torn" in str(w.message) for w in caught)
    assert _state_bits(m) == _state_bits(_uninterrupted(batches[:3]))
    middle = tmp_path / "000000000001.tmj"
    raw = bytearray(middle.read_bytes())
    raw[-1] ^= 0xFF
    middle.write_bytes(bytes(raw))
    with pytest.raises(JournalError) as ours:
        journal.replay(_port_metric(), tmp_path)
    with pytest.raises(Exception) as theirs:  # JAX lands a post-mortem bundle, then raises its JournalError
        jax.journal.replay(jax.top.classification.MulticlassConfusionMatrix(num_classes=5), tmp_path)
    assert str(ours.value) == str(theirs.value) and "checksum mismatch" in str(ours.value)


def test_every_k_cycle_bounds_the_directory(tmp_path):
    batches = _batches(11, seed=3)
    m = _port_metric()
    jm = m.journal(tmp_path, every_k=4)
    for i, b in enumerate(batches):
        jm.update(*_tensors(b))
        assert jm.journal.pending <= 4
        assert jm.journal.pending == (i + 1) % 4
    jm.close()
    back = _port_metric()
    info = journal.recover(back, tmp_path)
    assert info["snapshot_restored"] and info["replayed"] == 3 and info["after_seq"] == 7
    assert _state_bits(back) == _state_bits(m)
    with pytest.raises(ValueError, match="every_k >= 1"):
        m.journal(tmp_path, every_k=0)
    # the journaled async twin (serve/): the batch is on disk at enqueue, and applied by the drain
    other = m.journal(tmp_path / "other")
    other.update_async(*_tensors(batches[0])).result(timeout=10.0)
    assert other.journal.last_seq == 0
    other.close()


def test_buffered_seam_keeps_the_pending_window(tmp_path):
    """``buffered(k, journal=...)`` appends each batch before it is pending: a crash with a window pending
    recovers every batch."""
    batches = _batches(7, seed=4)
    m = _port_metric()
    jm = m.journal(tmp_path, every_k=100)
    buf = jm.buffered(3)
    for b in batches:
        buf.update(*_tensors(b))
    assert buf.pending == 1 and jm.journal.pending == 7  # the crash: one batch never flushed
    back = _port_metric()
    assert journal.recover(back, tmp_path)["replayed"] == 7
    assert _state_bits(back) == _state_bits(_uninterrupted(batches))
    jm.close()


def _child(path: str, n: int, kill_at: int, every_k: int, buffered: int) -> None:
    """Drive a journaled metric through the batches and kill this process with SIGKILL once batch ``kill_at``
    is appended and before it is applied (through ``buffered``: before its flush)."""
    batches = _batches(n, seed=5)
    m = _port_metric()
    jm = m.journal(path, every_k=every_k)
    if buffered:
        buf = jm.buffered(buffered)
        for i, b in enumerate(batches):
            buf.update(*_tensors(b))
            if i == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
            if buf.pending == 0 and jm.journal.pending >= every_k:
                jm.checkpoint()
        return
    apply = m.update
    seen = {"n": 0}

    def update(*args, **kwargs):
        if seen["n"] == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        seen["n"] += 1
        apply(*args, **kwargs)

    m.update = update
    for b in batches:
        jm.update(*_tensors(b))


@pytest.mark.parametrize("buffered", [0, 4])
def test_sigkilled_spawned_child_recovers_bit_equal(tmp_path, buffered):
    n, kill_at, every_k = 12, 8, 3
    ctx = multiprocessing.get_context("spawn")
    child = ctx.Process(target=_child, args=(os.fspath(tmp_path), n, kill_at, every_k, buffered))
    child.start()
    child.join(120)
    assert child.exitcode == -signal.SIGKILL
    records = sorted(f for f in os.listdir(tmp_path) if f.endswith(".tmj"))
    assert records[-1] == f"{kill_at:012d}.tmj" and len(records) <= (every_k if not buffered else every_k + buffered)
    holder = (tmp_path / journal.LOCK_FILENAME).read_text().split(":")[0]
    assert int(holder) == child.pid
    batches = _batches(n, seed=5)
    back = _port_metric()
    with back.journal(tmp_path, every_k=every_k, resume=True) as jm:
        assert jm.recovered["replayed"] + 1 + jm.recovered["after_seq"] == kill_at + 1
        for b in batches[kill_at + 1:]:
            jm.update(*_tensors(b))
    assert _state_bits(back) == _state_bits(_uninterrupted(batches))
    blob = pickle.loads(open(tmp_path / journal.SNAPSHOT_FILENAME, "rb").read()[20:])
    assert blob["journal_seq"] == n - 1 and not any(f.endswith(".tmj") for f in os.listdir(tmp_path))
