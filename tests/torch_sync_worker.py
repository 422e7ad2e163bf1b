"""One rank of the port's two-process sync test (``tests/test_torch_sync_multiprocess.py``).

    python tests/torch_sync_worker.py HOST:PORT RANK WORLD MODE

It joins a gloo world on the CPU (``init_process_group`` with a 60 s timeout), drives the port's
sync through its public entry points (``gather_all_arrays``, ``Metric.compute``, ``sync_state``)
on rank-dependent data, and prints one ``RESULT {json}`` line for the test to read. ``MODE`` is
``all`` for every case, or ``die``: rank 1 exits right after joining, so rank 0's first collective
must fail rather than wait. Modelled on the JAX package's ``tests/unittests/bases/_mp_sync_worker.py``.
"""
import datetime
import json
import os
import sys


def main() -> None:
    address, rank, world, mode = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

    import numpy as np
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    if mode == "die" and rank == 1:
        os._exit(3)

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import CatMetric, MeanMetric, SumMetric
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score, MulticlassPrecision
    from torchmetrics_tpu_torch.parallel import all_gather_object_shapes, distributed_available, gather_all_arrays, sync_state
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    results = {"rank": rank, "world": dist.get_world_size(), "available": distributed_available()}

    # --- raw gathers: uneven, even, ndim that differs, 0-d, bool, shapes
    local = torch.arange(rank + 1, dtype=torch.float32) + 10 * rank  # rank 0: (1,), rank 1: (2,)
    results["gather_uneven"] = [g.tolist() for g in gather_all_arrays(local)]
    results["gather_even"] = [g.tolist() for g in gather_all_arrays(torch.tensor([float(rank)] * 2))]
    ragged = torch.zeros(0) if rank == 0 else torch.arange(24, dtype=torch.int64).reshape(3, 8)
    results["gather_ndim"] = [[list(g.shape), str(g.dtype)] for g in gather_all_arrays(ragged)]
    results["gather_scalar"] = [g.tolist() for g in gather_all_arrays(torch.tensor(float(rank)))]
    results["gather_bool"] = [g.tolist() for g in gather_all_arrays(torch.tensor([True, rank == 1]))]
    results["shapes"] = [list(s) for s in all_gather_object_shapes((rank + 1, 2))]

    # --- a sum state through compute(); the cache; the local state put back
    s = SumMetric(device="cpu")
    s.update(float(rank + 1))
    results["sum_metric"] = float(s.compute())
    results["sum_cached"] = float(s.compute())
    results["sum_local_after"] = float(s._tensors["sum_value"])

    # --- uneven cat state; an idle rank; int64 retrieval ids with an idle rank
    c = CatMetric(device="cpu")
    c.update(torch.arange(rank + 2, dtype=torch.float32) + 100 * rank)  # rank 0: 2 values, rank 1: 3
    results["cat_metric"] = c.compute().tolist()
    idle = CatMetric(device="cpu")
    if rank == 0:
        idle.update(torch.tensor([1.0, 2.0, 3.0]))
    results["idle_cat"] = idle.compute().tolist()
    rng = np.random.RandomState(9)
    ids, scores, rel = np.sort(rng.randint(0, 20, 300)), rng.rand(300).astype(np.float32), rng.randint(0, 2, 300)
    r_map = RetrievalMAP(device="cpu")
    if rank == 0:
        r_map.update(torch.from_numpy(scores), torch.from_numpy(rel), indexes=torch.from_numpy(ids))
    results["map"] = float(r_map.compute())
    whole_map = RetrievalMAP(device="cpu", sync_on_compute=False)
    whole_map.update(torch.from_numpy(scores), torch.from_numpy(rel), indexes=torch.from_numpy(ids))
    results["map_full"] = float(whole_map.compute())

    # --- a classification metric on per-rank shards; path A's collection with its compute group
    rng = np.random.RandomState(1234)  # the same stream on both ranks; shard by striding
    preds = rng.randn(64, 5).astype(np.float32)
    target = rng.randint(0, 5, 64)
    acc = MulticlassAccuracy(num_classes=5, average="micro", device="cpu")
    acc.update(torch.from_numpy(preds[rank::world]), torch.from_numpy(target[rank::world]))
    results["accuracy"] = float(acc.compute())
    results["accuracy_full"] = float(np.mean(preds.argmax(-1) == target))
    labels_p, labels_t = rng.randint(0, 5, 1000), rng.randint(0, 5, 1000)

    def collection(**kw):
        return MetricCollection([MulticlassAccuracy(num_classes=5, device="cpu", **kw),
                                 MulticlassPrecision(num_classes=5, average="macro", device="cpu", **kw),
                                 MulticlassF1Score(num_classes=5, average="macro", device="cpu", **kw)])

    mc = collection()
    share = slice(0, 400) if rank == 0 else slice(400, 1000)
    for part in (slice(share.start, share.start + 100), slice(share.start + 100, share.stop)):
        mc.update(torch.from_numpy(labels_p[part]), torch.from_numpy(labels_t[part]))
    results["groups"] = [list(g) for g in mc.compute_groups.values()]
    results["collection"] = {k: float(v) for k, v in mc.compute().items()}
    whole = collection(sync_on_compute=False)
    whole.update(torch.from_numpy(labels_p), torch.from_numpy(labels_t))
    results["collection_full"] = {k: float(v) for k, v in whole.compute().items()}
    results["world_consistent"] = str(mc.world_consistent)

    # --- Pearson split 37/63 through compute(): the None reduction's world axis
    rng = np.random.RandomState(37)
    x = rng.randn(100).astype(np.float32)
    y = (0.6 * x + rng.randn(100)).astype(np.float32)
    part = slice(0, 37) if rank == 0 else slice(37, 100)
    pearson = PearsonCorrCoef(device="cpu")
    pearson.update(torch.from_numpy(x[part]), torch.from_numpy(y[part]))
    results["pearson"] = float(pearson.compute())
    pearson_full = PearsonCorrCoef(device="cpu", sync_on_compute=False)
    pearson_full.update(torch.from_numpy(x), torch.from_numpy(y))
    results["pearson_full"] = float(pearson_full.compute())

    # --- MeanMetric's weighted mean: [1, 2, 3] and [10]
    mean = MeanMetric(device="cpu")
    mean.update(torch.tensor([1.0, 2.0, 3.0] if rank == 0 else [10.0]))
    results["mean"] = float(mean.compute())

    # --- sync_state, the in-program collective: states of one shape on every rank
    state = {
        "counts": torch.tensor([rank + 1, 10 * (rank + 1)], dtype=torch.int64),
        "total": torch.tensor([0.1 * (rank + 1), 2.5]),
        "avg": torch.tensor(float(rank)),
        "hi": torch.tensor([rank, -rank], dtype=torch.int32),
        "lo": torch.tensor([float(rank), -float(rank)]),
        "seen": torch.arange(2) + 2 * rank,
        "stack": torch.tensor([float(rank), 5.0]),
        "folded": torch.tensor([1.0, float(rank)]),
        "flags": torch.tensor([rank == 0, True]),
        "entries": [torch.tensor([rank]), torch.tensor([rank + 10])],
        "none": [],
    }
    reductions = {"counts": "sum", "total": "sum", "avg": "mean", "hi": "max", "lo": "min", "seen": "cat",
                  "stack": None, "folded": lambda v: v.sum(0), "flags": "max", "entries": "cat", "none": "cat"}
    before = state["counts"].clone()
    out = sync_state(state, reductions)
    results["sync_state"] = {k: ([e.tolist() for e in v] if isinstance(v, list) else v.tolist()) for k, v in out.items()}
    results["sync_state_dtypes"] = {k: str(v.dtype) for k, v in out.items() if not isinstance(v, list)}
    results["sync_state_input_kept"] = bool(torch.equal(state["counts"], before))

    print("RESULT " + json.dumps(results), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
