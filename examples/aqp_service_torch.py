"""End-to-end AQP service driver on the PyTorch port
(`examples/aqp_service.py` on `repro_torch.api.Session`).

The production flow on a batch of ad-hoc queries:
  ingest → sketch construction → picker training (one-time, via
  `Session.prepare`) → optional materialized views over hot group-bys →
  error-bounded serving (`QuerySpec(error_bound=...)`: the planner
  escalates partition reads per query until its confidence interval
  meets the bound) → answer + error accounting vs the exact run.

Pass ``--budget`` to serve with the classic fixed partition budget
instead of an error bound.  ``--device`` is ``cuda`` by default: the
kernels run on the card, and a ``cuda`` request without a GPU raises.

    PYTHONPATH=src python examples/aqp_service_torch.py [--error-bound 0.05]
    PYTHONPATH=src python examples/aqp_service_torch.py --budget 0.1 --device cpu
"""
import argparse
import time

import numpy as np

import repro_torch.api as ps3
from repro_torch.backends import ExecOptions
from repro_torch.core.picker import PickerConfig
from repro_torch.data.datasets import make_dataset
from repro_torch.queries.engine import error_metrics, per_partition_answers
from repro_torch.queries.generator import WorkloadSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tpch")
    ap.add_argument("--partitions", type=int, default=128)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--error-bound", type=float, default=0.05)
    ap.add_argument("--budget", type=float, default=None,
                    help="fixed budget as a fraction of partitions "
                         "(overrides --error-bound)")
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    options = ExecOptions(device=args.device)
    options.torch_device()  # a cuda request without a GPU raises here

    table = make_dataset(args.dataset, num_partitions=args.partitions,
                         rows_per_partition=args.rows)

    # ---- one-time preparation: sketches + picker, owned by the session
    sess = ps3.Session(table, options=options)
    t0 = time.perf_counter()
    sess.prepare(
        WorkloadSpec(table, seed=0), num_train_queries=60,
        picker_config=PickerConfig(num_trees=24, tree_depth=4),
    )
    print(f"[prepare] sketches + picker in {time.perf_counter() - t0:.1f}s")

    # ---- hot views: dashboards repeat the same group-bys; materialize one
    gb = table.groupable_columns[:1]
    if gb:
        sess.register_view(gb, (ps3.Aggregate("count"),))
        print(f"[views] materialized exact counts over {gb}")

    # ---- serve unseen queries through the error-bounded planner
    test = WorkloadSpec(table, seed=777).sample_workload(args.queries)
    if args.budget is not None:
        budget = max(1, int(args.budget * args.partitions))
        specs = [ps3.QuerySpec(q, budget=budget) for q in test]
        contract = f"budget {budget}"
    else:
        specs = [ps3.QuerySpec(q, error_bound=args.error_bound) for q in test]
        contract = f"error bound {args.error_bound:.0%}"
    errs, reads, modes = [], [], []
    for q, ans in zip(test, sess.execute_batch(specs)):
        truth_ans = per_partition_answers(table, q, options=sess.options)
        truth = truth_ans.truth()
        if truth.size == 0:
            continue
        est = np.full(truth.shape, np.nan)
        pos = {int(k): i for i, k in enumerate(ans.group_keys)}
        for gi, k in enumerate(truth_ans.group_keys):
            if int(k) in pos:
                est[gi] = ans.estimate[pos[int(k)]]
        m = error_metrics(truth, est)
        errs.append(m["avg_rel_err"])
        reads.append(ans.partitions_read)
        modes.append(ans.plan.mode)
        print(f"  {q.describe()[:66]:68s} mode {ans.plan.mode:7s} "
              f"read {ans.partitions_read:3d} err {m['avg_rel_err']:.3f}")
    stats = sess.stats()
    print(f"[serve] mean err {np.mean(errs):.3f} @ {contract}; "
          f"mean reads {np.mean(reads):.1f}/{args.partitions} "
          f"({stats['chunk_evals']} chunk evals, "
          f"{stats['answer_hits']} answer-cache hits)")
    return {"errors": errs, "reads": reads, "modes": modes, "stats": stats}


if __name__ == "__main__":
    main()
