"""Quickstart on the PyTorch port: approximate a GROUP BY query by
reading 10% of partitions (`examples/quickstart.py` on `repro_torch`).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` is ``cuda`` by default: the kernels run on the card, and a
``cuda`` request without a GPU raises.  ``--partitions``/``--rows``
shrink the table (128 x 1024 by default, as the JAX quickstart's).
"""
import argparse

import numpy as np

from repro_torch.backends import ExecOptions
from repro_torch.core.picker import PickerConfig, train_picker
from repro_torch.data.datasets import make_dataset
from repro_torch.queries.engine import error_metrics, per_partition_answers
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Aggregate, Clause, Predicate, Query


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--partitions", type=int, default=128)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    options = ExecOptions(device=args.device)
    options.torch_device()  # a cuda request without a GPU raises here

    # 1. a partitioned table (tenant-sorted service log)
    table = make_dataset("aria", num_partitions=args.partitions, rows_per_partition=args.rows)

    # 2. one-time preparation: sketches + picker training on the workload
    workload = WorkloadSpec(table, seed=0)
    art = train_picker(
        table, workload, num_train_queries=60,
        config=PickerConfig(num_trees=24, tree_depth=4, feature_selection=False),
        options=options,
    )
    print(f"picker trained in {art.train_seconds:.1f}s")

    # 3. an ad-hoc query: per-tenant payload above a latency floor
    query = Query(
        aggregates=(Aggregate("sum", ((1.0, "olsize"),)), Aggregate("count")),
        predicate=Predicate.conjunction([Clause("ingestion_latency", ">", 5.0)]),
        groupby=("TenantId",),
    )
    answers = per_partition_answers(table, query, options=options)
    truth = answers.truth()

    # 4. approximate with a 10% budget
    budget = table.num_partitions // 10
    sel = art.picker.pick(query, budget)
    est = answers.estimate(sel.ids, sel.weights)
    m = error_metrics(truth, est)
    print(f"read {len(sel.ids)}/{table.num_partitions} partitions "
          f"({sel.num_outliers} outliers, groups {sel.group_sizes})")
    print(f"avg rel err {m['avg_rel_err']:.3f}, missed groups "
          f"{m['missed_groups']:.1%}")

    # 5. versus uniform sampling at the same budget
    rng = np.random.default_rng(0)
    ids = rng.choice(table.num_partitions, budget, replace=False)
    w = np.full(budget, table.num_partitions / budget)
    mu = error_metrics(truth, answers.estimate(ids, w))
    print(f"uniform sampling at the same budget: {mu['avg_rel_err']:.3f} "
          f"avg rel err, {mu['missed_groups']:.1%} missed")
    return {"budget": budget, "read": len(sel.ids), "errors": m, "uniform": mu}


if __name__ == "__main__":
    main()
