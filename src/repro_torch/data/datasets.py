"""Synthetic datasets with the structure of the paper's four workloads.

The paper evaluates on TPC-H* (zipf-skewed, sorted by ship date), TPC-DS*
(sorted by year/month/day), Aria (Microsoft service log, sorted by TenantId)
and KDD'99 (sorted by a numeric column).  Those exact datasets are either
proprietary or too large for this container, so we generate synthetic tables
that match their *structure*: column mix, zipf skew on categoricals,
correlated numerics, heavy-hitter concentration ("the most popular
application version accounts for almost half of the dataset"), and the same
sorted-layout defaults.  Partition counts default to the paper's 1000-ish
regime scaled to CPU budget.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.table import CATEGORICAL, NUMERIC, ColumnSpec, Table, from_flat


def _zipf_codes(rng, n, cardinality, a=1.1):
    """Zipf-distributed categorical codes in [0, cardinality)."""
    ranks = np.arange(1, cardinality + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(cardinality, size=n, p=probs).astype(np.int32)


def _drifting_zipf(rng, phase, cardinality, a=1.1, drift=1.0):
    """Zipf codes whose popularity ranking rotates with `phase` ∈ [0,1).

    Models the production phenomenon the paper leans on: which values are
    popular changes along the ingest/sort order (new app versions roll out,
    brands trend), so sorted layouts concentrate specific heavy hitters in
    specific partitions and occurrence bitmaps become discriminative.
    """
    base = _zipf_codes(rng, phase.shape[0], cardinality, a).astype(np.int64)
    shift = np.floor(phase * cardinality * drift).astype(np.int64)
    return ((base + shift) % cardinality).astype(np.int32)


def make_tpch_like(
    num_partitions: int = 256,
    rows_per_partition: int = 2048,
    seed: int = 0,
    layout: str = "sorted",
) -> Table:
    """Zipf-skewed denormalized lineitem-like table, sorted by ship date."""
    rng = np.random.default_rng(seed)
    n = num_partitions * rows_per_partition
    shipdate = np.sort(rng.integers(0, 2526, size=n))  # ~7 years of days
    phase = shipdate / 2526.0  # position along the sort/ingest order
    # quantities/prices correlated with date regions and zipf-skewed parts;
    # part popularity and prices drift over time (sorted layouts concentrate
    # specific parts/brands — the paper's skew argument).
    partkey = _drifting_zipf(rng, phase, 200, a=1.0, drift=0.6)
    quantity = rng.integers(1, 51, size=n).astype(np.float32)
    season = 1.0 + 0.5 * np.sin(2 * np.pi * shipdate / 365.0)
    base_price = (
        (900.0 + 10.0 * partkey + rng.gamma(2.0, 120.0, size=n)) * season
    ).astype(np.float32)
    discount = rng.choice(np.arange(0.0, 0.11, 0.01), size=n).astype(np.float32)
    tax = rng.choice(np.arange(0.0, 0.09, 0.01), size=n).astype(np.float32)
    extprice = (quantity * base_price).astype(np.float32)
    # returnflag: 'R' concentrated in old orders (as in real TPC-H receipts)
    returnflag = np.where(
        rng.random(n) < np.clip(0.9 - 1.6 * phase, 0.02, 0.9),
        0,
        rng.integers(1, 3, size=n),
    ).astype(np.int32)
    cols = {
        "l_shipdate": shipdate.astype(np.float32),
        "l_quantity": quantity,
        "l_extendedprice": extprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_partkey": partkey,
        "l_returnflag": returnflag,
        "l_linestatus": (phase > rng.random(n)).astype(np.int32),
        "l_shipmode": _drifting_zipf(rng, phase, 7, a=0.6, drift=0.4),
        "l_shipinstruct": rng.integers(0, 4, size=n).astype(np.int32),
        "n1_name": _drifting_zipf(rng, phase, 25, a=0.5, drift=0.3),
        "r1_name": rng.integers(0, 5, size=n).astype(np.int32),
        "p_brand": _drifting_zipf(rng, phase, 25, a=0.7, drift=0.8),
        "p_container": rng.integers(0, 40, size=n).astype(np.int32),
        "p_size": rng.integers(1, 51, size=n).astype(np.float32),
        "o_orderpriority": _drifting_zipf(rng, phase, 5, a=0.9, drift=0.5),
    }
    schema = (
        ColumnSpec("l_shipdate", NUMERIC),
        ColumnSpec("l_quantity", NUMERIC, positive=True),
        ColumnSpec("l_extendedprice", NUMERIC, positive=True),
        ColumnSpec("l_discount", NUMERIC),
        ColumnSpec("l_tax", NUMERIC),
        ColumnSpec("l_partkey", CATEGORICAL, 200),
        ColumnSpec("l_returnflag", CATEGORICAL, 3, groupable=True),
        ColumnSpec("l_linestatus", CATEGORICAL, 2, groupable=True),
        ColumnSpec("l_shipmode", CATEGORICAL, 7, groupable=True),
        ColumnSpec("l_shipinstruct", CATEGORICAL, 4, groupable=True),
        ColumnSpec("n1_name", CATEGORICAL, 25, groupable=True),
        ColumnSpec("r1_name", CATEGORICAL, 5, groupable=True),
        ColumnSpec("p_brand", CATEGORICAL, 25, groupable=True),
        ColumnSpec("p_container", CATEGORICAL, 40),
        ColumnSpec("p_size", NUMERIC, positive=True),
        ColumnSpec("o_orderpriority", CATEGORICAL, 5, groupable=True),
    )
    table = from_flat(schema, cols, name="tpch_like")
    table = table.repartitioned(num_partitions)
    return _apply_layout(table, layout, "l_shipdate", seed)


def make_aria_like(
    num_partitions: int = 256,
    rows_per_partition: int = 2048,
    seed: int = 1,
    layout: str = "sorted",
) -> Table:
    """Service-request-log-like table: few columns, extreme categorical skew."""
    rng = np.random.default_rng(seed)
    n = num_partitions * rows_per_partition
    tenant = _zipf_codes(rng, n, 120, a=1.3)  # half the data in top tenant-ish
    # per-tenant behaviour: request rates / payload sizes differ by tenant,
    # app version rollout drifts with ingest time (rare versions cluster).
    t_rate = rng.gamma(2.0, 20.0, size=120) + 2.0  # per-tenant mean rate
    t_scale = rng.lognormal(0.0, 0.8, size=120)
    phase = np.arange(n) / n  # ingest order
    app_version = _drifting_zipf(rng, phase, 167, a=1.5, drift=1.0)
    received = rng.poisson(t_rate[tenant]).astype(np.float32) + 1.0
    tried = received * rng.uniform(0.7, 1.0, size=n).astype(np.float32)
    sent = tried * rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    cols = {
        "records_received_count": received,
        "records_tried_to_send_count": tried.astype(np.float32),
        "records_sent_count": sent.astype(np.float32),
        "olsize": (rng.lognormal(6.0, 1.2, size=n) * t_scale[tenant]).astype(
            np.float32
        ),
        "ol_w": rng.gamma(2.0, 3.0, size=n).astype(np.float32),
        "infl": rng.normal(0.0, 1.0, size=n).astype(np.float32),
        "ingestion_latency": rng.lognormal(2.0, 1.0, size=n).astype(np.float32),
        "TenantId": tenant,
        "AppInfo_Version": app_version,
        "UserInfo_TimeZone": rng.integers(0, 38, size=n).astype(np.int32),
        "DeviceInfo_NetworkType": _zipf_codes(rng, n, 4, a=1.0),
    }
    schema = (
        ColumnSpec("records_received_count", NUMERIC, positive=True),
        ColumnSpec("records_tried_to_send_count", NUMERIC, positive=True),
        ColumnSpec("records_sent_count", NUMERIC, positive=True),
        ColumnSpec("olsize", NUMERIC, positive=True),
        ColumnSpec("ol_w", NUMERIC, positive=True),
        ColumnSpec("infl", NUMERIC),
        ColumnSpec("ingestion_latency", NUMERIC, positive=True),
        ColumnSpec("TenantId", CATEGORICAL, 120, groupable=True),
        ColumnSpec("AppInfo_Version", CATEGORICAL, 167, groupable=True),
        ColumnSpec("UserInfo_TimeZone", CATEGORICAL, 38, groupable=True),
        ColumnSpec("DeviceInfo_NetworkType", CATEGORICAL, 4, groupable=True),
    )
    table = from_flat(schema, cols, name="aria_like")
    table = table.repartitioned(num_partitions)
    return _apply_layout(table, layout, "TenantId", seed)


def make_kdd_like(
    num_partitions: int = 256,
    rows_per_partition: int = 2048,
    seed: int = 2,
    layout: str = "sorted",
) -> Table:
    """Network-intrusion-like table: many numerics, several binary columns."""
    rng = np.random.default_rng(seed)
    n = num_partitions * rows_per_partition
    count = rng.gamma(1.2, 80.0, size=n).astype(np.float32)
    srv_count = (count * rng.uniform(0.1, 1.0, size=n)).astype(np.float32)
    # attacks (rare labels) have high connection counts + error rates: the
    # sort-by-count layout concentrates them — KDD's actual structure.
    attack_score = count / (count + 200.0)
    label = np.where(
        rng.random(n) < attack_score,
        _zipf_codes(rng, n, 22, a=1.4) + 1,
        0,
    ).astype(np.int32)
    is_attack = (label > 0).astype(np.float32)
    cols = {
        "count": count,
        "srv_count": srv_count,
        "duration": rng.exponential(200.0, size=n).astype(np.float32),
        "src_bytes": (
            rng.lognormal(5.0, 2.2, size=n) * (1.0 + 4.0 * is_attack)
        ).astype(np.float32),
        "dst_bytes": rng.lognormal(4.0, 2.5, size=n).astype(np.float32),
        "serror_rate": np.clip(
            rng.beta(0.3, 2.0, size=n) + 0.5 * is_attack, 0, 1
        ).astype(np.float32),
        "rerror_rate": rng.beta(0.2, 3.0, size=n).astype(np.float32),
        "same_srv_rate": rng.beta(3.0, 1.0, size=n).astype(np.float32),
        "diff_srv_rate": rng.beta(0.5, 4.0, size=n).astype(np.float32),
        "protocol_type": _zipf_codes(rng, n, 3, a=0.9),
        "service": _zipf_codes(rng, n, 66, a=1.1),
        "flag": np.where(rng.random(n) < 0.7 * is_attack, 1 + _zipf_codes(rng, n, 10, a=1.2), 0).astype(np.int32),
        "land": (rng.random(n) < 0.001).astype(np.int32),
        "logged_in": (rng.random(n) < 0.3).astype(np.int32),
        "label": label,
    }
    schema = (
        ColumnSpec("count", NUMERIC, positive=True),
        ColumnSpec("srv_count", NUMERIC, positive=True),
        ColumnSpec("duration", NUMERIC),
        ColumnSpec("src_bytes", NUMERIC, positive=True),
        ColumnSpec("dst_bytes", NUMERIC, positive=True),
        ColumnSpec("serror_rate", NUMERIC),
        ColumnSpec("rerror_rate", NUMERIC),
        ColumnSpec("same_srv_rate", NUMERIC),
        ColumnSpec("diff_srv_rate", NUMERIC),
        ColumnSpec("protocol_type", CATEGORICAL, 3, groupable=True),
        ColumnSpec("service", CATEGORICAL, 66, groupable=True),
        ColumnSpec("flag", CATEGORICAL, 11, groupable=True),
        ColumnSpec("land", CATEGORICAL, 2, groupable=True),
        ColumnSpec("logged_in", CATEGORICAL, 2, groupable=True),
        ColumnSpec("label", CATEGORICAL, 23, groupable=True),
    )
    table = from_flat(schema, cols, name="kdd_like")
    table = table.repartitioned(num_partitions)
    return _apply_layout(table, layout, "count", seed)


def make_tpcds_like(
    num_partitions: int = 256,
    rows_per_partition: int = 2048,
    seed: int = 3,
    layout: str = "sorted",
) -> Table:
    """catalog_sales-like: date-sorted, promotions + demographics dims."""
    rng = np.random.default_rng(seed)
    n = num_partitions * rows_per_partition
    day = np.sort(rng.integers(0, 1825, size=n))
    phase = day / 1825.0
    season = 1.0 + 0.7 * np.sin(2 * np.pi * day / 365.0 - 1.0)  # holiday peaks
    qty = (rng.integers(1, 100, size=n) * season).astype(np.float32) + 1.0
    list_price = (rng.gamma(3.0, 50.0, size=n) * season).astype(np.float32) + 1.0
    cols = {
        "d_day": day.astype(np.float32),
        "cs_quantity": qty,
        "cs_list_price": list_price,
        "cs_sales_price": (list_price * rng.uniform(0.3, 1.0, size=n)).astype(
            np.float32
        ),
        "cs_net_profit": (rng.normal(30.0, 120.0, size=n) * season).astype(
            np.float32
        ),
        "cs_ext_ship_cost": rng.gamma(2.0, 20.0, size=n).astype(np.float32),
        "p_promo_sk": _drifting_zipf(rng, phase, 35, a=0.9, drift=1.0),
        "i_category": _zipf_codes(rng, n, 10, a=0.4),
        "i_brand": _drifting_zipf(rng, phase, 60, a=0.8, drift=0.7),
        "cd_gender": rng.integers(0, 2, size=n).astype(np.int32),
        "cd_marital_status": rng.integers(0, 5, size=n).astype(np.int32),
        "cd_education_status": _zipf_codes(rng, n, 7, a=0.3),
        "d_year": (day // 365).astype(np.int32),
        "d_month": ((day % 365) // 31).astype(np.int32),
    }
    schema = (
        ColumnSpec("d_day", NUMERIC),
        ColumnSpec("cs_quantity", NUMERIC, positive=True),
        ColumnSpec("cs_list_price", NUMERIC, positive=True),
        ColumnSpec("cs_sales_price", NUMERIC, positive=True),
        ColumnSpec("cs_net_profit", NUMERIC),
        ColumnSpec("cs_ext_ship_cost", NUMERIC, positive=True),
        ColumnSpec("p_promo_sk", CATEGORICAL, 35, groupable=True),
        ColumnSpec("i_category", CATEGORICAL, 10, groupable=True),
        ColumnSpec("i_brand", CATEGORICAL, 60, groupable=True),
        ColumnSpec("cd_gender", CATEGORICAL, 2, groupable=True),
        ColumnSpec("cd_marital_status", CATEGORICAL, 5, groupable=True),
        ColumnSpec("cd_education_status", CATEGORICAL, 7, groupable=True),
        ColumnSpec("d_year", CATEGORICAL, 6, groupable=True),
        ColumnSpec("d_month", CATEGORICAL, 12, groupable=True),
    )
    table = from_flat(schema, cols, name="tpcds_like")
    table = table.repartitioned(num_partitions)
    return _apply_layout(table, layout, "d_day", seed)


def _apply_layout(table: Table, layout: str, sort_col: str, seed: int) -> Table:
    if layout == "sorted":
        return table.sorted_by(sort_col)
    if layout == "random":
        return table.shuffled(seed + 100)
    if layout.startswith("sorted:"):
        return table.sorted_by(layout.split(":", 1)[1])
    if layout == "ingest":
        return table  # leave in generation (ingest) order
    raise ValueError(f"unknown layout {layout!r}")


DATASETS = {
    "tpch": make_tpch_like,
    "tpcds": make_tpcds_like,
    "aria": make_aria_like,
    "kdd": make_kdd_like,
}


def make_dataset(name: str, **kw) -> Table:
    return DATASETS[name](**kw)
