"""The port's sketch ingest (CPU device) vs the JAX reference.

`repro_torch.core.sketches.build_sketches` on the device backend runs the
moments, histogram_range and bincount kernels (their plain versions on a
CPU device).  It is held to the reference with the rules of
``tests/test_ingest_parity.py::assert_sketches_match``: counts, heavy
hitters, AKMV and bitmaps bit-equal; measures at rtol 2e-4 (f32 moments).
Histogram edges are computed on the host in float64 on both sides and
must be bit-equal; histogram and discrete counts too.
"""
import numpy as np
import pytest

from repro.backends import ExecOptions as RefExecOptions
from repro.core.ingest import build_statistics as ref_build_statistics
from repro.core.sketches import build_sketches as ref_build_sketches
from repro.data.datasets import make_dataset as ref_make_dataset
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core.ingest import build_statistics
from repro_torch.core.sketches import build_sketches

from test_ingest_parity import assert_sketches_match
from test_query_device import edge_table
import torch_threads

torch_threads.cap_under_xdist()

CPU = ExecOptions(device="cpu")

TABLES = {
    "kdd": lambda: ref_make_dataset("kdd", num_partitions=8, rows_per_partition=512),
    "tpch": lambda: ref_make_dataset("tpch", num_partitions=6, rows_per_partition=300),
    "edge": lambda: edge_table(parts=3, rows=200, seed=6),
}


def _assert_exact_extras(ref, port):
    for name, cs in ref.columns.items():
        d = port.columns[name]
        assert d.discrete_span == cs.discrete_span
        if cs.hist_edges is not None:
            np.testing.assert_array_equal(d.hist_edges, cs.hist_edges)
        if cs.part_spans is not None:
            np.testing.assert_array_equal(d.part_spans, cs.part_spans)


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("reference", ["host", "xla-ref"])
def test_device_sketches_match_reference(name, reference):
    table = TABLES[name]()
    opts = (RefExecOptions(backend="host") if reference == "host"
            else RefExecOptions(backend="device", use_ref=True))
    ref = ref_build_sketches(table, options=opts)
    port = build_sketches(carry.table(table), options=CPU)
    assert_sketches_match(ref, port)
    _assert_exact_extras(ref, port)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_host_sketches_are_bit_identical(name):
    table = TABLES[name]()
    ref = ref_build_sketches(table, options=RefExecOptions(backend="host"))
    port = build_sketches(carry.table(table), options=CPU.replace(backend="host"))
    for col, cs in ref.columns.items():
        d = port.columns[col]
        for field in ("measures", "ndv", "dv_freq", "hh_stats", "cat_counts", "bitmap",
                      "global_hh", "hist_edges"):
            want = getattr(cs, field)
            if want is None:
                assert getattr(d, field) is None
            else:
                np.testing.assert_array_equal(getattr(d, field), want)
        assert d.hh_items == cs.hh_items


@pytest.mark.parametrize("use_ref", [True, False], ids=["xla-ref", "pallas"])
def test_statistics_tensors_match_reference(use_ref):
    table = ref_make_dataset("aria", num_partitions=4, rows_per_partition=256)
    want = ref_build_statistics(table, use_ref=use_ref, discrete_counts=True)
    got = build_statistics(carry.table(table), discrete_counts=True, options=CPU)
    assert got.keys() == want.keys()
    for col in want:
        assert got[col].keys() == want[col].keys()
        for key, w in want[col].items():
            if key == "measures":
                np.testing.assert_allclose(got[col][key], w, rtol=2e-4, atol=2e-4)
            else:  # counts, histogram counts, edges, discrete lo: exact
                np.testing.assert_array_equal(got[col][key], w)
