"""The dry run's steerings of `DTensor` (`repro_torch.launch.dryrun`'s
`_strategy_gaps`), op by op on fake process groups.

Each op runs over small `DTensor`s on a fake (4, 2) or (2, 2, 2) group
under `op_stats.OpStats`, in a subprocess of its own (a fake group never
meets another).  Held: ``flip`` keeps the placements of a dim it does not
flip and replicates the mesh dimension that shards one it flips (one
all-gather, counted); ``constant_pad_nd``, ``index`` (the embedding's
lookup, its ids sharded over ``pod`` and ``data`` at once) and
``index_put`` (its backward, whose values have more dims than the
table) run under the registered rules with the placements, local shapes
and counts that this torch's own strategies give them (torch 2.13 here:
on 2.11, which the card's machine runs, its own fail on these inputs);
a view that merges dims two mesh dimensions shard keeps both shards,
and one that splits such a dim gives each mesh dimension a factor,
rank 0 keeping its elements with no collective (heads over ``model``);
a product's operands are brought to placements that split it only
evenly (`dryrun._dot_placements`); a ``new_*`` factory takes the shards
of its like's dims; the optimizer slices by a leaf's local shard; a shard's
move to a partial sum runs as a gather and a partition; and every
strategy the steering registers is restored when the trace ends.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

_SCRIPT = textwrap.dedent("""
    import contextlib, json
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard, _redistribute,
                                          distribute_tensor)
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from repro_torch.launch import dryrun, op_stats
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.train import optimizer

    aten = torch.ops.aten

    def dt(t, mesh, placements):
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    def run(fn, gaps=True):
        stats = op_stats.OpStats()
        with dryrun._strategy_gaps() if gaps else contextlib.nullcontext(), stats:
            out = fn()
        s = stats.summary()
        return {"placements": [str(p) for p in out.placements],
                "local": list(out.to_local().shape), "by_kind": s["by_kind"],
                "collectives": s["num_collectives"], "hbm_bytes": s["hbm_bytes"]}

    def tables():
        prop = DTensor._op_dispatcher.sharding_propagator
        return [{str(op): id(fn) for op, fn in t.items()}
                for t in (prop.op_strategy_funcs, prop.op_to_schema_info,
                          prop.op_single_dim_strategy_funcs,
                          prop.op_to_schema_info_for_single_dim_strategy)]

    out = {}
    before = tables()
    with fake_group(8):
        m = make_mesh({"data": 4, "model": 2}, "cpu")
        x = dt(torch.randn(8, 6, 4), m, [Shard(0), Shard(1)])
        cases = {"flip_unsharded": lambda: torch.flip(x, [2]),
                 "flip_sharded": lambda: torch.flip(x, [1]),
                 "pad_unsharded": lambda: aten.constant_pad_nd(x, [0, 2]),
                 "pad_sharded": lambda: aten.constant_pad_nd(x, [0, 0, 0, 2])}
        for name, fn in cases.items():
            out[name] = run(fn)
            if name.startswith("pad"):
                out[name + "_own"] = run(fn, gaps=False)
        partial = DTensorSpec(m, (Shard(0), Partial()), tensor_meta=x._spec.tensor_meta)
        move = lambda: DTensor.from_local(_redistribute.redistribute_local_tensor(
            x.to_local(), x._spec, partial), m, partial.placements, run_check=False)
        out["shard_to_partial"] = run(move)
        try:
            run(move, gaps=False)
            out["shard_to_partial_own"] = "ran"
        except RuntimeError as e:
            out["shard_to_partial_own"] = str(e)
        R, P = [Replicate(), Replicate()], [Replicate(), Partial()]
        dots = {"dot_even": ((8, 6), R, (6, 4), R), "dot_uneven": ((5, 6), R, (6, 3), R),
                "bmm_whole": ((8, 4, 6), R, (8, 6, 4), R),
                "dot_partial_uneven": ((5, 6), P, (6, 4), R),
                "dot_partial_even": ((8, 6), P, (6, 4), R)}
        for name, (sa, pa, sb, pb) in dots.items():
            out[name] = [[str(p) for p in ps] for ps in dryrun._dot_placements(
                DTensor.from_local(torch.randn(sa), m, pa, run_check=False),
                DTensor.from_local(torch.randn(sb), m, pb, run_check=False))]
        weight = DTensor.from_local(torch.randn(6, 5), m, R, run_check=False)
        out["bmm_broadcast"] = [[str(p) for p in ps] for ps in dryrun._dot_placements(
            DTensor.from_local(torch.randn(2, 8, 6), m, R, run_check=False),
            weight.expand(2, 6, 5))]
        q = dt(torch.randn(8, 4, 6, 2), m, [Shard(0), Shard(1)])
        gaps = dryrun._LocalGaps()
        with gaps:
            acc = q.new_zeros((8, 4, 6), dtype=torch.float32)
            wider = q.new_zeros((8, 4, 6, 2, 3), dtype=torch.float32)
        out["new_factory"] = {"placements": [str(p) for p in acc.placements],
                              "local": list(acc.to_local().shape),
                              "wider": [str(p) for p in wider.placements],
                              "bytes": gaps.factory_bytes}
        out["held"] = optimizer._held(dt(torch.zeros(8, 6), m, [Shard(0), Shard(1)]))
    with fake_group(8):
        m = make_mesh({"pod": 2, "data": 2, "model": 2}, "cpu")
        table = dt(torch.randn(16, 4), m, [Replicate(), Shard(1), Shard(0)])
        ids = dt(torch.randint(0, 16, (8, 3)), m, [Shard(0), Shard(0), Replicate()])
        zeros = dt(torch.zeros(16, 4), m, [Replicate(), Shard(1), Shard(0)])
        grad = dt(torch.randn(8, 3, 4), m, [Shard(0), Shard(0), Replicate()])
        merged = dt(torch.randn(8, 64, 64), m, [Shard(0), Shard(2), Shard(0)])
        even = dt(torch.randn(16, 64, 64), m, [Shard(0), Shard(2), Shard(0)])
        cases = {"index": lambda: aten.index.Tensor(table, [ids]),
                 "index_put": lambda: aten.index_put.default(zeros, [ids], grad, True)}
        for name, fn in cases.items():
            out[name] = run(fn)
            out[name + "_own"] = run(fn, gaps=False)
        out["view_split"] = run(lambda: aten._unsafe_view.default(merged, [2, 4, 64, 64]))
        out["view_even"] = run(lambda: aten._unsafe_view.default(even, [4, 4, 64, 64]))
        one = dt(torch.randn(16, 64, 64), m, [Shard(0), Shard(2), Replicate()])
        out["view_one"] = run(lambda: aten._unsafe_view.default(one, [4, 4, 64, 64]))
        out["view_merge"] = run(lambda: aten._unsafe_view.default(
            dt(torch.randn(2, 4, 64, 64), m, [Shard(0), Shard(3), Shard(1)]), [8, 64, 64]))
    out["restored"] = tables() == before
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ops():
    env = {**os.environ, "PYTHONPATH": launch_cells.SRC}
    env.pop("PYTEST_XDIST_WORKER", None)
    p = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                       env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_flip_keeps_an_unflipped_dims_shards(ops):
    r = ops["flip_unsharded"]
    assert (r["placements"], r["local"], r["collectives"]) == (["S(0)", "S(1)"], [2, 3, 4], 0)


def test_flip_replicates_the_mesh_dim_that_shards_a_flipped_dim(ops):
    # (8, 6, 4) over (4, 2): the model axis gathers dim 1 (3 → 6 rows) of
    # rank 0's 2 × 3 × 4 f32 block, one all-gather of 2·6·4·4 bytes over 2
    r = ops["flip_sharded"]
    assert (r["placements"], r["local"], r["collectives"]) == (["S(0)", "R"], [2, 6, 4], 1)
    assert r["by_kind"] == {"all-gather": 2 * 6 * 4 * 4 * (2 - 1) / 2}


@pytest.mark.parametrize("case", ["pad_unsharded", "pad_sharded", "index", "index_put"])
def test_registered_rule_is_this_torchs_own(ops, case):
    assert ops[case] == ops[case + "_own"], (ops[case], ops[case + "_own"])


def test_pad_replicates_only_a_padded_sharded_dim(ops):
    assert (ops["pad_unsharded"]["placements"], ops["pad_unsharded"]["local"]) == (
        ["S(0)", "S(1)"], [2, 3, 6])
    assert (ops["pad_sharded"]["placements"], ops["pad_sharded"]["local"]) == (
        ["S(0)", "R"], [2, 8, 4])


def test_index_and_index_put_placements(ops):
    # the lookup of ids (8, 3), their batch over pod and data at once, in a
    # (16, 4) table (features over data, vocab over model): the cheapest
    # layout keeps the batch's pod shard, the table's feature shard and
    # splits the ids' 3 positions over model (rank 0: 4 × 2 × 2); the
    # backward's scatter into the table shards no dim it indexes (vocab)
    assert (ops["index"]["placements"], ops["index"]["local"]) == (
        ["S(0)", "S(2)", "S(1)"], [4, 2, 2])
    assert (ops["index_put"]["placements"], ops["index_put"]["local"]) == (
        ["R", "S(1)", "R"], [16, 2])


def test_view_split_keeps_rank0_elements(ops):
    # (8, 64, 64) with dim 0 over pod and model, rank 0 holding 2 × 64 × 32:
    # split to (2, 4, 64, 64) the model shard goes to the heads factor of 4
    # and the pod shard to the batch factor of 2, as the attention's fold
    # had them: rank 0 keeps its elements, no collective (`DTensor`'s rule
    # hands both shards to the batch factor, which cannot hold them)
    r = ops["view_split"]
    assert (r["placements"], r["local"]) == (["S(0)", "S(3)", "S(1)"], [1, 2, 64, 32])
    assert r["collectives"] == 0


def test_view_the_rule_holds_is_left_to_it(ops):
    # (16, 64, 64), dim 0 over pod alone, split to (4, 4, 64, 64): one mesh
    # dimension, so `DTensor`'s own rule (the batch factor takes it)
    r = ops["view_one"]
    assert (r["placements"], r["local"], r["collectives"]) == (
        ["S(0)", "S(3)", "R"], [2, 4, 64, 32], 0)


def test_view_split_of_an_even_batch_keeps_heads_over_model(ops):
    # (16, 64, 64) split to (4, 4, 64, 64): the batch factor could hold both
    # shards (`DTensor`'s own rule), but the model shard goes to the heads
    r = ops["view_even"]
    assert (r["placements"], r["local"], r["collectives"]) == (
        ["S(0)", "S(3)", "S(1)"], [2, 2, 64, 32], 0)


def test_view_merge_keeps_both_shards(ops):
    # (2, 4, 64, 64), batch over pod and heads over model, folded to
    # (8, 64, 64) for a batched product: the merged dim stays sharded over
    # pod and model, rank 0's (1, 2) block its 2 rows, no collective
    r = ops["view_merge"]
    assert (r["placements"], r["local"], r["collectives"]) == (
        ["S(0)", "S(2)", "S(0)"], [2, 64, 32], 0)


@pytest.mark.parametrize("case, want", [
    # (8, 6) @ (6, 4), both whole: the columns over model (4 / 2); data,
    # which is not the tensor axis, leaves it whole
    ("dot_even", [["R", "R"], ["R", "S(1)"]]),
    # (5, 6) @ (6, 3): model divides neither rows nor columns: whole
    ("dot_uneven", [["R", "R"], ["R", "R"]]),
    # a batched product of two activations held whole stays whole (its
    # batch folds heads)
    ("bmm_whole", [["R", "R"], ["R", "R"]]),
    # (2, 8, 6) times a (6, 5) weight broadcast over the batch: a 2-dim
    # product; model divides the rows, not the 5 columns
    ("bmm_broadcast", [["R", "S(1)"], ["R", "R"]]),
    # a partial sum over model beside a whole operand: all-reduced where
    # model does not divide its rows (5), reduce-scattered where it does
    ("dot_partial_uneven", [["R", "R"], ["R", "R"]]),
    ("dot_partial_even", [["R", "S(0)"], ["R", "R"]]),
])
def test_dot_placements_never_split_unevenly(ops, case, want):
    assert ops[case] == want


def test_new_factory_keeps_its_like_shards(ops):
    # the attention's accumulators from its (B, H, Tq, D) query block: (B,
    # H, Tq) keeps batch over data and heads over model; rank 0 holds
    # 2 × 2 × 6 of 8 × 4 × 6 f32, 672 bytes kept off; a shape with more
    # dims than the block's is left to `DTensor` (whole)
    r = ops["new_factory"]
    assert (r["placements"], r["local"], r["bytes"]) == (["S(0)", "S(1)"], [2, 2, 6], 672)
    assert r["wider"] == ["R", "R"]


def test_optimizer_chunks_by_the_local_shard(ops):
    # (8, 6) over data 4 and model 2: one device holds 2 × 3
    assert ops["held"] == 6


def test_shard_to_partial_moves_in_two_steps(ops):
    # rank 0's (2, 3, 4) block of the model shard is gathered (one
    # all-gather of 2·6·4·4 bytes over 2), then partitioned in place: the
    # move that neither release's redistribution runs in one step
    r = ops["shard_to_partial"]
    assert (r["placements"], r["local"], r["collectives"]) == (["S(0)", "P(sum)"], [2, 6, 4], 1)
    assert r["by_kind"] == {"all-gather": 2 * 6 * 4 * 4 * (2 - 1) / 2}
    assert "not supported" in ops["shard_to_partial_own"]


def test_every_registered_strategy_is_restored(ops):
    assert ops["restored"]
