"""PS³-driven token-shard data plane for LM training.

The training corpus is stored in SHARDS (the LM analogue of the paper's
partitions): each shard holds token sequences plus ingest-time metadata
(domain tag, quality score, length).  Shard metadata forms a partitioned
`Table` (rows = sequences), the port's sketches, features and picker
select a weighted subset of shards for the target *mixture query*
(per-domain token counts above a quality threshold), and the selection
weights flow into the weighted training loss (``loss_weights``, the §2.4
estimator applied to the training objective).

The corpus and the batch stream are numpy, drawn exactly as the
reference (`repro.data.tokens`) draws them, so the two packages see the
same tokens, metadata and batches bit for bit.  The plane's sketches,
labels, GBDT fit and KMeans run on ``ExecOptions(backend, device)``: on
the card, the hand-written kernels.

Fault tolerance: `substitute(shard)` replaces a dead shard by its
nearest-in-feature-space live neighbour and the weight transfers (the
paper's redundancy insight, §4.2), keeping the mixture estimate
consistent without a reshuffle.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.picker import PickerConfig, train_picker
from repro_torch.core.sketches import build_sketches
from repro_torch.data.table import CATEGORICAL, NUMERIC, ColumnSpec, Table
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Aggregate, Clause, Predicate, Query


# --------------------------------------------------------------------------
# synthetic sharded corpus
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TokenStore:
    tokens: np.ndarray  # (n_shards, seqs_per_shard, seq_len) int32
    meta: Table  # per-shard metadata (partition = shard)
    n_domains: int

    @property
    def n_shards(self) -> int:
        return self.tokens.shape[0]


def make_token_store(
    n_shards: int = 64,
    seqs_per_shard: int = 64,
    seq_len: int = 128,
    vocab: int = 512,
    n_domains: int = 12,
    seed: int = 0,
) -> TokenStore:
    """Ingest-ordered corpus with domain drift (web crawls arrive in waves)."""
    rng = np.random.default_rng(seed)
    n = n_shards * seqs_per_shard
    phase = np.arange(n) / n
    # domain popularity rotates with ingest order (cf. datasets._drifting_zipf)
    ranks = np.arange(1, n_domains + 1, dtype=np.float64)
    probs = ranks ** -1.2
    probs /= probs.sum()
    base = rng.choice(n_domains, size=n, p=probs)
    domain = ((base + np.floor(phase * n_domains)) % n_domains).astype(np.int32)
    quality = np.clip(
        rng.beta(2, 2, size=n) + 0.2 * np.sin(2 * np.pi * phase), 0, 1
    ).astype(np.float32)
    length = rng.integers(seq_len // 2, seq_len + 1, size=n).astype(np.float32)
    # domain-dependent unigram token models
    dom_logits = rng.normal(size=(n_domains, vocab)) * 1.5
    toks = np.empty((n, seq_len), np.int32)
    for d in range(n_domains):
        idx = np.flatnonzero(domain == d)
        p = np.exp(dom_logits[d])
        p /= p.sum()
        toks[idx] = rng.choice(vocab, size=(idx.size, seq_len), p=p)
    meta = Table(
        (
            ColumnSpec("domain", CATEGORICAL, n_domains, groupable=True),
            ColumnSpec("quality", NUMERIC),
            ColumnSpec("length", NUMERIC, positive=True),
        ),
        {
            "domain": domain.reshape(n_shards, seqs_per_shard),
            "quality": quality.reshape(n_shards, seqs_per_shard),
            "length": length.reshape(n_shards, seqs_per_shard),
        },
        name="token_meta",
    )
    return TokenStore(toks.reshape(n_shards, seqs_per_shard, seq_len), meta, n_domains)


def mixture_query(quality_min: float = 0.3) -> Query:
    """The data-mixture accounting query: per-domain token mass above a
    quality floor — the thing PS³ approximates while reading few shards."""
    return Query(
        aggregates=(Aggregate("count"), Aggregate("sum", ((1.0, "length"),))),
        predicate=Predicate.conjunction([Clause("quality", ">", quality_min)]),
        groupby=("domain",),
    )


# --------------------------------------------------------------------------
# the data plane
# --------------------------------------------------------------------------
class PS3DataPlane:
    """Weighted shard selection + batch assembly + straggler substitution.

    ``backend`` None is the port's default (the device backend);
    ``device`` is the torch device of the device backend and of the
    picker's KMeans (``cuda`` by default; a ``cuda`` request without a
    GPU raises)."""

    def __init__(self, store: TokenStore, *, budget_frac: float = 0.25,
                 num_train_queries: int = 24, seed: int = 0,
                 backend: str | None = None, device: str = "cuda"):
        options = ExecOptions(device=device)
        if backend is not None:
            options = options.replace(backend=backend)
        options.torch_device()
        self.options = options
        self.store = store
        self.fb = FeatureBuilder(store.meta, build_sketches(store.meta, options=options))
        wl = WorkloadSpec(store.meta, seed=seed)
        cfg = PickerConfig(num_trees=16, tree_depth=3, feature_selection=False)
        self.art = train_picker(
            store.meta, wl, num_train_queries=num_train_queries, config=cfg,
            fb=self.fb, options=options,
        )
        self.picker = self.art.picker
        self.budget = max(1, int(budget_frac * store.n_shards))
        self.query = mixture_query()
        sel = self.picker.pick(self.query, self.budget)
        self.shard_ids = np.asarray(sel.ids, np.int64)
        self.weights = np.asarray(sel.weights, np.float64)
        self.dead: set[int] = set()

    # ---- fault tolerance ---------------------------------------------------
    def substitute(self, shard_id: int) -> int:
        """Replace a failed/straggling shard by its nearest live neighbour
        in feature space; its weight transfers (paper §4.2 redundancy)."""
        self.dead.add(int(shard_id))
        feats = self.fb.features(self.query)
        pos = int(np.flatnonzero(self.shard_ids == shard_id)[0])
        alive = np.asarray(
            [i for i in range(self.store.n_shards)
             if i not in self.dead and i not in set(self.shard_ids.tolist())]
        )
        if alive.size == 0:  # fall back to any live selected shard
            alive = np.asarray([i for i in self.shard_ids if i not in self.dead])
        d = np.sum((feats[alive] - feats[shard_id]) ** 2, axis=1)
        repl = int(alive[np.argmin(d)])
        self.shard_ids[pos] = repl
        return repl

    # ---- batches -------------------------------------------------------
    def batches(self, batch_size: int, num_batches: int, seed: int = 0,
                start: int = 0):
        """Yields numpy {tokens, targets, loss_weights} sampling shards ∝
        weight.

        Seeding is *per step*: batch i draws from ``rng((seed, start+i))``,
        so a run resumed at absolute step k (``start=k``) replays exactly
        the batch stream the uninterrupted run would have seen, while the
        seed-sequence pair keeps adjacent seeds' streams independent.
        """
        p = self.weights / self.weights.sum()
        spp = self.store.tokens.shape[1]
        for i in range(num_batches):
            rng = np.random.default_rng((seed, start + i))
            sh = rng.choice(len(self.shard_ids), size=batch_size, p=p)
            rows = rng.integers(0, spp, size=batch_size)
            toks = self.store.tokens[self.shard_ids[sh], rows]
            # importance weights: estimator weight / selection probability
            w = self.weights[sh] / (p[sh] * len(self.shard_ids))
            yield {
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
                "loss_weights": (w / w.mean()).astype(np.float32),
            }

    # ---- mixture accounting ---------------------------------------------
    def mixture_estimate(self):
        """Approximate per-domain mixture from selected shards only, and
        the exact one (both on the plane's options)."""
        from repro_torch.queries.engine import per_partition_answers

        a = per_partition_answers(self.store.meta, self.query, options=self.options)
        return a.estimate(self.shard_ids, self.weights), a.truth()
