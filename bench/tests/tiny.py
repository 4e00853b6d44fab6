"""Tiny overrides for the dry path: every cell at a size the CPU runs in
a second, through the program's plain kernels."""

DATA = {"num_transactions": 1000, "num_items": 40, "num_patterns": 30}

OVERRIDES = {
    "config": {"data": DATA, "mining": {"min_support": 0.05}, "setup_mine": {"shard_rows": 400, "chunk_rows": 256}},
    "traffic": {"rate_per_s": 200, "baskets_per_s": 400, "max_per_s": 4000, "shard_rows": 400, "chunk_rows": 256,
                "drain_s": 5.0, "trace_seconds": 0.3, "check_sample": 100000, "check_longest": 8,
                "warm_requests": 16},
}

# the long-basket configuration needs a higher threshold at 48 items
T40 = {"config": {"data": {"num_items": 160}, "mining": {"min_support": 0.55}}}
