"""What the port's mining observer records beyond the JAX package's.

The port times the join and the prune inside ``candidate_gen``, counts the
rows each level's join gave before its prune, counts the rows each prune
checked by the path that checked them and, in a rule compile, the query rows
each support lookup resolved by its path; the in-memory mine also times the
DB's placement and a mesh's reduce of each pass, and counts the rows a rank
holds and the bytes it reduced.  The JAX package has none of these.
The parity tests hold the port's observer output, less exactly these
additions, equal to the JAX package's.
"""

from __future__ import annotations

PORT_ONLY_PHASES = frozenset({"candidate_join", "candidate_prune"})
PORT_ONLY_CALLS = frozenset({"on_candidates_joined", "on_prune_rows", "on_rule_lookup_rows"})
# recorded by the in-memory ``apriori.mine`` alone, never by a streamed
# miner: the DB's placement, the rows a rank counts and, on a mesh, each
# pass's all-reduce and its bytes
PORT_ONLY_MINE_PHASES = frozenset({"db_place", "count_reduce"})
PORT_ONLY_MINE_CALLS = frozenset({"on_split_rows", "on_reduce_bytes"})
PORT_ONLY_MINE_COUNTERS = frozenset({"mine_split_rows", "mine_reduce_bytes"})


def port_only_counters(counters: dict) -> set:
    """The port-only keys of a mining observer's counters: the two phases'
    seconds and ``mine_candidates_joined`` of every level from 2 to the last
    started, plus the level after it when that join ran, and
    ``mine_prune_rows{level,path}`` of joined levels from 3 up;
    ``mine_rule_lookup_rows{path}`` where a rule compile was observed; and
    of an in-memory mine, those of :data:`PORT_ONLY_MINE_PHASES` and
    :data:`PORT_ONLY_MINE_COUNTERS` it recorded."""
    started = max(int(k.split('"')[1]) for k in counters if k.startswith("mine_candidates{"))
    joined = {int(k.split('"')[1]) for k in counters if k.startswith("mine_candidates_joined{")}
    assert joined in (set(range(2, started + 1)), set(range(2, started + 2))), (joined, started)
    pruned = {k for k in counters if k.startswith("mine_prune_rows{")}
    assert {int(k.split('"')[1]) for k in pruned} <= joined - {2}, (pruned, joined)
    looked_up = {k for k in counters if k.startswith("mine_rule_lookup_rows{")}
    mine = {k for k in counters if k.split("{")[0] in PORT_ONLY_MINE_COUNTERS
            or k in {f'mine_phase_seconds{{phase="{p}"}}' for p in PORT_ONLY_MINE_PHASES}}
    return ({f'mine_phase_seconds{{phase="{p}"}}' for p in PORT_ONLY_PHASES}
            | {f'mine_candidates_joined{{level="{k}"}}' for k in joined} | pruned | looked_up | mine)
