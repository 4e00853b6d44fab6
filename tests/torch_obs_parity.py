"""What the port's mining observer records beyond the JAX package's.

The port times the join and the prune inside ``candidate_gen``, and counts
the rows each level's join gave before its prune; the JAX package has
neither.  The parity tests hold the port's observer output, less exactly
these additions, equal to the JAX package's.
"""

from __future__ import annotations

PORT_ONLY_PHASES = frozenset({"candidate_join", "candidate_prune"})
PORT_ONLY_CALLS = frozenset({"on_candidates_joined"})


def port_only_counters(counters: dict) -> set:
    """The port-only keys of a mining observer's counters: the two phases'
    seconds and ``mine_candidates_joined`` of every level from 2 to the last
    started, plus the level after it when that join ran."""
    started = max(int(k.split('"')[1]) for k in counters if k.startswith("mine_candidates{"))
    joined = {int(k.split('"')[1]) for k in counters if k.startswith("mine_candidates_joined{")}
    assert joined in (set(range(2, started + 1)), set(range(2, started + 2))), (joined, started)
    return ({f'mine_phase_seconds{{phase="{p}"}}' for p in PORT_ONLY_PHASES}
            | {f'mine_candidates_joined{{level="{k}"}}' for k in joined})
