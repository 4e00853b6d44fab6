"""The Apriori serving stack on the card: rulebook -> batch engine -> online gateway.

Public surface (DESIGN.md §8/§10/§12): compile/load a :class:`Rulebook`,
answer pre-assembled batches with :func:`recommend`, serve independent online
queries through a :class:`Gateway` (micro-batching, exact-basket cache,
live rulebook hot-swap, supervised dispatch worker — see
``distributed.supervisor``), or front N gateway replicas with a
:class:`Router` (consistent basket hashing, failover with bounded retries,
request deadlines, load shedding, coordinated two-phase hot-swap).
"""

from repro_torch.serving.batcher import (
    AdmissionRejected,
    DeadlineExceeded,
    MicroBatcher,
    Request,
    WorkerCrashed,
)
from repro_torch.serving.cache import BasketCache, basket_key
from repro_torch.serving.gateway import Gateway, Response, pow2_bucket
from repro_torch.serving.metrics import GatewayMetrics, LatencyHistogram, RouterMetrics
from repro_torch.serving.refresh import RefreshController, RefreshMetrics
from repro_torch.serving.router import HashRing, Router, RouterFaultInjection
from repro_torch.serving.recommend import (
    RecommendResult,
    make_match_step,
    pack_baskets,
    recommend,
    recommend_python,
)
from repro_torch.serving.rulebook import Rulebook, compile_rulebook, place_rulebook
