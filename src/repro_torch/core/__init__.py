"""The paper's primary contribution in PyTorch: distributed level-wise
Apriori mining as Map/Combine/Reduce over a ``torch.distributed`` mesh
(``launch.mesh``), on one device when no mesh is given; host-side
encodings, candidate generation, SON, streamed and incremental mining, and
rules.  The same names as ``repro.core``.

``mapreduce`` here is the engine's function, as in the JAX package, and
hides the submodule of that name: import the module's other names with
``from repro_torch.core.mapreduce import ...``.
"""

from repro_torch.core.itemsets import (
    dense_from_lists,
    itemsets_to_dense,
    pack_bits,
    unpack_bits,
    singleton_itemsets,
)
from repro_torch.core.candidates import generate_candidates, rows_isin
from repro_torch.core.mapreduce import MapReduceJob, mapreduce, hierarchical_psum
from repro_torch.core.apriori import AprioriConfig, AprioriResult, mine, make_count_step
from repro_torch.core.son import mine_son
from repro_torch.core.streaming import (
    count_supports_streamed,
    count_union_streamed,
    mine_son_streamed,
    mine_streamed,
)
from repro_torch.core.incremental import (
    CountCache,
    DeltaReport,
    build_count_cache,
    load_count_cache,
    mine_delta,
)
from repro_torch.core.rules import extract_rules, Rule
