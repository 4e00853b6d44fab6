"""Transaction data: the Quest generator, the LM-corpus adapter, the chunk
pipeline and the on-disk store (the JAX package's ``repro.data`` names)."""

from repro_torch.data.synthetic import gen_transactions, gen_transactions_chunked, QuestConfig
from repro_torch.data.corpus import transactions_from_tokens
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.store import (
    TransactionStore,
    StoreWriter,
    open_store,
    append_chunks,
    ingest_chunks,
    ingest_dense,
    ingest_lists,
    ingest_quest,
)
