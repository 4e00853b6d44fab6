"""Mine frequent token sets from an LM corpus — the paper's 'structured data
analysis' applied to the training pipeline (DESIGN.md §4 form 1), on the
card (PyTorch port of ``examples/mine_corpus.py``).

PYTHONPATH=src python examples/torch/mine_corpus.py [--device cuda|cpu] [--tokens N]
"""

import argparse

import numpy as np

from repro_torch.core.apriori import AprioriConfig, mine
from repro_torch.data.corpus import transactions_from_tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--tokens", type=int, default=200_000, help="corpus length")
    args = ap.parse_args(argv)

    # synthetic 'corpus' with planted structure: a code-like trigram pattern
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, size=args.tokens)
    tokens[::11] = 7     # 'def'
    tokens[1::11] = 13   # '('
    tokens[2::11] = 29   # ')'

    dense, vocab = transactions_from_tokens(tokens, window=64, num_items=256)
    print(f"{dense.shape[0]} windows x {dense.shape[1]} token-items")

    res = mine(dense, AprioriConfig(min_support=0.6, max_k=4), device=args.device)
    inv = {j: int(t) for j, t in enumerate(vocab)}
    print("frequent token sets (by original token id):")
    for k in sorted(res.levels):
        sets, sup = res.levels[k]
        for row, s in list(zip(sets, sup))[:8]:
            print(f"  k={k} tokens={[inv[int(i)] for i in row]} support={int(s)}")
    planted = {7, 13, 29}
    found = {
        frozenset(inv[int(i)] for i in row)
        for k in res.levels if k >= 3
        for row in res.levels[k][0]
    }
    assert any(planted <= f for f in found), "planted trigram set must be mined"
    print("planted {7,13,29} trigram recovered ✓")
    return res


if __name__ == "__main__":
    main()
