"""Host-side encodings, candidate generation, the level-wise miner and rules."""
