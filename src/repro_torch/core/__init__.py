"""HaS core: homology scores (homology.py), the speculation state and
two-channel speculation of Algorithm 1 (has.py), its hash-map oracle
(reference.py) and the baselines the paper compares against
(baselines.py)."""
