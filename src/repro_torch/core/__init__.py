"""HaS core: homology scores (homology.py) and the speculation state and
two-channel speculation of Algorithm 1 (has.py)."""
