"""The benchmark of ``repro_torch`` on the card: ``python3 bench/run.py``."""
