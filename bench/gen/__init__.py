"""The benchmark's frozen input generators: networks and fleets
(`networks.py`, `graphs.py`) and fault traces (`faults.py`), numpy only."""
