"""The port's benchmark: run one cell with ``python3 benchmark/run.py`` (see ``run.py``)."""
