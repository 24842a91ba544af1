"""Launchers of the port.  Port of ``src/repro/launch`` (``serve.py``,
``train.py``)."""
