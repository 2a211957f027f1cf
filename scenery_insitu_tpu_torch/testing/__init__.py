"""Test harnesses of the port: real multi-process fleets
(``testing/multiproc.py``)."""
