"""One driver a kind of traffic (``traffic/<name>.json``'s ``driver``):
``run(cell, seed, seconds, trace, device, t0)`` returns the run's
result (see ``perfbench/run.py``)."""
