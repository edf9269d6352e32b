"""Multi-sequence tracking (port of `hfvo_tpu.parallel`): `multiseq`'s
BatchTracker. The distributed solvers come with the batch + distributed
item."""
