"""One driver per kind of traffic mix: ``benchmark/drivers/<kind>.py``, found
by the mix file's ``kind`` (``run.driver_class``), holds the kind's feed
generator and its ``Driver``."""
