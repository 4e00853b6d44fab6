"""Traffic drivers: ``setup``, ``window`` and ``check`` of one kind of load."""
